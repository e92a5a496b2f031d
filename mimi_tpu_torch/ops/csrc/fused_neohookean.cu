// Fused neo-Hookean element residual and matrix-free tangent apply on dense
// tables, for sm_90a.
//
// Two kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/pallas_residual.py:
//   mimi_neohookean_residual       <- neohookean_residual_pallas
//       r_el = sum_q w det J dN P(F(u)),  P = mu (F - F^-T) + lambda J (J - 1) F^-T
//   mimi_neohookean_tangent_apply  <- neohookean_tangent_apply_pallas
//       y_el = sum_q w det J dN (dP/dF(u) : dF(w)), no stored tangent:
//       dP = mu dF + lambda (2J - 1) J tr(F^-1 dF) F^-T
//            - (lambda J (J - 1) - mu) F^-T dF^T F^-T
// The plain torch versions are in ops/fused_neohookean.py.
//
// They take the batch-last dense layout of the other sweeps: dN
// (ND, DIM, NQ, E), element values (DIM, ND, E), w det J (NQ, E), at the
// shape of the build (dense_common.cuh Dense: any dimension, degree and
// point count, as the reference's (dim, nd, n_el, n_q) kernels take any).
// The TPU kernels' (dim, nd, n_el, n_q) layout, the pre-broadcast of u over
// the quadrature axis, the Newton-refined hardware reciprocal and the lane
// reduction outside the kernel answer Mosaic constraints and are not
// carried over.
//
// Design: as sweeps_dense.cu.  Up to 27 dofs in 3D and 16 in 2D one thread
// per element, 64 per block, the element's dof values staged in the
// thread's own shared column, the DIM ND sums in registers, dN read a
// second time from L1 for the scatter; past that (DenseShape::TILED) the
// points below on dense_tile_kernel, one thread per (element, point slot),
// the sums of at most 16 nodes a thread.  The residual
// forms F and P with the functions mimi_residual_dense uses (grad_q_of, the
// NeoHookean device functions of materials.cuh), so the two see the same
// stress to the bit.
//
// What bounds them on the H100: bytes.  Both stream dN (2.28 GB at
// E = 109,744, 3D p = 2) and w det J once; the tangent apply reads two
// element fields and no tangent block, 2.38 GB against the 4.40 GB of the
// stored symmetric matvec, and recomputes F^-1 and the three products per
// point (~150 flops in 3D) instead.

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "materials.cuh"

namespace {

using NH = NeoHookean<Dense::DIM>;

template <int DIM>
__device__ __forceinline__ void deformation_gradient(const float F_grad[DIM][DIM],
                                                     float F[DIM][DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int d = 0; d < DIM; ++d) F[c][d] = c == d ? add(F_grad[c][d], 1.f) : F_grad[c][d];
}

// dP = mu dF + k1 tr(F^-1 dF) F^-T - k2 F^-T dF^T F^-T at F
template <int DIM>
__device__ __forceinline__ void tangent_apply(const NeoHookean<DIM>& mat, const float F[DIM][DIM],
                                              const float dF[DIM][DIM], float dP[DIM][DIM]) {
  const float J = rn::det(F);
  float fi[DIM][DIM];
  rn::inv(F, fi);  // G = F^-T: G[c][d] = fi[d][c]
  float t = 0.f;   // tr(F^-1 dF) = sum_cd G_cd dF_cd
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int d = 0; d < DIM; ++d) t += fi[d][c] * dF[c][d];
  // A = dF^T G: A[a][d] = sum_b dF[b][a] G[b][d];  M = G A
  float A[DIM][DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float s = dF[0][a] * fi[d][0];
#pragma unroll
      for (int b = 1; b < DIM; ++b) s += dF[b][a] * fi[d][b];
      A[a][d] = s;
    }
  const float coef_t = mat.lam * (2.f * J - 1.f) * J * t;
  const float coef_m = mat.lam * J * (J - 1.f) - mat.mu;
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float M = fi[0][c] * A[0][d];
#pragma unroll
      for (int b = 1; b < DIM; ++b) M += fi[b][c] * A[b][d];
      dP[c][d] = mat.mu * dF[c][d] + coef_t * fi[d][c] - coef_m * M;
    }
}

// ---- one thread per element ------------------------------------------------------

template <class S>
__device__ __forceinline__ void zero(float (&acc)[S::DIM][S::ND]) {
#pragma unroll
  for (int c = 0; c < S::DIM; ++c)
#pragma unroll
    for (int n = 0; n < S::ND; ++n) acc[c][n] = 0.f;
}

template <class S>
__device__ __forceinline__ void write_out(float* __restrict__ out,
                                          const float (&acc)[S::DIM][S::ND], long long e,
                                          long long E) {
#pragma unroll
  for (int c = 0; c < S::DIM; ++c)
#pragma unroll
    for (int n = 0; n < S::ND; ++n) out[(long long)(c * S::ND + n) * E + e] = acc[c][n];
}

template <class S>
__global__ void __launch_bounds__(BLOCK)
    nh_residual_kernel(const float* __restrict__ u_el, const float* __restrict__ dN,
                       const float* __restrict__ wq, float* __restrict__ out,
                       NeoHookean<S::DIM> mat, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND;
  MIMI_DYNAMIC_SHARED(float, smem);  // su[NW][BLOCK]
  float(*su)[BLOCK] = reinterpret_cast<float(*)[BLOCK]>(smem);
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;  // threads share nothing: no barrier below
  stage<S::NW>(u_el, su, e, E);
  float acc[DIM][ND];
  zero<S>(acc);
  const long long QE = (long long)S::NQ * E;
#pragma unroll 1
  for (int q = 0; q < S::NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float G[DIM][DIM], F[DIM][DIM], P[DIM][DIM];
    grad_q<DIM, ND>(dN, su, qe, QE, G);
    deformation_gradient<DIM>(G, F);
    mat.pk1(F, P);
    scatter_q<DIM, ND, false>(acc, dN, nullptr, qe, QE, __ldg(wq + qe), P, nullptr);
  }
  write_out<S>(out, acc, e, E);
}

template <class S>
__global__ void __launch_bounds__(BLOCK)
    nh_tangent_apply_kernel(const float* __restrict__ u_el, const float* __restrict__ w_el,
                            const float* __restrict__ dN, const float* __restrict__ wq,
                            float* __restrict__ out, NeoHookean<S::DIM> mat, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND;
  MIMI_DYNAMIC_SHARED(float, smem);  // su[NW][BLOCK], sw[NW][BLOCK]
  float(*su)[BLOCK] = reinterpret_cast<float(*)[BLOCK]>(smem);
  float(*sw)[BLOCK] = su + S::NW;
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  stage<S::NW>(u_el, su, e, E);
  stage<S::NW>(w_el, sw, e, E);
  float acc[DIM][ND];
  zero<S>(acc);
  const long long QE = (long long)S::NQ * E;
#pragma unroll 1
  for (int q = 0; q < S::NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float G[DIM][DIM], F[DIM][DIM], dF[DIM][DIM], dP[DIM][DIM];
    grad_q<DIM, ND>(dN, su, qe, QE, G);
    deformation_gradient<DIM>(G, F);
    grad_q<DIM, ND>(dN, sw, qe, QE, dF);
    tangent_apply<DIM>(mat, F, dF, dP);
    scatter_q<DIM, ND, false>(acc, dN, nullptr, qe, QE, __ldg(wq + qe), dP, nullptr);
  }
  write_out<S>(out, acc, e, E);
}

// ---- the points of dense_tile_kernel (S::TILED) ----------------------------------

// the residual's point: F from u (s0), P
template <class S>
struct NhResidualPoint {
  static constexpr int DIM = S::DIM;
  NeoHookean<DIM> mat;
  const float* dN;
  template <class F1>
  __device__ __forceinline__ void operator()(const float (*s0)[DTILE], const F1&, int lane,
                                             long long qe, long long QE,
                                             float X[DIM][DIM]) const {
    float G[DIM][DIM], F[DIM][DIM];
    grad_q_of<DIM, S::ND>(dN, [=](int k) { return s0[k][lane]; }, qe, QE, G);
    deformation_gradient<DIM>(G, F);
    mat.pk1(F, X);
  }
};

// the tangent apply's point: F from u (s0), dF from w (f1), dP
template <class S>
struct NhTangentPoint {
  static constexpr int DIM = S::DIM;
  NeoHookean<DIM> mat;
  const float* dN;
  template <class F1>
  __device__ __forceinline__ void operator()(const float (*s0)[DTILE], const F1& f1, int lane,
                                             long long qe, long long QE,
                                             float X[DIM][DIM]) const {
    float G[DIM][DIM], F[DIM][DIM], dF[DIM][DIM];
    grad_q_of<DIM, S::ND>(dN, [=](int k) { return s0[k][lane]; }, qe, QE, G);
    deformation_gradient<DIM>(G, F);
    grad_q_of<DIM, S::ND>(dN, f1, qe, QE, dF);
    tangent_apply<DIM>(mat, F, dF, X);
  }
};

template <class S>
int launch_residual(const float* u_el, const float* dN, const float* wq, float* out,
                    const NeoHookean<S::DIM>& mat, long long E, void* stream) {
  if constexpr (S::TILED) {
    const NhResidualPoint<S> point{mat, dN};
    return launch_dense_tile<S, 1>(point, u_el, nullptr, dN, wq, out, E, stream);
  } else {
    constexpr size_t smem = sizeof(float) * S::NW * BLOCK;
    if (const int err = allow_dynamic_smem<nh_residual_kernel<S>>(smem)) return err;
    nh_residual_kernel<S><<<grid_for(E), BLOCK, smem, (cudaStream_t)stream>>>(u_el, dN, wq, out,
                                                                              mat, E);
    return (int)cudaGetLastError();
  }
}

template <class S>
int launch_tangent_apply(const float* u_el, const float* w_el, const float* dN,
                         const float* wq, float* out, const NeoHookean<S::DIM>& mat,
                         long long E, void* stream) {
  if constexpr (S::TILED) {
    const NhTangentPoint<S> point{mat, dN};
    return launch_dense_tile<S, 2>(point, u_el, w_el, dN, wq, out, E, stream);
  } else {
    constexpr size_t smem = 2 * sizeof(float) * S::NW * BLOCK;
    if (const int err = allow_dynamic_smem<nh_tangent_apply_kernel<S>>(smem)) return err;
    nh_tangent_apply_kernel<S><<<grid_for(E), BLOCK, smem, (cudaStream_t)stream>>>(
        u_el, w_el, dN, wq, out, mat, E);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// C entry points at the shape of the build ((dim, nd, nq): dimension, dofs
// and points per element).  Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for another shape.
extern "C" {

int mimi_neohookean_residual(const float* u_el, const float* dN, const float* wq, float* out,
                             float lam, float mu, int dim, int nd, int nq, long long E,
                             void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    return launch_residual<S>(u_el, dN, wq, out, NH{mu, lam}, E, stream);
  });
}

int mimi_neohookean_tangent_apply(const float* u_el, const float* w_el, const float* dN,
                                  const float* wq, float* out, float lam, float mu, int dim,
                                  int nd, int nq, long long E, void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    return launch_tangent_apply<S>(u_el, w_el, dN, wq, out, NH{mu, lam}, E, stream);
  });
}

}  // extern "C"
