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
// (27, 3, 64, E), element values (3, 27, E), w det J (64, E).  The TPU
// kernels' (dim, nd, n_el, n_q) layout, the pre-broadcast of u over the
// quadrature axis, the Newton-refined hardware reciprocal and the lane
// reduction outside the kernel answer Mosaic constraints and are not
// carried over: a thread loops over its element's 64 points and sums them
// in registers.
//
// Design: as sweeps_dense.cu (one thread per element, 64 per block, the
// element's dof values staged in the thread's own shared column, the 81
// sums in registers, dN read a second time from L1 for the scatter).  The
// residual forms F and P with the functions mimi_residual_dense uses
// (grad_q, the NeoHookean device functions of materials.cuh), so the two
// see the same stress to the bit.
//
// What bounds them on the H100: bytes.  Both stream dN (2.28 GB at
// E = 109,744) and w det J once; the tangent apply reads two element
// fields and no tangent block, 2.38 GB against the 4.40 GB of the stored
// symmetric matvec, and recomputes F^-1 and the three 3 x 3 products per
// point (~150 flops) instead.

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "materials.cuh"

namespace {

using Shape = DenseShape<3, 2>;  // p = 2: 27 dofs, 64 points
constexpr int ND = Shape::ND, NQ = Shape::NQ, NW = Shape::NW;
using NeoHookean3 = NeoHookean<3>;

__device__ __forceinline__ void deformation_gradient(const float* __restrict__ dN,
                                                     float (*su)[BLOCK], long long qe,
                                                     long long QE, float F[3][3]) {
  grad_q<3, ND>(dN, su, qe, QE, F);
  F[0][0] = add(F[0][0], 1.f);
  F[1][1] = add(F[1][1], 1.f);
  F[2][2] = add(F[2][2], 1.f);
}

__device__ __forceinline__ void zero(float (&acc)[3][ND]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
}

__device__ __forceinline__ void write_out(float* __restrict__ out, const float (&acc)[3][ND],
                                          long long e, long long E) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

__global__ void __launch_bounds__(BLOCK)
    nh_residual_kernel(const float* __restrict__ u_el, const float* __restrict__ dN,
                       const float* __restrict__ wq, float* __restrict__ out,
                       NeoHookean3 mat, long long E) {
  __shared__ float su[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;  // threads share nothing: no barrier below
  stage<NW>(u_el, su, e, E);
  float acc[3][ND];
  zero(acc);
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float F[3][3], P[3][3];
    deformation_gradient(dN, su, qe, QE, F);
    mat.pk1(F, P);
    scatter_q<3, ND, false>(acc, dN, nullptr, qe, QE, __ldg(wq + qe), P, nullptr);
  }
  write_out(out, acc, e, E);
}

__global__ void __launch_bounds__(BLOCK)
    nh_tangent_apply_kernel(const float* __restrict__ u_el, const float* __restrict__ w_el,
                            const float* __restrict__ dN, const float* __restrict__ wq,
                            float* __restrict__ out, NeoHookean3 mat, long long E) {
  __shared__ float su[NW][BLOCK];
  __shared__ float sw[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  stage<NW>(u_el, su, e, E);
  stage<NW>(w_el, sw, e, E);
  float acc[3][ND];
  zero(acc);
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float F[3][3], dF[3][3], fi[3][3];
    deformation_gradient(dN, su, qe, QE, F);
    grad_q<3, ND>(dN, sw, qe, QE, dF);
    const float J = rn::det3(F);
    rn::inv3(F, fi);  // G = F^-T: G[c][d] = fi[d][c]
    float t = 0.f;    // tr(F^-1 dF) = sum_cd G_cd dF_cd
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) t += fi[d][c] * dF[c][d];
    // A = dF^T G: A[a][d] = sum_b dF[b][a] G[b][d];  M = G A
    float A[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        A[a][d] = dF[0][a] * fi[d][0] + dF[1][a] * fi[d][1] + dF[2][a] * fi[d][2];
    const float coef_t = mat.lam * (2.f * J - 1.f) * J * t;
    const float coef_m = mat.lam * J * (J - 1.f) - mat.mu;
    float dP[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float M = fi[0][c] * A[0][d] + fi[1][c] * A[1][d] + fi[2][c] * A[2][d];
        dP[c][d] = mat.mu * dF[c][d] + coef_t * fi[d][c] - coef_m * M;
      }
    scatter_q<3, ND, false>(acc, dN, nullptr, qe, QE, __ldg(wq + qe), dP, nullptr);
  }
  write_out(out, acc, e, E);
}

}  // namespace

// C entry points.  Each returns the launch's cudaGetLastError().
extern "C" {

int mimi_neohookean_residual(const float* u_el, const float* dN, const float* wq, float* out,
                             float lam, float mu, long long E, void* stream) {
  if (E <= 0) return 0;
  nh_residual_kernel<<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      u_el, dN, wq, out, NeoHookean3{mu, lam}, E);
  return (int)cudaGetLastError();
}

int mimi_neohookean_tangent_apply(const float* u_el, const float* w_el, const float* dN,
                                  const float* wq, float* out, float lam, float mu,
                                  long long E, void* stream) {
  if (E <= 0) return 0;
  nh_tangent_apply_kernel<<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      u_el, w_el, dN, wq, out, NeoHookean3{mu, lam}, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
