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
// Design.  The tangent apply, in 3D at every shape, on MatvecTile's owner
// warps and a flux warp (nh_tangent_apply_tile_kernel below, the tiled
// matvec's design): an owner holds its nodes' dN rows at a point in
// registers from its share of grad u and grad w to the scatter, so dN
// crosses device memory once a point; the flux warp forms F, dF and dP.
// The residual, and the tangent apply in 2D, up to 27 dofs in 3D and 16 in
// 2D one thread per element, 64 per block, the element's dof values staged
// in the thread's own shared column, the DIM ND sums in registers, dN read
// again from L1 for the scatter; past that (DenseShape::TILED) on
// dense_tile_kernel, one thread per (element, point slot), the sums of at
// most 16 nodes a thread.  The residual forms F and P with the functions
// mimi_residual_dense uses (grad_q_of, the NeoHookean device functions of
// materials.cuh), so the two see the same stress to the bit.
//
// What bounds them on the H100: bytes.  Both stream dN (2.28 GB at
// E = 109,744, 3D p = 2) and w det J once; the tangent apply reads two
// element fields and no tangent block, 2.38 GB against the 4.40 GB of the
// stored symmetric matvec, and recomputes F^-1 and the three products per
// point (~150 flops in 3D) instead.  The one thread per element that the
// owners replaced in 3D read each point's dN rows three times (grad u,
// grad w, the scatter), the later two hoped from L1: 1.86 ms against the
// 0.72 ms bound at 2 x 38^3, 1.29 ms on the owners (PERF.md).

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

// ---- the tangent apply on owners and a flux warp (3D) --------------------------------
//
// In 3D at every shape (MatvecTile's owners of 8 nodes, the tiled matvec's
// design, dense_common.cuh dense_matvec_tile_kernel): a block takes DTILE
// = 32 consecutive elements, one per lane, in MatvecTile::SLOTS owner
// warps and one flux warp (at (3, 27, 64) 4 owners of 7 nodes: 160
// threads).  For each point q in turn an owner (slot s, lane) loads
// dN[n][:][q] of its nodes n = s + SLOTS j into registers (one 128-byte
// line a warp each) and hands its nodes' share of grad u and grad w
// (2 DIM^2 partial sums, fused multiply-adds) to shared memory.  After a
// barrier the flux warp sums the SLOTS partials in slot order, forms
// F = I + grad u and dF = grad w, runs tangent_apply and hands dP and
// w det J to shared memory; after a second barrier each owner adds
// wq dN[n] . dP[c] to its nodes' sums from the same registers, points in q
// order: dN crosses device memory once a point, no atomics,
// deterministic.  grad u is regrouped by slot: the tangent apply's dP is
// smooth in F (no F - F^-T cancels in it), so that moves the output by
// float32 rounding (PERF.md: within 1e-6 of the plain version's max
// against the 1e-4 bar).  u and w are staged in shared memory as
// [DIM ND][DTILE] while they fit in a block's 227 KB (ApplyTile::STAGED:
// w read from device memory at 3D p = 6).  In 2D, where a point's loads are
// few and the flux warp's barrier pair costs more than the second and third
// read of dN from L1 saves, the owners ran 0.75x the one thread per element
// at (2, 16, 25) and 0.89x the point slots at (2, 25, 36) (PERF.md): 2D
// keeps those.  The owners' loop needs no third barrier: the next point
// writes the partials after their reader passed the first barrier, and the
// flux warp writes dP after the next point's first barrier, which every
// owner reaches after its scatter.
template <class S>
struct ApplyTile {
  using MT = MatvecTile<S>;
  static constexpr int D2 = S::DIM * S::DIM;
  static constexpr int G = 2 * D2;  // a slot's partials: grad u, grad w
  // the partials and the point's dP and w det J
  static constexpr size_t REST = (size_t)DTILE * (MT::SLOTS * G + D2 + 1);
  static constexpr int stage_count() {
    int n = 2;
    while (n > 0 && sizeof(float) * (REST + (size_t)DTILE * n * S::NW) > BLOCK_SMEM_MAX) --n;
    return n;
  }
  static constexpr int STAGED = stage_count();
  static constexpr size_t BYTES = sizeof(float) * (REST + (size_t)DTILE * STAGED * S::NW);
  static_assert(BYTES <= BLOCK_SMEM_MAX, "the partials exceed a block");
};

template <class S>
__global__ void __launch_bounds__(MatvecTile<S>::THREADS, MatvecTile<S>::MIN_BLOCKS)
    nh_tangent_apply_tile_kernel(const float* __restrict__ u_el, const float* __restrict__ w_el,
                            const float* __restrict__ dN, const float* __restrict__ wq,
                            float* __restrict__ out, NeoHookean<S::DIM> mat, long long E) {
  using AT = ApplyTile<S>;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, D2 = AT::D2, G = AT::G;
  constexpr int SLOTS = MatvecTile<S>::SLOTS, OWN = MatvecTile<S>::OWN, NF = AT::STAGED;
  MIMI_DYNAMIC_SHARED(float, smem);  // staged[NF][NW][DTILE], part[SLOTS][G][DTILE], st[D2 + 1][DTILE]
  float(*staged)[NW][DTILE] = reinterpret_cast<float(*)[NW][DTILE]>(smem);
  float(*part)[G][DTILE] = reinterpret_cast<float(*)[G][DTILE]>(smem + NF * NW * DTILE);
  float(*st)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem + (NF * NW + SLOTS * G) * DTILE);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  const float* const fields[2] = {u_el, w_el};
  for (int r = slot; r < NW; r += SLOTS + 1)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      staged[f][r][lane] = live ? __ldg(fields[f] + (long long)r * E + e) : 0.f;
  __syncthreads();
  const long long QE = (long long)NQ * E;
  if (slot == SLOTS) {  // the flux warp: two barriers a point, as the owners
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      __syncthreads();  // the owners wrote the point's partials
      if (live) {
        const long long qe = (long long)q * E + e;
        float F[DIM][DIM], dF[DIM][DIM], X[DIM][DIM];
#pragma unroll
        for (int k = 0; k < D2; ++k) {
          float su = part[0][k][lane], sw = part[0][D2 + k][lane];
#pragma unroll
          for (int p = 1; p < SLOTS; ++p) {
            su += part[p][k][lane];
            sw += part[p][D2 + k][lane];
          }
          F[k / DIM][k % DIM] = k / DIM == k % DIM ? add(su, 1.f) : su;
          dF[k / DIM][k % DIM] = sw;
        }
        tangent_apply<DIM>(mat, F, dF, X);
#pragma unroll
        for (int k = 0; k < D2; ++k) st[k][lane] = X[k / DIM][k % DIM];
        st[D2][lane] = __ldg(wq + qe);
      }
      __syncthreads();
    }
    return;
  }
  // value k of field f of the lane's element, staged or from device memory
  const auto field = [=](int f, int k) {
    return f < NF ? staged[f][k][lane] : live ? __ldg(fields[f] + (long long)k * E + e) : 0.f;
  };
  float acc[OWN][DIM];
#pragma unroll
  for (int j = 0; j < OWN; ++j)
#pragma unroll
    for (int c = 0; c < DIM; ++c) acc[j][c] = 0.f;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    // this thread's nodes' dN rows at q, loaded once (the row addresses
    // formed here, from an opaque QE, as the tiled matvec's)
    const long long qe = (long long)q * E + e, QEq = opaque(QE);
    float d[OWN][DIM];
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      const bool own = live && n < ND;
#pragma unroll
      for (int f = 0; f < DIM; ++f)
        d[j][f] = own ? __ldg(dN + (long long)(n * DIM + f) * QEq + qe) : 0.f;
    }
    // this thread's share of grad u and grad w, one row g at a time
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      float gu[DIM] = {}, gw[DIM] = {};
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        const int n = slot + SLOTS * j;
        if (n < ND) {
          const float uv = field(0, g * ND + n), wv = field(1, g * ND + n);
#pragma unroll
          for (int f = 0; f < DIM; ++f) {
            gu[f] = fmaf(d[j][f], uv, gu[f]);
            gw[f] = fmaf(d[j][f], wv, gw[f]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < DIM; ++f) {
        part[slot][g * DIM + f][lane] = gu[f];
        part[slot][D2 + g * DIM + f][lane] = gw[f];
      }
    }
    __syncthreads();  // the flux warp reads the partials
    __syncthreads();  // and has written the point's dP
    if (live) {  // the scatter for this thread's nodes, from the same registers
      const float wqv = st[D2][lane];
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        if (slot + SLOTS * j < ND) {
#pragma unroll
          for (int c = 0; c < DIM; ++c) {
            float x = d[j][0] * st[c * DIM][lane];
#pragma unroll
            for (int f = 1; f < DIM; ++f) x = fmaf(d[j][f], st[c * DIM + f][lane], x);
            acc[j][c] = fmaf(wqv, x, acc[j][c]);
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c) out[(long long)(c * ND + n) * E + e] = acc[j][c];
    }
  }
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

// the tangent apply: in 3D on the owners and the flux warp; in 2D on the
// one thread per element up to 16 dofs and on dense_tile_kernel past that,
// where the owners ran 0.75-1.02x (PERF.md)
template <class S>
int launch_tangent_apply(const float* u_el, const float* w_el, const float* dN,
                         const float* wq, float* out, const NeoHookean<S::DIM>& mat,
                         long long E, void* stream) {
  if constexpr (S::DIM == 3) {
    constexpr size_t smem = ApplyTile<S>::BYTES;
    if (const int err = allow_dynamic_smem<nh_tangent_apply_tile_kernel<S>>(smem)) return err;
    const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
    nh_tangent_apply_tile_kernel<S>
        <<<tiles, MatvecTile<S>::THREADS, smem, (cudaStream_t)stream>>>(u_el, w_el, dN, wq, out,
                                                                        mat, E);
    return (int)cudaGetLastError();
  } else if constexpr (S::TILED) {
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
