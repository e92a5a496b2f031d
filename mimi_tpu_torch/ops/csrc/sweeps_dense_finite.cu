// Dense-table quadrature sweeps of the finite-strain plasticity models
// J2Simo and J2Log with the full tangent storage, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch with c_storage="full":
//   mimi_residual_dense_finite <- make_residual_sweep (dense, J2Simo / J2Log state)  residual only
//   mimi_assemble_dense_finite <- make_assemble_sweep (dense, "full")               residual + DIM^4 planes
//   mimi_matvec_dense_full     <- make_matvec_sweep ("full")                       y = J w
// each inviscid or viscous (VISC: the residual and the assemble add
// mu_v grad v to P, the matvec fac1 mu_v grad w, as sweeps_dense.cu says),
// at the shape of the build (any (DIM, ND, NQ)): 2D patches (the golden
// cantilever at p = 3, the examples at p = 2) and multi-patch or
// knot-repeated 3D meshes.  The residual and the assemble are
// dense_finite_kernel below (one thread per element and point slot, at
// every shape); the matvec is dense_common.cuh's (design notes at the head
// of sweeps_dense.cu).  A J2Log sweep is two launches: the fast log series
// and, where a point of it left the series' range, the deep one
// (finite.cuh).  `material` 0 is J2Simo, 1 J2Log
// (ops/sweeps.py FULL_KERNELS).  The plain torch versions are
// residual_dense_plain, assemble_dense_plain (full_tangent_planes) and
// matvec_dense_plain (tangent_apply_full) with these materials.  The
// matvec also applies the full block that J2, J2Linear
// (sweeps_dense_j2.cu) and the hyperelastic materials (sweeps_dense.cu)
// write when it is asked for.
//
// The point bodies are finite.cuh's, shared with the sum-factorized
// sweeps: P(F, state) written once for float and for forward-mode dual
// numbers; the assemble runs it once in float and DIM^2 times in Dual
// (4 passes in 2D, 9 in 3D) and stores FullStorage<DIM>,
// C[a DIM^2 + b] = dP_a / dF_b: 16 planes in 2D, 81 in 3D.  The state is
// read at each point: J2Simo be_old, F_old (DIM, DIM, NQ, E), eqps and
// temperature (NQ, E); J2Log Fp_inv, eqps, temperature.
//
// What bounds them on the H100: bytes on elastic points for the residual
// and the matvec.  At 512^2 (2D, p = 3, 262,144 elements, 25 points each)
// the residual streams dN 0.84 GB, N 0.42 GB, J2Simo's state 0.26 GB and
// w det J, ~1.65 GB (0.49 ms at 3.35 TB/s); the matvec reads the 16 planes
// (0.42 GB) in place of the state.  The assemble runs the material
// DIM^2 + 1 times per point (J2Log's square-root iterations: ~8,500
// operations per dual pass in 3D), so it may turn compute bound; a plastic
// point adds the radial return's iterations (up to 40 safeguarded
// Newton-bisection trips with powf / logf, the reference kernels' cap)
// once, in the float pass.
//
// Rounding: the source is built without FMA (ops/build.py NO_FMAD).  F is
// formed in the plain version's order (dense_common.cuh grad_q_of), so it
// agrees with the plain version to the bit; the material body then rounds
// in its own order (cbrtf against torch's x ** (1/3)), so the trial state,
// and at points right at the yield surface the yield decision, may differ
// from the plain version's by float32 rounding.
//
// bfloat16 (sweeps_dense_finite_bf16.cu, MIMI_DENSE_BF16, built with
// -fmad=false as this source): mimi_assemble_dense_finite_bf16 stores the
// full block rounded to nearest even, mimi_matvec_dense_full_bf16 reads it
// with the bfloat16 copies of dN and N, as sweeps_dense.cu says.

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "finite.cuh"
#include "materials.cuh"

namespace {

// ---- dense_finite_kernel: one thread per (element, point slot) -------------------
//
// The residual and the assemble of J2Simo and J2Log at every dense shape.
// One thread per element ran the J2Log body 10 times a point with the
// element's DIM ND output sums live (81 floats in 3D), at 255 registers
// with 560-648 B spilled and 8 warps an SM (PERF.md).  Here a block takes
// DTILE = 32 consecutive elements, one per lane (every table, state and
// plane access of a warp is one 128-byte line), in SLOTS warps (4; 8 past
// 64 dofs).  The tile's u and a (and v, viscous) are staged in shared
// memory as [DIM ND][DTILE].  The NQ points run in rounds of SLOTS: warp s
// runs the float pass of point q0 + s (F with grad_q_of's operations, mu_v
// grad v, the material, rho a) and hands the point's flux X, m and w det J,
// and with the tangent its F and return map (FinitePoint), to shared
// memory.  After a barrier each thread adds the round's points, in q order,
// to the sums of the nodes n = s + SLOTS j it owns, with scatter_q's
// operations; the sums are in registers for the round's scatter only and
// in shared memory between rounds, so that none is live across a dual
// pass.  The assemble then deals the round's SLOTS x DIM^2 (point, column
// b) items over the block's warps: a thread runs one forward-mode pass at
// a time from the point's FinitePoint (FiniteMat::column) and stores
// column b's DIM^2 planes (a DIM^2 + b) QE + qe, one line a warp each.  F,
// P, the sums' order and the planes are the one-thread kernel's
// (dense_common.cuh dense_residual_kernel), so with -fmad=false
// (ops/build.py NO_FMAD) the outputs equal its outputs to the bit.  Shared
// memory of the assemble: 44.3 KB a block at (3, 27, 64), 54.6 KB viscous
// (v staged and mu_v grad v formed before the material: read from device
// memory after it, its loads spilled 0.8-1.8 KB at 128 registers), 19.5 KB
// at (2, 16, 25), 14.8 KB at (2, 9, 16).  Where all of u, a and v would
// pass the 227 KB a block may have (3D from p = 5: 256-268 KB at
// (3, 216, 343)), the fields are staged in that order while they fit and
// the rest read from device memory, one line a warp (FiniteTile::staged).
template <class S>
struct FiniteTile {
  static constexpr int DIM = S::DIM, D2 = DIM * DIM, SLOTS = S::SLOTS;
  static constexpr int OWN_NODES = (S::ND + SLOTS - 1) / SLOTS;
  static constexpr int SUMS = DIM * OWN_NODES;  // a thread's output sums
  static constexpr int PT = D2 + 3;             // a point's F, d*, r'(d*), flags
  static constexpr int THREADS = DTILE * SLOTS;
  // floats of a block's shared memory beside the staged fields: the
  // round's fluxes; the owners' sums; with the tangent, the round's points
  __host__ __device__ static constexpr size_t rest(bool tangent) {
    return (size_t)DTILE * SLOTS * (TileStage<DIM>::N + SUMS + (tangent ? PT : 0));
  }
  // the fields staged in shared memory: u, a (and v, viscous), as many of
  // them as fit in a block's shared memory
  __host__ __device__ static constexpr int staged(bool tangent, bool visc) {
    int n = visc ? 3 : 2;
    while (n > 0 && sizeof(float) * (rest(tangent) + (size_t)DTILE * n * S::NW) > BLOCK_SMEM_MAX)
      --n;
    return n;
  }
  __host__ __device__ static constexpr size_t bytes(bool tangent, bool visc) {
    return sizeof(float) * (rest(tangent) + (size_t)DTILE * staged(tangent, visc) * S::NW);
  }
  // blocks an SM (__launch_bounds__): the assemble and the 3D residual
  // four (16 warps, 128 registers a thread), the 2D residual eight (32
  // warps, 64 registers: at four it ran 0.82-0.96x the one-thread kernel
  // at 512^2, PERF.md), each at most as many as the SM's 228 KB of shared
  // memory holds
  static constexpr int blocks(bool tangent, bool visc) {
    const int want = tangent || DIM == 3 ? 4 : 8;
    const size_t fit = 228 * 1024 / (bytes(tangent, visc) + 1024);
    return fit >= (size_t)want ? want : fit < 1 ? 1 : (int)fit;
  }
};

template <class Mat, class S, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(FiniteTile<S>::THREADS, FiniteTile<S>::blocks(TANGENT, VISC))
    dense_finite_kernel(Mat mat, const float* __restrict__ u_el, const float* __restrict__ a_el,
                        const float* __restrict__ v_el, const float* __restrict__ dN,
                        const float* __restrict__ N, const float* __restrict__ wq,
                        float* __restrict__ out, CT* __restrict__ cout, float rho, float mu_v,
                        long long E) {
  if (!launch_runs(mat)) return;  // J2Log's deep launch where no point needs it
  using FT = FiniteTile<S>;
  using T = TileStage<S::DIM>;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, D2 = FT::D2;
  constexpr int SLOTS = FT::SLOTS, SUMS = FT::SUMS, PT = FT::PT;
  constexpr int NF = FT::staged(TANGENT, VISC);  // staged fields: u, a (, v)
  static_assert(FT::bytes(TANGENT, VISC) <= BLOCK_SMEM_MAX, "a block's shared memory");
  // staged[NF][NW][DTILE], st[SLOTS][T::N][DTILE], sums[SLOTS][SUMS][DTILE],
  // pts[SLOTS][PT][DTILE]
  MIMI_DYNAMIC_SHARED(float, smem);
  float(*staged)[NW][DTILE] = reinterpret_cast<float(*)[NW][DTILE]>(smem);
  float(*st)[T::N][DTILE] = reinterpret_cast<float(*)[T::N][DTILE]>(smem + NF * NW * DTILE);
  float(*sums)[SUMS][DTILE] =
      reinterpret_cast<float(*)[SUMS][DTILE]>(smem + (NF * NW + SLOTS * T::N) * DTILE);
  float(*pts)[PT][DTILE] = reinterpret_cast<float(*)[PT][DTILE]>(
      smem + (NF * NW + SLOTS * (T::N + SUMS)) * DTILE);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  const float* const fields[3] = {u_el, a_el, v_el};
  // entry k of field f (0 u, 1 a, 2 v) of this thread's element, staged
  // or from device memory
  auto field = [=](int f, int k) {
    return f < NF ? staged[f][k][lane] : __ldg(fields[f] + (long long)k * E + e);
  };
  for (int r = slot; r < NW; r += SLOTS)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      staged[f][r][lane] = live ? __ldg(fields[f] + (long long)r * E + e) : 0.f;
#pragma unroll
  for (int k = 0; k < SUMS; ++k) sums[slot][k][lane] = 0.f;
  __syncthreads();
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q0 = 0; q0 < NQ; q0 += SLOTS) {
    const int left = NQ - q0 < SLOTS ? NQ - q0 : SLOTS;  // the round's points
    if (live && slot < left) {  // the float pass of point q0 + slot
      const long long qe = (long long)(q0 + slot) * E + e;
      float F[DIM][DIM], X[DIM][DIM];
      grad_q_of<DIM, ND>(dN, [=](int k) { return field(0, k); }, qe, QE, F);
#pragma unroll
      for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
      if (VISC) {  // mu_v dV, into the flux slots: added to P below
        float dV[DIM][DIM];
        grad_q_of<DIM, ND>(dN, [=](int k) { return field(2, k); }, qe, QE, dV);
#pragma unroll
        for (int c = 0; c < DIM; ++c)
#pragma unroll
          for (int d = 0; d < DIM; ++d) st[slot][c * DIM + d][lane] = mul(mu_v, dV[c][d]);
      }
      {
        typename Mat::Point pt;
        mat.template eval<TANGENT>(F, qe, QE, X, pt);
        if constexpr (TANGENT) {
          float(*p)[DTILE] = pts[slot];
#pragma unroll
          for (int k = 0; k < D2; ++k) p[k][lane] = pt.F[k / DIM][k % DIM];
          p[D2][lane] = pt.rm.dstar;
          p[D2 + 1][lane] = pt.rm.fprime;
          p[D2 + 2][lane] = (float)((pt.rm.active ? 1 : 0) + (pt.rm.log_bad ? 2 : 0));
        }
      }
      float av[DIM];
      value_q_of<DIM, ND>(N, [=](int k) { return field(1, k); }, qe, QE, av);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
#pragma unroll
        for (int d = 0; d < DIM; ++d)  // P + mu_v dV, in the plain version's order
          st[slot][c * DIM + d][lane] =
              VISC ? add(X[c][d], st[slot][c * DIM + d][lane]) : X[c][d];
        st[slot][T::M + c][lane] = rho * av[c];
      }
      st[slot][T::W][lane] = __ldg(wq + qe);
    }
    __syncthreads();
    if (live) {
      // the round's points, in q order, into this thread's nodes' sums
      // (scatter_q's operations for node n), held in registers for the
      // round only: each point's flux is read from shared memory once
      float acc[FT::OWN_NODES][DIM];
#pragma unroll
      for (int j = 0; j < FT::OWN_NODES; ++j)
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          acc[j][c] = slot + SLOTS * j < ND ? sums[slot][j * DIM + c][lane] : 0.f;
#pragma unroll 1
      for (int s = 0; s < left; ++s) {
        const long long qe = (long long)(q0 + s) * E + e;
        const float(*p)[DTILE] = st[s];
        float X[DIM][DIM], m[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
#pragma unroll
          for (int d = 0; d < DIM; ++d) X[c][d] = p[c * DIM + d][lane];
          m[c] = p[T::M + c][lane];
        }
        const float wqv = p[T::W][lane];
#pragma unroll
        for (int j = 0; j < FT::OWN_NODES; ++j) {
          const int n = slot + SLOTS * j;
          if (n < ND) {
            float d[DIM];
#pragma unroll
            for (int f = 0; f < DIM; ++f) d[f] = __ldg(dN + (long long)(n * DIM + f) * QE + qe);
            const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
            for (int c = 0; c < DIM; ++c) {
              float x = d[0] * X[c][0];
#pragma unroll
              for (int f = 1; f < DIM; ++f) x += d[f] * X[c][f];
              x += Nn * m[c];
              acc[j][c] += wqv * x;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < FT::OWN_NODES; ++j)
        if (slot + SLOTS * j < ND)
#pragma unroll
          for (int c = 0; c < DIM; ++c) sums[slot][j * DIM + c][lane] = acc[j][c];
      if constexpr (TANGENT) {  // the round's (point, column) items, dealt over the warps
#pragma unroll 1
        for (int i = slot; i < left * D2; i += SLOTS) {
          const int s = i / D2, b = i % D2;
          const long long qe = (long long)(q0 + s) * E + e;
          const float(*p)[DTILE] = pts[s];
          typename Mat::Point pt;
#pragma unroll
          for (int k = 0; k < D2; ++k) pt.F[k / DIM][k % DIM] = p[k][lane];
          pt.rm.dstar = p[D2][lane];
          pt.rm.fprime = p[D2 + 1][lane];
          const int flags = (int)p[D2 + 2][lane];
          pt.rm.active = flags & 1;
          pt.rm.log_bad = flags & 2;
          float col[D2];
          mat.column(pt, qe, QE, b, col);
#pragma unroll
          for (int a = 0; a < D2; ++a) store_c(cout + (long long)(a * D2 + b) * QE + qe, col[a]);
        }
      }
    }
    __syncthreads();  // the round's points are read before the next overwrites them
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < FT::OWN_NODES; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          out[(long long)(c * ND + n) * E + e] = sums[slot][j * DIM + c][lane];
    }
  }
}

template <class S, bool TANGENT, bool VISC>
int launch_finite(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                  const float* N, const float* wq, const float* s0, const float* s1,
                  const float* s2, const float* s3, float* out, DenseBlock* cout,
                  const J2Params& p, float mu_v, int material, long long E, void* stream) {
  using FT = FiniteTile<S>;
  constexpr size_t smem = FT::bytes(TANGENT, VISC);
  const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
  return with_finite_material<S::DIM>(
      material, p, s0, s1, s2, s3, stream, [&](const auto& m) {
        using Mat = std::decay_t<decltype(m)>;
        if (const int err =
                allow_dynamic_smem<dense_finite_kernel<Mat, S, TANGENT, VISC, DenseBlock>>(smem))
          return err;
        dense_finite_kernel<Mat, S, TANGENT, VISC, DenseBlock>
            <<<tiles, FT::THREADS, smem, (cudaStream_t)stream>>>(m, u_el, a_el, v_el, dN, N, wq,
                                                                 out, cout, p.rho, mu_v, E);
        return (int)cudaGetLastError();
      });
}

template <bool TANGENT>
int finite_entry(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                 const float* N, const float* wq, const float* s0, const float* s1,
                 const float* s2, const float* s3, float* out, DenseBlock* cout,
                 const J2Params& p, float mu_v, int material, int dim, int nd, int nq, long long E,
                 void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    if (v_el)
      return launch_finite<S, TANGENT, true>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3,
                                                  out, cout, p, mu_v, material, E, stream);
    return launch_finite<S, TANGENT, false>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3,
                                                 out, cout, p, mu_v, material, E, stream);
  });
}

}  // namespace

// C entry points, full storage; (dim, nd, nq) the shape of the build.  The state leaves s0..s3 in the order
// of ops/sweeps.py FULL_KERNELS (J2Simo be_old, F_old, eqps, temperature;
// J2Log Fp_inv, eqps, temperature, s3 unused); v_el == nullptr (visc == 0
// for the matvec) selects the inviscid instantiation; the block (and the
// matvec's dN, N) in DenseBlock, __nv_bfloat16 in the _bf16 entry points.
// Each returns the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for another shape or an unknown material.
extern "C" {

#ifndef MIMI_DENSE_BF16
int mimi_residual_dense_finite(const float* u_el, const float* a_el, const float* v_el,
                               const float* dN, const float* N, const float* wq,
                               const float* s0, const float* s1, const float* s2,
                               const float* s3, float* out, J2Params p, float mu_v,
                               int material, int dim, int nd, int nq, long long E, void* stream) {
  return finite_entry<false>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3, out, nullptr, p,
                             mu_v, material, dim, nd, nq, E, stream);
}
#endif

int MIMI_DENSE_ENTRY(mimi_assemble_dense_finite)(const float* u_el, const float* a_el,
                                                 const float* v_el, const float* dN,
                                                 const float* N, const float* wq,
                                                 const float* s0, const float* s1,
                                                 const float* s2, const float* s3, float* out,
                                                 DenseBlock* cout, J2Params p, float mu_v,
                                                 int material, int dim, int nd, int nq, long long E,
                                                 void* stream) {
  return finite_entry<true>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3, out, cout, p, mu_v,
                            material, dim, nd, nq, E, stream);
}

// J2Log's sweeps whose deep launch ran (finite.cuh), since the library was
// loaded, into *launches; waits for the device
int MIMI_DENSE_ENTRY(mimi_logm_deep_dense_finite)(long long* launches) {
  return logm_deep_count(launches);
}

int MIMI_DENSE_ENTRY(mimi_matvec_dense_full)(const float* w_el, const DenseBlock* dN,
                                             const DenseBlock* N, const float* wq,
                                             const DenseBlock* cf, float* out, float rho,
                                             float fac0, int visc, float fac1_mu_v, int dim,
                                             int nd, int nq, long long E, void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    if (visc)
      return launch_dense_matvec<FullStorage<DIM>, S, true>(w_el, dN, N, wq, cf, out, rho,
                                                                 fac0, E, stream, fac1_mu_v);
    return launch_dense_matvec<FullStorage<DIM>, S>(w_el, dN, N, wq, cf, out, rho, fac0,
                                                         E, stream);
  });
}

}  // extern "C"
