// Sum-factorized quadrature sweeps of the implicit step, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its sum-factorized branch, all instantiations
// of one template (sf_common.cuh sf_tile_kernel) with a point functor:
//   SfResidualPoint<.., false, ..>  <- make_residual_sweep (sf_mode)   residual only
//   SfResidualPoint<.., true, ..>   <- make_assemble_sweep (sf)        residual + tangent planes
//   SfMatvecPoint                   <- make_matvec_sweep_sf            y = J w
// for J2 (any of the reference's hardening laws) and J2Linear with the
// 37-plane Cauchy-decomposition tangent (c_storage="cauchy":
// mimi_residual_sf, mimi_assemble_sf, mimi_matvec_sf) or, asked for, the
// 81-plane full one (c_storage="full": mimi_assemble_sf's `full`, the
// matvec mimi_matvec_sf_full of sweeps_sf_finite.cu).
// The hyperelastic materials of materials.cuh (neo-Hookean, St.
// Venant-Kirchhoff) with the 45-plane symmetric tangent (c_storage="sym")
// instantiate the same kernel templates in sweeps_sf_hyper.cu, the
// finite-strain plasticity models J2Simo and J2Log with the 81-plane full
// tangent (c_storage="full") in sweeps_sf_finite.cu; the templates and the 1D-table
// interpolation and scatter are in sf_common.cuh, the storages in
// materials.cuh, the J2 return maps and hardening laws in j2.cuh.
// The plain torch versions of the same functions are in ops/sweeps.py.
//
// Variants (compile-time template parameters, one instantiation each,
// chosen on the host by the C entry points; no run-time branch in the hot
// loop):
//   Mat   the material: its state, its first Piola stress at a point and
//         what its tangent storage needs of that point (`eval`).
//         J2Mat<false> runs J2's radial return on the point's state,
//         J2Mat<true> J2Linear's closed-form return; Hyper<NeoHookean<3>>
//         and Hyper<StVK<3>> (materials.cuh) are stateless and form P without fused
//         multiply-add, as the dense kernels do; J2SimoMat and J2LogMat
//         (finite.cuh) run one body for P in float and, for the tangent,
//         in forward-mode dual numbers (dual.cuh).
//   Store the tangent block: CauchyStorage (37 planes: D-hat, sigma, F^-1,
//         J; the matvec rebuilds P and applies the geometric terms),
//         SymStorage (45 upper-triangle planes of a major-symmetric dP/dF)
//         or FullStorage<3> (81 planes C[a*9 + b] = dP_a / dF_b: every
//         material's, column by column from its own tangent).
//   VISC  the viscous flux of has_visc: residual and assemble add mu_v dV
//         (dV = grad v at the point, from v_el as dF is formed from u_el;
//         sweeps.py:404-406, :651-653); the matvec adds fac1 mu_v dF
//         (_tangent_apply :816-817, :833-834).  The tangent block does not
//         change.  Costs one more (3,27,E) read in residual and assemble.
//   CT    storage of the tangent block, float or __nv_bfloat16
//         (c_dtype, sweeps.py:474,595-617).  The assemble rounds each plane
//         to nearest even (as astype(bfloat16)); the matvec widens on load.
//         At 48^3 the matvec then streams 0.52 GB of C instead of 1.05 GB.
//
// Design (sf_tile_kernel, sf_common.cuh): one thread per (element, point
// slot).  A block of 128 threads takes a tile of 32 consecutive elements,
// one per lane, in 4 warps, warp s taking the points q = s (mod 4) of every
// element; the batch-last layout (..., n_q, n_el) makes every table,
// jinv, w det J, state and tangent-plane access of a warp one 128-byte
// line.  The tile's element fields (the residual's u, a and v; the
// matvec's w) are staged once in shared memory, [81][32] per field, each
// lane reading its own column; per point the warp forms F (grad v, a; or
// grad w and w) from there with the operations of the one-thread-per-
// element kernels this replaced, so every output rounds as theirs did,
// runs the material and stores the planes (or applies the block), and
// hands the point's 1D basis values and flux to shared memory.  Every 4
// points a barrier, then each thread adds them, in q order, to the
// outputs of the 7 (6) nodes it owns, three components each: 21
// accumulators, a deterministic reduction without atomics.  The last tile
// is masked where E % 32 != 0.  __launch_bounds__(128, 4) caps a thread at
// 128 registers, 16 warps per SM; ptxas (CUDA 12.8, sm_90a): every J2Mat
// and Hyper residual instantiation 121-128 registers, 0 B spilled;
// J2SimoMat's and J2LogMat's residual 0 B, their assemble (9 dual-number
// passes a point) 36 and 452 B (PERF.md section 6); every matvec 0 B
// (phase 2 of chip_smoke.py fails on a spilled one).  The one-thread-per-
// element kernels it replaced held the fields and 81 accumulators per
// thread: 255 registers, 376-1372 B spilled, 8 warps per SM.  The 1D
// tables are indexed directly by (q0, q1, q2) and (a0, a1, a2):
// q = q0 + 4 q1 + 16 q2 and n = a0 + 3 a1 + 9 a2, basis products formed
// per point and, by each owner, per node.
//
// p = 3 (sweeps_sf_p3.cu: this file at SfShape<4, 5>, the entry points
// named *_p3): 64 dofs and 125 points per element, [192][32] per staged
// field, 16 nodes and 48 accumulators a thread, 32 rounds of 4 points (the
// last holds one); the residual 3 blocks an SM inviscid (170 registers), 2
// viscous (255), the matvec 3 (43.0 KB a block); every J2Mat and Hyper
// instantiation 0 B spilled.  The one-thread-per-element matvec this
// replaced held 384 values of w and sums a thread and spilled ~11 KB:
// ~100x its bound.
//
// What bounds them on the H100: the matvec streams the 37-plane tangent
// block (9.5 KB per element) plus jinv (2.3 KB) once per GMRES iteration,
// 1.4 GB per call at 48^3, so by bytes it would take ~0.42 ms at
// 3.35 TB/s: per point ~1.7k flops against ~200 bytes, about 8 flop/byte,
// under the ~20 flop/byte float32 ridge.  What holds the tile back from
// that is its instructions per point: the O(ND) interpolation of grad w
// from shared memory and, per owner, the O(ND / 4) node terms of the
// reduction, ~3 x 4 ND fused multiply-adds a point with their
// shared-memory reads, and a barrier every 4 points; at p = 3 (64 nodes)
// these, not the block's bytes, set its time (the TPU kernel's staged
// axis-by-axis contraction, ~10 terms a point instead of 64, is the next
// design: ROADMAP Queue 2 item 11).  The assemble writes the same 1.05 GB
// tangent and runs the radial return (up to 40 safeguarded
// Newton-bisection trips with powf/logf on plastic points, the reference
// kernels' cap): plastic-heavy calls are bound by the trips' dependent
// chains at 16 warps per SM, the elastic ones by the per-point
// interpolation and reduction instructions.  The symmetric matvec streams
// 45 planes (1.27 GB at 48^3, ~0.50 ms at 3.35 TB/s).
//
// Rounding of the hyperelastic variants: F comes out of the per-point
// basis products below with fused multiply-add, so it agrees with the
// plain version's staged einsums to float32 rounding of grad u (not to the
// bit, as on the dense tables); P is then formed from that F without FMA
// in the plain version's operation order.  Near F = I the stress cancels,
// so a rounding difference of F of one ulp of 1 (1.2e-7) is one of
// (lambda + 2 mu) 1.2e-7 in P whatever the strain.
//
// The tangent has no automatic differentiation: the closed-form
// algorithmic tangents, the point bodies (j2_cauchy<3>, j2_linear_cauchy<3>)
// and the 37-plane CauchyStorage<3> are in j2.cuh, shared with the
// dense-table sweeps.

#include <type_traits>

#include "sf_common.cuh"

namespace {

// ---- materials on the sf kernels --------------------------------------------

// J2 (LINEAR false: plastic strain, eqps, temperature; the radial return
// with the law of J2Params) or J2Linear (LINEAR true: plastic strain, eqps,
// the back stress beta; the closed-form return) with its per-point state
template <bool LINEAR>
struct J2Mat {
  J2Params p;
  const float* ps;
  const float* eqps;
  const float* temp;  // J2
  const float* beta;  // J2Linear
  struct Point {  // what CauchyStorage<3> stores
    float Mt[Voigt<3>::NT], sig[3][3], fi[3][3], J;
  };
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[3][3], long long qe, long long QE,
                                       float P[3][3], Point& pt) const {
    float pst[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) pst[i][j] = __ldg(ps + (i * 3 + j) * QE + qe);
    if constexpr (LINEAR) {
      float bt[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) bt[i][j] = __ldg(beta + (i * 3 + j) * QE + qe);
      j2_linear_cauchy<3, TANGENT>(p, F, pst, bt, __ldg(eqps + qe), pt.sig, pt.Mt);
    } else {
      j2_cauchy<3, TANGENT>(p, F, pst, __ldg(eqps + qe), __ldg(temp + qe), pt.sig, pt.Mt);
    }
    pt.J = sm::det(F);
    sm::inv(F, pt.J, pt.fi);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        P[c][d] = pt.J * (pt.sig[c][0] * pt.fi[d][0] + pt.sig[c][1] * pt.fi[d][1] +
                          pt.sig[c][2] * pt.fi[d][2]);
  }
  // column b of dP/dF for FullStorage<3>: the Cauchy tangent on e_b
  __device__ __forceinline__ void column(const Point& pt, long long, long long, int b,
                                         float col[9]) const {
    CauchyStorage<3>::column(pt, b, col);
  }
};

// the residual (TANGENT false) or assemble kernel of J2 (material 0) or
// J2Linear (material 1), inviscid or viscous, with a float or bfloat16 block
// of the Cauchy storage or (full) the 81 planes of dP/dF
template <bool TANGENT>
int j2_sf(const float* u_el, const float* a_el, const float* v_el, const Tables& tb,
          const float* jinv, const float* wq, const float* ps, const float* eqps,
          const float* temp, const float* beta, float* out, void* cout, int c_bf16, int full,
          const J2Params& p, float mu_v, int material, long long E, void* stream) {
  if (E <= 0) return 0;
  if (material != 0 && material != 1) return cudaErrorInvalidValue;
  auto by_visc = [&](auto linear, auto store) {
    constexpr bool LINEAR = decltype(linear)::value;
    using Store = decltype(store);
    const J2Mat<LINEAR> mat{p, ps, eqps, temp, beta};
#define MIMI_J2(VISC, CT)                                                    \
  return launch_residual<Sf, J2Mat<LINEAR>, Store, TANGENT, VISC, CT>(       \
      u_el, a_el, v_el, tb, jinv, wq, out, cout, mat, p.rho, mu_v, E, stream)
    if (v_el) {
      if constexpr (TANGENT) {
        if (c_bf16) MIMI_J2(true, __nv_bfloat16);
      }
      MIMI_J2(true, float);
    }
    if constexpr (TANGENT) {
      if (c_bf16) MIMI_J2(false, __nv_bfloat16);
    }
    MIMI_J2(false, float);
#undef MIMI_J2
  };
  auto by_store = [&](auto linear) {
    if constexpr (TANGENT) {  // the residual writes no block
      if (full) return by_visc(linear, FullStorage<3>{});
    }
    return by_visc(linear, CauchyStorage<3>{});
  };
  if (material == 1) return by_store(std::true_type{});
  return by_store(std::false_type{});
}

}  // namespace

// C entry points (named *_p3 in the p = 3 twin of this source:
// MIMI_SF_ENTRY) of J2 (material 0; the state pointers ps, eqps, temp) and
// J2Linear (material 1; ps, eqps, beta); each returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for another material.
// v_el == nullptr selects the inviscid variant, c_bf16 the bfloat16
// tangent block and full the 81 planes of dP/dF (FullStorage<3>, the
// matvec mimi_matvec_sf_full of sweeps_sf_finite.cu) for the 37 of the
// Cauchy decomposition.  One entry point per sweep for both materials: they share
// the storage, the block layout and the matvec, and differ in one state
// leaf and the point body.
extern "C" {

int MIMI_SF_ENTRY(mimi_residual_sf)(const float* u_el, const float* a_el, const float* v_el,
                     const float* b0, const float* d0, const float* b1,
                     const float* d1, const float* b2, const float* d2,
                     const float* jinv, const float* wq, const float* ps,
                     const float* eqps, const float* temp, const float* beta, float* out,
                     J2Params p, float mu_v, int material, long long E, void* stream) {
  return j2_sf<false>(u_el, a_el, v_el, Tables{{b0, d0, b1, d1, b2, d2}}, jinv, wq, ps, eqps,
                      temp, beta, out, nullptr, 0, 0, p, mu_v, material, E, stream);
}

int MIMI_SF_ENTRY(mimi_assemble_sf)(const float* u_el, const float* a_el, const float* v_el,
                     const float* b0, const float* d0, const float* b1,
                     const float* d1, const float* b2, const float* d2,
                     const float* jinv, const float* wq, const float* ps,
                     const float* eqps, const float* temp, const float* beta, float* out,
                     void* cout, int c_bf16, int full, J2Params p, float mu_v, int material,
                     long long E, void* stream) {
  return j2_sf<true>(u_el, a_el, v_el, Tables{{b0, d0, b1, d1, b2, d2}}, jinv, wq, ps, eqps,
                     temp, beta, out, cout, c_bf16, full, p, mu_v, material, E, stream);
}

int MIMI_SF_ENTRY(mimi_matvec_sf)(const float* w_el, const float* b0, const float* d0,
                   const float* b1, const float* d1, const float* b2,
                   const float* d2, const float* jinv, const float* wq,
                   const void* cb, int c_bf16, float* out, float rho, float fac0,
                   int visc, float fac1_mu_v, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
#define MIMI_MV(VISC, CT)                                                      \
  return launch_matvec<Sf, CauchyStorage<3>, VISC, CT>(w_el, tb, jinv, wq, cb, out, rho, \
                                                    fac0, fac1_mu_v, E, stream)
  if (visc) {
    if (c_bf16) MIMI_MV(true, __nv_bfloat16);
    MIMI_MV(true, float);
  }
  if (c_bf16) MIMI_MV(false, __nv_bfloat16);
  MIMI_MV(false, float);
#undef MIMI_MV
}

}  // extern "C"
