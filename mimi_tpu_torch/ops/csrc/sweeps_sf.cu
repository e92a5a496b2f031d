// Sum-factorized quadrature sweeps of the implicit step, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its sum-factorized branch:
//   residual_kernel<.., false, ..>  <- make_residual_sweep (sf_mode)   residual only
//   residual_kernel<.., true, ..>   <- make_assemble_sweep (sf)        residual + tangent planes
//   matvec_kernel                   <- make_matvec_sweep_sf            y = J w
// for J2 with the 37-plane Cauchy-decomposition tangent
// (c_storage="cauchy": mimi_residual_sf, mimi_assemble_sf, mimi_matvec_sf)
// and for the hyperelastic materials of materials.cuh (neo-Hookean,
// St. Venant-Kirchhoff) with the 45-plane symmetric tangent
// (c_storage="sym": mimi_residual_sf_hyper, mimi_assemble_sf_hyper,
// mimi_matvec_sf_sym).  The finite-strain plasticity models J2Simo and J2Log
// with the 81-plane full tangent (c_storage="full") instantiate the same
// kernel templates in sweeps_sf_finite.cu; the templates, the 1D-table
// interpolation and scatter, the Johnson-Cook radial return and FullStorage
// are in sf_common.cuh.
// The plain torch versions of the same functions are in ops/sweeps.py.
//
// Variants (compile-time template parameters, one instantiation each,
// chosen on the host by the C entry points; no run-time branch in the hot
// loop):
//   Mat   the material: its state, its first Piola stress at a point and
//         what its tangent storage needs of that point (`eval`).  J2Mat
//         runs the radial return on the point's state; Hyper<NeoHookean>
//         and Hyper<StVK> are stateless and form P without fused
//         multiply-add, as the dense kernels do; J2SimoMat and J2LogMat
//         (sweeps_sf_finite.cu) run one body for P in float and, for the
//         tangent, in forward-mode dual numbers (dual.cuh).
//   Store the tangent block: CauchyStorage (37 planes: D-hat, sigma, F^-1,
//         J; the matvec rebuilds P and applies the geometric terms),
//         SymStorage (45 upper-triangle planes of a major-symmetric dP/dF)
//         or FullStorage (81 planes C[a*9 + b] = dP_a / dF_b, sf_common.cuh).
//   VISC  the viscous flux of has_visc: residual and assemble add mu_v dV
//         (dV = grad v at the point, from v_el as dF is formed from u_el;
//         sweeps.py:404-406, :651-653); the matvec adds fac1 mu_v dF
//         (_tangent_apply :816-817, :833-834).  The tangent block does not
//         change.  Costs one more (3,27,E) read in residual and assemble.
//   CT    storage of the 37-plane tangent block, float or __nv_bfloat16
//         (c_dtype, sweeps.py:474,595-617).  The assemble rounds each plane
//         to nearest even (as astype(bfloat16)); the matvec widens on load.
//         At 48^3 the matvec then streams 0.52 GB of C instead of 1.05 GB.
//
// Design: one thread per element, looping over its 64 quadrature points.
// The batch-last layout (..., n_q, n_el) puts neighbouring elements on
// neighbouring addresses, so every table, state and tangent read of a warp
// coalesces; the 81 element outputs accumulate in registers, so there is no
// cross-thread reduction and no atomics.  The 1D tables are indexed
// directly by (q0, q1, q2) and (a0, a1, a2): q = q0 + 4 q1 + 16 q2 and
// n = a0 + 3 a1 + 9 a2, basis products formed per point.
//
// What bounds them on the H100: the matvec streams the 37-plane tangent
// block (9.5 KB per element) plus jinv (2.3 KB) once per GMRES iteration,
// 1.4 GB per call at 48^3, so it is bandwidth bound (~0.42 ms floor at
// 3.35 TB/s): per point it does ~1.7k flops against ~200 bytes, about
// 8 flop/byte, under the ~20 flop/byte float32 ridge.  The assemble writes
// the same 1.05 GB tangent and runs the radial return (up to 100
// safeguarded Newton-bisection trips with powf/logf on plastic points), so
// plastic-heavy calls can turn compute bound.  Register
// pressure (81 element values + 81 accumulators per thread) spills to
// local memory, which stays in L1; a thread-per-point layout with shared
// memory staging is the known next step and not done here.  The symmetric
// matvec streams 45 planes (1.27 GB at 48^3, ~0.50 ms at 3.35 TB/s).
//
// Rounding of the hyperelastic variants: F comes out of the per-point
// basis products below with fused multiply-add, so it agrees with the
// plain version's staged einsums to float32 rounding of grad u (not to the
// bit, as on the dense tables); P is then formed from that F without FMA
// in the plain version's operation order.  Near F = I the stress cancels,
// so a rounding difference of F of one ulp of 1 (1.2e-7) is one of
// (lambda + 2 mu) 1.2e-7 in P whatever the strain.
//
// The tangent has no automatic differentiation: the closed-form algorithmic
// tangent of the radial return,
//   M = K 1(x)1 + 2G (1 - 3G d/q) I_dev + 6G^2 (d/q - 1/(3G + h')) n(x)n,
//   h' = -dr/dd - 3G at the converged increment,
// equals the forward derivative of the reference implementation (including
// its implicit-function-theorem correction d = d* - r/r'), and is written in
// the same D-hat storage: tensor components C_ijkl over the symmetric basis,
// upper triangle, 21 planes.

#include "sf_common.cuh"

namespace {

// J2 Cauchy stress at one point; with TANGENT also the 21 D-hat planes
template <bool TANGENT>
__device__ __forceinline__ void j2_cauchy(const J2Params& p, const float F[3][3],
                                          const float ps[3][3], float eqps,
                                          float temp, float sig[3][3],
                                          float Mt[21]) {
  float eps[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      eps[i][j] = 0.5f * (F[i][j] + F[j][i]) - ps[i][j] - (i == j ? 1.f : 0.f);
  const float tr = eps[0][0] + eps[1][1] + eps[2][2];
  const float pr = p.K * tr;
  const float tr3 = tr / 3.f;
  const float G2 = 2.f * p.G;
  float s[3][3];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s[i][j] = i == j ? G2 * (eps[i][j] - tr3) : G2 * eps[i][j];
      ss += s[i][j] * s[i][j];
    }
  const float snorm = sqrtf(ss);
  const float q = sqrtf(1.5f) * snorm;
  bool active;
  float fprime = 0.f, dstar;
  const float delta =
      radial_return(p, q, eqps, jc_thermo(p, temp), 3.f * p.G, &active, &fprime, &dstar);
  const float npf = 1.5f / (q > 0.f ? q : 1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sig[i][j] = (s[i][j] - G2 * delta * (npf * s[i][j])) + (i == j ? pr : 0.f);
  if (TANGENT) {
    const float G = p.G;
    float c1 = G2, c2 = 0.f;
    if (active) {
      const float h = -fprime - 3.f * G;
      c1 = G2 * (1.f - 3.f * G * delta / q);
      c2 = 6.f * G * G * (delta / q - 1.f / (3.f * G + h));
    }
    const float inv_s = snorm > 0.f ? 1.f / snorm : 0.f;
    const int SI[6] = {0, 0, 0, 1, 1, 2};
    const int SJ[6] = {0, 1, 2, 1, 2, 2};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) {
        const int i = SI[a], j = SJ[a], kk = SI[b], l = SJ[b];
        const float dij = i == j ? 1.f : 0.f, dkl = kk == l ? 1.f : 0.f;
        const float isym = 0.5f * ((i == kk && j == l ? 1.f : 0.f) +
                                   (i == l && j == kk ? 1.f : 0.f));
        const float idev = isym - dij * dkl / 3.f;
        Mt[k++] = p.K * dij * dkl + c1 * idev +
                  c2 * (s[i][j] * inv_s) * (s[kk][l] * inv_s);
      }
  }
}

// ---- materials on the sf kernels --------------------------------------------

// J2 with its per-point state (plastic strain, eqps, temperature)
struct J2Mat {
  J2Params p;
  const float* ps;
  const float* eqps;
  const float* temp;
  struct Point {
    float Mt[21], sig[3][3], fi[3][3], J;
  };
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[3][3], long long qe, long long QE,
                                       float P[3][3], Point& pt) const {
    float pst[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) pst[i][j] = __ldg(ps + (i * 3 + j) * QE + qe);
    j2_cauchy<TANGENT>(p, F, pst, __ldg(eqps + qe), __ldg(temp + qe), pt.sig, pt.Mt);
    pt.J = det3(F);
    inv3(F, pt.J, pt.fi);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        P[c][d] = pt.J * (pt.sig[c][0] * pt.fi[d][0] + pt.sig[c][1] * pt.fi[d][1] +
                          pt.sig[c][2] * pt.fi[d][2]);
  }
};

// a stateless hyperelastic material of materials.cuh
template <class H>
struct Hyper {
  H h;
  using Point = typename H::Tangent;
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[3][3], long long, long long,
                                       float P[3][3], Point& pt) const {
    h.pk1(F, P);
    if (TANGENT) pt = h.tangent(F);
  }
};

// the 37-plane Cauchy-decomposition block (ops/sweeps.py
// cauchy_plane_layout): D-hat 21, sigma 6, F^-1 9, J
struct CauchyStorage {
  template <typename CT>
  __device__ __forceinline__ static void store(CT* __restrict__ cout, long long qe,
                                               long long QE, const J2Mat&,
                                               const J2Mat::Point& pt) {
#pragma unroll
    for (int k = 0; k < 21; ++k) store_c(cout + k * QE + qe, pt.Mt[k]);
    const int SI[6] = {0, 0, 0, 1, 1, 2};
    const int SJ[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int a = 0; a < 6; ++a) store_c(cout + (21 + a) * QE + qe, pt.sig[SI[a]][SJ[a]]);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) store_c(cout + (27 + r * 3 + c) * QE + qe, pt.fi[r][c]);
    store_c(cout + 36 * QE + qe, pt.J);
  }
  // dP = fac0 (tr(F^-1 dF) P + J (D-hat : sym dF) F^-T - P dF^T F^-T)
  template <typename CT>
  __device__ __forceinline__ static void apply(const CT* __restrict__ cb, long long qe,
                                               long long QE, const float dF[3][3],
                                               float fac0, float dP[3][3]) {
    const int SI[6] = {0, 0, 0, 1, 1, 2};
    const int SJ[6] = {0, 1, 2, 1, 2, 2};
    float M[21];
#pragma unroll
    for (int k = 0; k < 21; ++k) M[k] = load_c(cb + k * QE + qe);
    float sig[3][3], fi[3][3];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float x = load_c(cb + (21 + a) * QE + qe);
      sig[SI[a]][SJ[a]] = x;
      sig[SJ[a]][SI[a]] = x;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) fi[r][c] = load_c(cb + (27 + r * 3 + c) * QE + qe);
    const float J = load_c(cb + 36 * QE + qe);
    // d sigma = D-hat : (dF_ii, dF_ij + dF_ji), symmetric storage
    float cm[6], ds6[6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      cm[a] = SI[a] == SJ[a] ? dF[SI[a]][SI[a]] : dF[SI[a]][SJ[a]] + dF[SJ[a]][SI[a]];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float acc6 = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        const int lo = a < b ? a : b, hi = a < b ? b : a;
        // upper-triangle index of (lo, hi) in 6x6 row-major
        const int k = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
        acc6 += M[k] * cm[b];
      }
      ds6[a] = acc6;
    }
    float dsig[3][3];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      dsig[SI[a]][SJ[a]] = ds6[a];
      dsig[SJ[a]][SI[a]] = ds6[a];
    }
    float P[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        P[c][d] = J * (sig[c][0] * fi[d][0] + sig[c][1] * fi[d][1] +
                       sig[c][2] * fi[d][2]);
    float trF = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k) trF += fi[c][k] * dF[k][c];
    float A[3][3];  // A = dF^T F^-T
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        A[a][b] = dF[0][a] * fi[b][0] + dF[1][a] * fi[b][1] + dF[2][a] * fi[b][2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        dP[c][d] = fac0 * (trF * P[c][d] +
                           J * (dsig[c][0] * fi[d][0] + dsig[c][1] * fi[d][1] +
                                dsig[c][2] * fi[d][2]) -
                           (P[c][0] * A[0][d] + P[c][1] * A[1][d] +
                            P[c][2] * A[2][d]));
  }
};

template <class H, bool TANGENT>
int launch_hyper(const float* u_el, const float* a_el, const Tables& tb, const float* jinv,
                 const float* wq, float* out, void* cout, const HyperelasticParams& p,
                 long long E, void* stream) {
  return launch_residual<Hyper<H>, SymStorage, TANGENT, false, float>(
      u_el, a_el, nullptr, tb, jinv, wq, out, cout, Hyper<H>{H{p.mu, p.lam}}, p.rho, 0.f, E,
      stream);
}

}  // namespace

// C entry points; each returns the launch's cudaGetLastError().  For J2,
// v_el == nullptr selects the inviscid variant and c_bf16 the bfloat16
// tangent block.  The hyperelastic ones are inviscid with a float32 block;
// `material`: 0 the neo-Hookean, 1 the St. Venant-Kirchhoff material.
extern "C" {

int mimi_residual_sf(const float* u_el, const float* a_el, const float* v_el,
                     const float* b0, const float* d0, const float* b1,
                     const float* d1, const float* b2, const float* d2,
                     const float* jinv, const float* wq, const float* ps,
                     const float* eqps, const float* temp, float* out,
                     J2Params p, float mu_v, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  const J2Mat mat{p, ps, eqps, temp};
  if (v_el)
    return launch_residual<J2Mat, CauchyStorage, false, true, float>(
        u_el, a_el, v_el, tb, jinv, wq, out, nullptr, mat, p.rho, mu_v, E, stream);
  return launch_residual<J2Mat, CauchyStorage, false, false, float>(
      u_el, a_el, v_el, tb, jinv, wq, out, nullptr, mat, p.rho, mu_v, E, stream);
}

int mimi_assemble_sf(const float* u_el, const float* a_el, const float* v_el,
                     const float* b0, const float* d0, const float* b1,
                     const float* d1, const float* b2, const float* d2,
                     const float* jinv, const float* wq, const float* ps,
                     const float* eqps, const float* temp, float* out,
                     void* cout, int c_bf16, J2Params p, float mu_v, long long E,
                     void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  const J2Mat mat{p, ps, eqps, temp};
#define MIMI_ASM(VISC, CT)                                               \
  return launch_residual<J2Mat, CauchyStorage, true, VISC, CT>(          \
      u_el, a_el, v_el, tb, jinv, wq, out, cout, mat, p.rho, mu_v, E, stream)
  if (v_el) {
    if (c_bf16) MIMI_ASM(true, __nv_bfloat16);
    MIMI_ASM(true, float);
  }
  if (c_bf16) MIMI_ASM(false, __nv_bfloat16);
  MIMI_ASM(false, float);
#undef MIMI_ASM
}

int mimi_matvec_sf(const float* w_el, const float* b0, const float* d0,
                   const float* b1, const float* d1, const float* b2,
                   const float* d2, const float* jinv, const float* wq,
                   const void* cb, int c_bf16, float* out, float rho, float fac0,
                   int visc, float fac1_mu_v, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
#define MIMI_MV(VISC, CT)                                                      \
  return launch_matvec<CauchyStorage, VISC, CT>(w_el, tb, jinv, wq, cb, out, rho, \
                                                fac0, fac1_mu_v, E, stream)
  if (visc) {
    if (c_bf16) MIMI_MV(true, __nv_bfloat16);
    MIMI_MV(true, float);
  }
  if (c_bf16) MIMI_MV(false, __nv_bfloat16);
  MIMI_MV(false, float);
#undef MIMI_MV
}

int mimi_residual_sf_hyper(const float* u_el, const float* a_el, const float* b0,
                           const float* d0, const float* b1, const float* d1,
                           const float* b2, const float* d2, const float* jinv,
                           const float* wq, float* out, HyperelasticParams p, int material,
                           long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  if (material == 0)
    return launch_hyper<NeoHookean, false>(u_el, a_el, tb, jinv, wq, out, nullptr, p, E, stream);
  if (material == 1)
    return launch_hyper<StVK, false>(u_el, a_el, tb, jinv, wq, out, nullptr, p, E, stream);
  return (int)cudaErrorInvalidValue;
}

int mimi_assemble_sf_hyper(const float* u_el, const float* a_el, const float* b0,
                           const float* d0, const float* b1, const float* d1,
                           const float* b2, const float* d2, const float* jinv,
                           const float* wq, float* out, float* cout, HyperelasticParams p,
                           int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  if (material == 0)
    return launch_hyper<NeoHookean, true>(u_el, a_el, tb, jinv, wq, out, cout, p, E, stream);
  if (material == 1)
    return launch_hyper<StVK, true>(u_el, a_el, tb, jinv, wq, out, cout, p, E, stream);
  return (int)cudaErrorInvalidValue;
}

int mimi_matvec_sf_sym(const float* w_el, const float* b0, const float* d0,
                       const float* b1, const float* d1, const float* b2,
                       const float* d2, const float* jinv, const float* wq,
                       const float* cs, float* out, float rho, float fac0, long long E,
                       void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_matvec<SymStorage, false, float>(w_el, tb, jinv, wq, cs, out, rho, fac0, 0.f,
                                                 E, stream);
}

}  // extern "C"
