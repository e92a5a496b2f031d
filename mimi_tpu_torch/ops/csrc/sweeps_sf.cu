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
// mimi_matvec_sf_sym).
// The plain torch versions of the same functions are in ops/sweeps.py.
//
// Variants (compile-time template parameters, one instantiation each,
// chosen on the host by the C entry points; no run-time branch in the hot
// loop):
//   Mat   the material: its state, its first Piola stress at a point and
//         what its tangent storage needs of that point (`eval`).  J2Mat
//         runs the radial return on the point's state; Hyper<NeoHookean>
//         and Hyper<StVK> are stateless and form P without fused
//         multiply-add, as the dense kernels do.
//   Store the tangent block: CauchyStorage (37 planes: D-hat, sigma, F^-1,
//         J; the matvec rebuilds P and applies the geometric terms) or
//         SymStorage (45 upper-triangle planes of a major-symmetric dP/dF).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "materials.cuh"

namespace {

constexpr int NG = 4;   // Gauss points per axis
constexpr int P1 = 3;   // p + 1
constexpr int NQ = NG * NG * NG;
constexpr int ND = P1 * P1 * P1;
constexpr int BLOCK = 128;

}  // namespace

struct J2Params {
  float K, G, A, B, n, C, eps0_dot, t_ref, t_melt, m, thermo_const, tol, xtol,
      dt, rho;
  int rate_dep, thermo_mode, max_iter;
};

struct Tables {
  const float* t[6];  // B0, D0, B1, D1, B2, D2, each (NG, P1, E)
};

namespace {

struct Basis {
  float b[3][P1];
  float d[3][P1];
};

__device__ __forceinline__ void load_basis(const Tables& tb, int q, long long e,
                                           long long E, Basis& s) {
  const int qs[3] = {q & 3, (q >> 2) & 3, q >> 4};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      const long long off = (long long)(qs[ax] * P1 + a) * E + e;
      s.b[ax][a] = __ldg(tb.t[2 * ax] + off);
      s.d[ax][a] = __ldg(tb.t[2 * ax + 1] + off);
    }
  }
}

__device__ __forceinline__ void load_jinv(const float* __restrict__ jinv, int q,
                                          long long e, long long E,
                                          float ji[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int f = 0; f < 3; ++f)
      ji[a][f] = __ldg(jinv + ((long long)(a * 3 + f) * NQ + q) * E + e);
}

// physical gradient g[c][f] and (optionally) values v[c] of w at one point
template <bool VALUES>
__device__ __forceinline__ void interp_grad(const float (&w)[3][ND],
                                            const Basis& s, const float ji[3][3],
                                            float g[3][3], float v[3]) {
  float gp[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = 0.f;
    gp[c][0] = gp[c][1] = gp[c][2] = 0.f;
  }
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const int n = a0 + P1 * a1 + P1 * P1 * a2;
        const float bb = s.b[1][a1] * s.b[2][a2];
        const float g0 = s.d[0][a0] * bb;
        const float g1 = s.b[0][a0] * s.d[1][a1] * s.b[2][a2];
        const float g2 = s.b[0][a0] * s.b[1][a1] * s.d[2][a2];
        const float N = s.b[0][a0] * bb;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gp[c][0] += g0 * w[c][n];
          gp[c][1] += g1 * w[c][n];
          gp[c][2] += g2 * w[c][n];
          if (VALUES) v[c] += N * w[c][n];
        }
      }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int f = 0; f < 3; ++f)
      g[c][f] = gp[c][0] * ji[0][f] + gp[c][1] * ji[1][f] + gp[c][2] * ji[2][f];
}

// values v[c] of w at one point
__device__ __forceinline__ void interp_value(const float (&w)[3][ND],
                                             const Basis& s, float v[3]) {
  v[0] = v[1] = v[2] = 0.f;
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const int n = a0 + P1 * a1 + P1 * P1 * a2;
        const float N = s.b[0][a0] * s.b[1][a1] * s.b[2][a2];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] += N * w[c][n];
      }
}

// acc[c][n] += wq (dN[n][f] X[c][f] + N[n] m[c])
__device__ __forceinline__ void scatter(float (&acc)[3][ND], const Basis& s,
                                        const float ji[3][3], float wq,
                                        const float X[3][3], const float m[3]) {
  float Z[3][3], mm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      Z[c][a] = ji[a][0] * (wq * X[c][0]) + ji[a][1] * (wq * X[c][1]) +
                ji[a][2] * (wq * X[c][2]);
    mm[c] = wq * m[c];
  }
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const int n = a0 + P1 * a1 + P1 * P1 * a2;
        const float bb = s.b[1][a1] * s.b[2][a2];
        const float g0 = s.d[0][a0] * bb;
        const float g1 = s.b[0][a0] * s.d[1][a1] * s.b[2][a2];
        const float g2 = s.b[0][a0] * s.b[1][a1] * s.d[2][a2];
        const float N = s.b[0][a0] * bb;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c][n] += g0 * Z[c][0] + g1 * Z[c][1] + g2 * Z[c][2] + N * mm[c];
      }
}

__device__ __forceinline__ float det3(const float A[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
         A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
         A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

// adjugate inverse, the same cofactor formulas as fem/soa.py inv
__device__ __forceinline__ void inv3(const float A[3][3], float det,
                                     float R[3][3]) {
  const float id = 1.f / det;
#define COF(i1, j1, i2, j2) (A[i1][j1] * A[i2][j2] - A[i1][j2] * A[i2][j1])
  R[0][0] = COF(1, 1, 2, 2) * id;
  R[0][1] = COF(0, 2, 2, 1) * id;
  R[0][2] = COF(0, 1, 1, 2) * id;
  R[1][0] = COF(1, 2, 2, 0) * id;
  R[1][1] = COF(0, 0, 2, 2) * id;
  R[1][2] = COF(0, 2, 1, 0) * id;
  R[2][0] = COF(1, 0, 2, 1) * id;
  R[2][1] = COF(0, 1, 2, 0) * id;
  R[2][2] = COF(0, 0, 1, 1) * id;
#undef COF
}

// ---- Johnson-Cook hardening and the radial-return residual -------------

__device__ __forceinline__ void jc_flow(const J2Params& p, float e, float& H,
                                        float& dH) {
  // A for |eqps| < 1e-13: keeps powf(0, n - 1) out of the derivative
  if (fabsf(e) < 1.0e-13f) {
    H = p.A;
    dH = 0.f;
  } else {
    H = p.A + p.B * powf(e, p.n);
    dH = p.B * (p.n * powf(e, p.n - 1.f));
  }
}

__device__ __forceinline__ void jc_rate(const J2Params& p, float rate, float& R,
                                        float& dR) {
  // rate guard: logf only above the reference rate
  if (p.rate_dep && rate > p.eps0_dot) {
    R = 1.f + p.C * logf(rate / p.eps0_dot);
    dR = p.C / rate;
  } else {
    R = 1.f;
    dR = 0.f;
  }
}

__device__ __forceinline__ float jc_thermo(const J2Params& p, float T) {
  if (p.thermo_mode == 2) return p.thermo_const;
  if (p.thermo_mode == 0) return 1.f;
  if (T < p.t_ref) return 1.f;
  if (T > p.t_melt) return 0.f;
  const float theta = (T - p.t_ref) / (p.t_melt - p.t_ref);
  return 1.f - powf(fmaxf(theta, 0.f), p.m);
}

// r(d) = q - 3G d - H(eqps0 + d) (R(d / dt) thermo) and dr/dd
__device__ __forceinline__ void rr_residual(const J2Params& p, float d, float q,
                                            float eqps0, float thermo,
                                            float& r, float& dr) {
  float H, dH, R, dR;
  jc_flow(p, eqps0 + d, H, dH);
  jc_rate(p, d / p.dt, R, dR);
  const float slope = 3.f * p.G;
  r = q - slope * d - H * (R * thermo);
  dr = -slope - (dH * (R * thermo) + H * ((dR / p.dt) * thermo));
}

// Safeguarded Newton-bisection on [0, ub] with the reference's rules
// (materials/scalar_solve.py), early exit per thread, then the
// implicit-function-theorem correction.  Returns delta (0 when elastic) and
// dr/dd at the solution in *fprime.
__device__ float radial_return(const J2Params& p, float q, float eqps0,
                               float thermo, bool* active, float* fprime) {
  float r0, dr0;
  rr_residual(p, 0.f, q, eqps0, thermo, r0, dr0);
  *active = r0 > p.tol;
  if (!*active) return 0.f;
  float H0, dH0;
  jc_flow(p, eqps0, H0, dH0);
  const float lo = 0.f;
  const float hi = (q - H0 * thermo) / (3.f * p.G);
  float f_lo, f_hi, tmp;
  rr_residual(p, lo, q, eqps0, thermo, f_lo, tmp);
  rr_residual(p, hi, q, eqps0, thermo, f_hi, tmp);
  const bool swap = f_lo > 0.f;
  float xl = swap ? hi : lo;
  float xh = swap ? lo : hi;
  float x = (0.f < lo || 0.f > hi) ? 0.5f * (lo + hi) : 0.f;
  float dx = fabsf(hi - lo);
  float dxo = dx;
  float f, df;
  rr_residual(p, x, q, eqps0, thermo, f, df);
  for (int it = 0; it < p.max_iter; ++it) {
    const bool bisect = ((x - xh) * df - f > 0.f) || ((x - xl) * df - f < 0.f) ||
                        (fabsf(2.f * f) > fabsf(dxo * df));
    dxo = dx;
    if (bisect) {
      dx = 0.5f * (xh - xl);
      x = xl + dx;
    } else {
      dx = f / df;
      x = x - f / df;
    }
    rr_residual(p, x, q, eqps0, thermo, f, df);
    const bool conv = (fabsf(dx) < p.xtol) || (fabsf(f) < p.tol);
    if (f < 0.f)
      xl = x;
    else
      xh = x;
    if (conv) break;
  }
  if (fabsf(f_hi) < p.xtol) x = hi;
  if (fabsf(f_lo) < p.xtol) x = lo;
  float fv, fp;
  rr_residual(p, x, q, eqps0, thermo, fv, fp);
  *fprime = fp;
  return x - fv / fp;
}

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
  float fprime = 0.f;
  const float delta =
      radial_return(p, q, eqps, jc_thermo(p, temp), &active, &fprime);
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
                                               long long QE, const J2Mat::Point& pt) {
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

// ---- kernels ---------------------------------------------------------------

template <class Mat, class Store, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(BLOCK)
    residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                    const float* __restrict__ v_el, Tables tb,
                    const float* __restrict__ jinv, const float* __restrict__ wq,
                    float* __restrict__ out, CT* __restrict__ cout, Mat mat, float rho,
                    float mu_v, long long E) {
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  float uw[3][ND], aw[3][ND], vw[3][ND], acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      uw[c][n] = __ldg(u_el + (long long)(c * ND + n) * E + e);
      aw[c][n] = __ldg(a_el + (long long)(c * ND + n) * E + e);
      if (VISC) vw[c][n] = __ldg(v_el + (long long)(c * ND + n) * E + e);
      acc[c][n] = 0.f;
    }
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    Basis s;
    load_basis(tb, q, e, E, s);
    float ji[3][3];
    load_jinv(jinv, q, e, E, ji);
    float F[3][3], vdum[3];
    interp_grad<false>(uw, s, ji, F, vdum);
    F[0][0] += 1.f;
    F[1][1] += 1.f;
    F[2][2] += 1.f;
    const long long qe = (long long)q * E + e;
    float P[3][3];
    typename Mat::Point pt;
    mat.template eval<TANGENT>(F, qe, QE, P, pt);
    if (VISC) {
      float dV[3][3], vdum2[3];
      interp_grad<false>(vw, s, ji, dV, vdum2);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) P[c][d] += mu_v * dV[c][d];
    }
    float av[3];
    interp_value(aw, s, av);
    const float m[3] = {rho * av[0], rho * av[1], rho * av[2]};
    scatter(acc, s, ji, __ldg(wq + qe), P, m);
    if (TANGENT) Store::store(cout, qe, QE, pt);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class Store, bool VISC, typename CT>
__global__ void __launch_bounds__(BLOCK)
    matvec_kernel(const float* __restrict__ w_el, Tables tb,
                  const float* __restrict__ jinv, const float* __restrict__ wq,
                  const CT* __restrict__ cb, float* __restrict__ out, float rho,
                  float fac0, float fac1_mu_v, long long E) {
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  float ww[3][ND], acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      ww[c][n] = __ldg(w_el + (long long)(c * ND + n) * E + e);
      acc[c][n] = 0.f;
    }
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    Basis s;
    load_basis(tb, q, e, E, s);
    float ji[3][3];
    load_jinv(jinv, q, e, E, ji);
    float dF[3][3], v[3];
    interp_grad<true>(ww, s, ji, dF, v);
    const long long qe = (long long)q * E + e;
    float dP[3][3];
    Store::apply(cb, qe, QE, dF, fac0, dP);
    if (VISC) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) dP[c][d] += fac1_mu_v * dF[c][d];
    }
    const float m[3] = {rho * v[0], rho * v[1], rho * v[2]};
    scatter(acc, s, ji, __ldg(wq + qe), dP, m);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

inline unsigned grid_for(long long E) { return (unsigned)((E + BLOCK - 1) / BLOCK); }

template <class Mat, class Store, bool TANGENT, bool VISC, typename CT>
int launch_residual(const float* u_el, const float* a_el, const float* v_el,
                    const Tables& tb, const float* jinv, const float* wq, float* out,
                    void* cout, const Mat& mat, float rho, float mu_v, long long E,
                    void* stream) {
  residual_kernel<Mat, Store, TANGENT, VISC, CT>
      <<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
          u_el, a_el, v_el, tb, jinv, wq, out, static_cast<CT*>(cout), mat, rho, mu_v, E);
  return (int)cudaGetLastError();
}

template <class Store, bool VISC, typename CT>
int launch_matvec(const float* w_el, const Tables& tb, const float* jinv,
                  const float* wq, const void* cb, float* out, float rho,
                  float fac0, float fac1_mu_v, long long E, void* stream) {
  matvec_kernel<Store, VISC, CT><<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      w_el, tb, jinv, wq, static_cast<const CT*>(cb), out, rho, fac0, fac1_mu_v, E);
  return (int)cudaGetLastError();
}

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
