// Small-strain J2 plasticity, shared by the sum-factorized (sweeps_sf.cu,
// through sf_common.cuh) and the dense-table (sweeps_dense_j2.cu) CUDA
// sweeps, for sm_90a: the kernel parameters, the hardening laws, the
// safeguarded radial return, and two point bodies, each with its Cauchy
// stress and closed-form algorithmic tangent at one point: J2 (nonlinear
// isotropic hardening by one of the reference's laws, j2_cauchy) and
// J2Linear (linear isotropic and kinematic hardening, a closed-form return,
// j2_linear_cauchy); then the Cauchy-decomposition tangent storage, all
// templated on the dimension DIM (2 or 3).
//
// The laws (J2Params::law, uniform across a launch like thermo_mode): the
// Johnson-Cook family, H = A + B e^n (with the rate and temperature factors
// of its subclasses); PowerLaw, H = sigma_y (1 + e / eps0)^(1/n); Voce,
// H = sigma_sat - (sigma_sat - sigma_y) exp(-e / c).  PowerLaw and Voce are
// rate- and temperature-independent.  The laws, the thermal factor, the
// scalar solve and J2's stress are formed in the plain version's operation
// order without FMA (materials/hardening.py, materials/__init__.py,
// materials/scalar_solve.py), as torch evaluates them on the card: a tensor
// divided by a Python number d is multiplied by float(1 / d), the
// reciprocal taken in double (the host passes it); a number divided by a
// tensor x is 1 / x times the number; pow(x, e) by a Python number e is
// sqrt, x x, x x x, rsqrt, 1 / x or 1 / (x x) at e = 0.5, 2, 3, -0.5, -1, -2
// (the J2Params pow modes), powf otherwise.  On dense tables, where F
// agrees with the plain version's to the bit, J2's stress, yield decision,
// float32 root and increment do too.
//
// In 2D the reference uses a true 2 x 2 tensor (materials/__init__.py J2,
// fem/soa.py dev over trace / 2), not plane strain in a 3 x 3 embedding.
// J2's algorithmic tangent
//   M = K 1(x)1 + 2G (1 - 3G d/q) I_dev + 6G^2 (d/q - 1/(3G + h')) n(x)n,
//   I_dev = I_sym - 1(x)1 / DIM, n = s / |s|, q = sqrt(3/2) |s|,
//   h' = -dr/dd - 3G at the converged increment,
// keeps its coefficients in 2D (s is traceless over trace / 2, so
// dq / d eps = sqrt(3/2) 2G n there too).  It equals the forward derivative
// of the reference implementation (including its implicit-function-theorem
// correction d = d* - r/r') and is written as tensor components C_ijkl over
// the symmetric basis sym_basis(DIM), upper triangle: 21 planes in 3D, 6 in
// 2D (ops/sweeps.py cauchy_plane_layout).  J2Linear's has the same shape
// with eta = s - beta in place of s (j2_linear_cauchy).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "materials.cuh"

// the J2-family kernel parameters (the C entry points' parameter block;
// mirrored field by field by ops/sweeps.py _J2Params).  A reciprocal
// float(1 / x) is taken on the host in double, as torch forms a tensor
// divided by a Python number on the card.
struct J2Params {
  float K, G, A, B, n, C, eps0_dot, t_ref, t_melt, m, thermo_const, tol, xtol,
      dt, rho;
  int rate_dep, thermo_mode, max_iter;
  // the hardening law (LAW_*); how torch evaluates the powers x^pw of the
  // flow stress, x^dpw of its derivative and theta^m of the thermal factor
  // (POW_*)
  int law, pow_mode, dpow_mode, m_mode;
  // pw, dpw: n and n - 1 (Johnson-Cook), 1 / n and 1 / n - 1 (PowerLaw)
  float pw, dpw;
  // PowerLaw: sigma_y, float(1 / eps0), dH = dh_coef (1 + e / eps0)^dpw;
  // Voce: sigma_sat, sat_diff = sigma_sat - sigma_y, float(1 / c),
  // dH = dv_coef exp(-e / c); J2Linear: sigma_y
  float sigma_y, inv_eps0, dh_coef, sigma_sat, sat_diff, inv_c, dv_coef;
  // float(3G) (the slope of J2's and J2Log's return), float(1 / (3G)),
  // float(1 / dt), float(1 / eps0_dot), float(1 / (t_melt - t_ref))
  float g3, inv_g3, inv_dt, inv_eps0_dot, inv_dtemp;
  // J2Linear: the isotropic and kinematic hardening moduli, sqrt(6) G and
  // float(1 / (3G + h_kin + h_iso))
  float h_iso, h_kin, sqrt6_g, inv_denom;
};

// J2Params::law
enum { LAW_JC = 0, LAW_POWER = 1, LAW_VOCE = 2 };
// J2Params::*_mode: how torch's pow(x, e) evaluates an exponent e
enum {
  POW_GENERAL = 0, POW_SQRT, POW_SQUARE, POW_CUBE, POW_RSQRT, POW_RECIP, POW_INV_SQUARE,
  POW_IDENTITY, POW_ZERO
};

namespace {

// ---- the hardening laws and the radial return ------------------------------
//
// Every operation of the return map follows the plain version's
// (materials/hardening.py, materials/__init__.py _solve_delta_eqps,
// materials/scalar_solve.py) one by one without FMA, so that with the same
// trial state the kernel finds the same float32 root, slope and increment
// as the plain version: the tangent's c2 = 6G^2 (d/q - 1/(3G + h')) then
// agrees with it even where h' is unbounded (Johnson-Cook with n < 1 at a
// point yielding from eqps 0).

// x^e as torch's pow(tensor, e) evaluates it on the card
__device__ __forceinline__ float torch_pow(int mode, float e, float x) {
  switch (mode) {
    case POW_SQRT: return sqrtf(x);
    case POW_SQUARE: return rn::mul(x, x);
    case POW_CUBE: return rn::mul(rn::mul(x, x), x);
    case POW_RSQRT: return rsqrtf(x);
    case POW_RECIP: return rn::div(1.f, x);
    case POW_INV_SQUARE: return rn::div(1.f, rn::mul(x, x));
    case POW_IDENTITY: return x;
    case POW_ZERO: return 1.f;
    default: return powf(x, e);
  }
}

// the flow stress H(e) and its derivative dH (hardening.py evaluate,
// evaluate_grad)
__device__ __forceinline__ void flow(const J2Params& p, float e, float& H, float& dH) {
  using namespace rn;
  if (p.law == LAW_POWER) {
    const float base = add(mul(e, p.inv_eps0), 1.f);  // 1.0 + eqps / eps0
    H = mul(torch_pow(p.pow_mode, p.pw, base), p.sigma_y);
    dH = mul(torch_pow(p.dpow_mode, p.dpw, base), p.dh_coef);
  } else if (p.law == LAW_VOCE) {
    const float x = expf(mul(-e, p.inv_c));  // exp(-eqps / c)
    H = sub(p.sigma_sat, mul(x, p.sat_diff));
    dH = mul(x, p.dv_coef);
  } else if (fabsf(e) < 1.0e-13f) {
    // Johnson-Cook: A for |eqps| < 1e-13 keeps 0^(n - 1) out of dH
    H = p.A;
    dH = 0.f;
  } else {
    H = add(p.A, mul(p.B, torch_pow(p.pow_mode, p.pw, e)));
    dH = mul(p.B, mul(torch_pow(p.dpow_mode, p.dpw, e), p.n));
  }
}

// the Johnson-Cook rate factor R(rate) and dR / d rate: 1 and 0 at or
// below the reference rate (logf never sees it) and for the other laws
__device__ __forceinline__ void jc_rate(const J2Params& p, float rate, float& R,
                                        float& dR) {
  using namespace rn;
  if (p.rate_dep && rate > p.eps0_dot) {
    R = add(mul(logf(mul(rate, p.inv_eps0_dot)), p.C), 1.f);
    dR = mul(div(1.f, rate), p.C);  // C / rate: torch takes the reciprocal
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
  const float theta = rn::mul(rn::sub(T, p.t_ref), p.inv_dtemp);
  return rn::sub(1.f, torch_pow(p.m_mode, p.m, fmaxf(theta, 0.f)));
}

// r(d) = q - slope d - H(eqps0 + d) (R(d / dt) thermo) and dr/dd; slope is
// 3G (J2, J2Log) or G tr(be) (J2Simo)
__device__ __forceinline__ void rr_residual(const J2Params& p, float d, float q,
                                            float eqps0, float thermo, float slope,
                                            float& r, float& dr) {
  using namespace rn;
  float H, dH, R, dR;
  flow(p, add(eqps0, d), H, dH);
  jc_rate(p, mul(d, p.inv_dt), R, dR);
  const float RT = mul(R, thermo);
  r = sub(sub(q, mul(slope, d)), mul(H, RT));
  dr = sub(-slope, add(mul(dH, RT), mul(H, mul(mul(dR, p.inv_dt), thermo))));
}

// Safeguarded Newton-bisection on [0, ub] with the reference's rules
// (materials/scalar_solve.py), at most p.max_iter trips (40: the reference's
// in-kernel cap, its fixed-trip solve under kernel_solver_mode, whose
// per-lane freezing the early exit per thread reproduces), then the
// implicit-function-theorem correction.  The yield decision r(0) > tol
// agrees with the plain version's to the bit given the same q, so a point
// at the yield surface takes the same branch in both.  host_slope: the
// plain version's slope is the number 3G (J2, J2Log; ub = (q - H thermo)
// times float(1 / (3G))), else a tensor (J2Simo; ub divides).  Returns
// delta (0 when elastic), dr/dd at the solution in *fprime and the
// uncorrected root in *dstar (both left alone when elastic).
__device__ float radial_return(const J2Params& p, float q, float eqps0, float thermo,
                               float slope, bool host_slope, bool* active, float* fprime,
                               float* dstar) {
  using namespace rn;
  float f_lo, tmp;
  rr_residual(p, 0.f, q, eqps0, thermo, slope, f_lo, tmp);
  *active = f_lo > p.tol;
  if (!*active) return 0.f;
  float H0, dH0;
  flow(p, eqps0, H0, dH0);
  const float ub = sub(q, mul(H0, thermo));
  const float lo = 0.f;
  const float hi = host_slope ? mul(ub, p.inv_g3) : div(ub, slope);
  float f_hi;
  rr_residual(p, hi, q, eqps0, thermo, slope, f_hi, tmp);
  const bool swap = f_lo > 0.f;
  float xl = swap ? hi : lo;
  float xh = swap ? lo : hi;
  float x = (0.f < lo || 0.f > hi) ? mul(add(lo, hi), 0.5f) : 0.f;
  float dx = fabsf(sub(hi, lo));
  float dxo = dx;
  float f, df;
  rr_residual(p, x, q, eqps0, thermo, slope, f, df);
  for (int it = 0; it < p.max_iter; ++it) {
    const bool bisect = (sub(mul(sub(x, xh), df), f) > 0.f) ||
                        (sub(mul(sub(x, xl), df), f) < 0.f) ||
                        (fabsf(mul(2.f, f)) > fabsf(mul(dxo, df)));
    dxo = dx;
    if (bisect) {
      dx = mul(sub(xh, xl), 0.5f);
      x = add(xl, dx);
    } else {
      dx = div(f, df);
      x = sub(x, dx);
    }
    rr_residual(p, x, q, eqps0, thermo, slope, f, df);
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
  rr_residual(p, x, q, eqps0, thermo, slope, fv, fp);
  *fprime = fp;
  *dstar = x;
  return sub(x, div(fv, fp));
}

// ---- the symmetric (Voigt) basis of DIM x DIM tensors ----------------------

// sym_basis(DIM) of ops/sweeps.py, row-major upper triangle: 3D (0,0),
// (0,1), (0,2), (1,1), (1,2), (2,2); 2D (0,0), (0,1), (1,1)
template <int DIM>
struct Voigt {
  static constexpr int NS = DIM * (DIM + 1) / 2;  // basis tensors
  static constexpr int NT = NS * (NS + 1) / 2;    // D-hat upper triangle
  __host__ __device__ static constexpr int i(int a) {
    return DIM == 3 ? (a < 3 ? 0 : a < 5 ? 1 : 2) : (a < 2 ? 0 : 1);
  }
  __host__ __device__ static constexpr int j(int a) {
    return DIM == 3 ? (a == 0 ? 0 : a == 1 || a == 3 ? 1 : 2) : (a == 0 ? 0 : 1);
  }
  // upper-triangle index of (a, b) in the NS x NS matrix, row-major
  __host__ __device__ static constexpr int tri(int a, int b) {
    return (a < b ? a : b) * NS - (a < b ? a : b) * ((a < b ? a : b) - 1) / 2 +
           ((a < b ? b : a) - (a < b ? a : b));
  }
};

// ---- the point bodies --------------------------------------------------------

// The trial state of both bodies in the operation order of
// materials/__init__.py (J2._trial_soa, J2Linear._common_soa) without FMA:
// eps = sym(F) - ps - I, p = K tr(eps), s = 2G (eps - tr(eps) / DIM I) with
// tr / DIM as torch forms it on the card (times float(1 / DIM)).  With the
// same F, s agrees with the plain version's to the bit.
template <int DIM>
__device__ __forceinline__ void j2_trial(const J2Params& p, const float F[DIM][DIM],
                                         const float ps[DIM][DIM], float s[DIM][DIM],
                                         float& pr) {
  using namespace rn;
  float eps[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = sub(mul(0.5f, add(F[i][j], F[j][i])), ps[i][j]);
      eps[i][j] = i == j ? add(x, -1.f) : x;
    }
  float tr = eps[0][0];
#pragma unroll
  for (int i = 1; i < DIM; ++i) tr = add(tr, eps[i][i]);
  pr = mul(p.K, tr);
  const float trd = mul(tr, (float)(1.0 / DIM));
  const float G2 = 2.f * p.G;  // exact
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) s[i][j] = mul(G2, i == j ? sub(eps[i][j], trd) : eps[i][j]);
}

// |A| summed row by row from 0, as fem/soa.py fro_norm
template <int DIM>
__device__ __forceinline__ float fro_norm(const float A[DIM][DIM]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) ss = rn::add(ss, rn::mul(A[i][j], A[i][j]));
  return sqrtf(ss);
}

// the NT D-hat planes K 1(x)1 + c1 I_dev + c2 sym(n (x) m), upper triangle
// over the symmetric basis: m = n for J2, m = dev(n) for J2Linear
template <int DIM>
__device__ __forceinline__ void j2_planes(float K, float c1, float c2, const float n[DIM][DIM],
                                          const float m[DIM][DIM], float Mt[Voigt<DIM>::NT]) {
  using V = Voigt<DIM>;
  int k = 0;
#pragma unroll
  for (int a = 0; a < V::NS; ++a)
#pragma unroll
    for (int b = a; b < V::NS; ++b) {
      const int i = V::i(a), j = V::j(a), kk = V::i(b), l = V::j(b);
      const float dij = i == j ? 1.f : 0.f, dkl = kk == l ? 1.f : 0.f;
      const float isym = 0.5f * ((i == kk && j == l ? 1.f : 0.f) +
                                 (i == l && j == kk ? 1.f : 0.f));
      const float idev = isym - dij * dkl / (float)DIM;
      Mt[k++] = K * dij * dkl + c1 * idev +
                c2 * (0.5f * (n[i][j] * m[kk][l] + m[i][j] * n[kk][l]));
    }
}

// J2 Cauchy stress at one point; with TANGENT also the NT D-hat planes.
// q = sqrt(3/2) |s| agrees with the plain version's to the bit given the
// same F, and with it the yield decision
template <int DIM, bool TANGENT>
__device__ __forceinline__ void j2_cauchy(const J2Params& p, const float F[DIM][DIM],
                                          const float ps[DIM][DIM], float eqps,
                                          float temp, float sig[DIM][DIM],
                                          float Mt[Voigt<DIM>::NT]) {
  float s[DIM][DIM], pr;
  j2_trial<DIM>(p, F, ps, s, pr);
  const float G2 = 2.f * p.G;
  const float snorm = fro_norm<DIM>(s);
  const float q = rn::mul(sqrtf(1.5f), snorm);
  bool active;
  float fprime = 0.f, dstar;
  const float delta =
      radial_return(p, q, eqps, jc_thermo(p, temp), p.g3, true, &active, &fprime, &dstar);
  // sigma = s - 2G delta N_p + p I, N_p = 1.5 / q s (torch takes 1 / q)
  const float npf = rn::mul(rn::div(1.f, q > 0.f ? q : 1.f), 1.5f);
  const float gd = rn::mul(delta, G2);
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = rn::sub(s[i][j], rn::mul(gd, rn::mul(npf, s[i][j])));
      sig[i][j] = i == j ? rn::add(x, pr) : x;
    }
  if (TANGENT) {
    const float G = p.G;
    float c1 = G2, c2 = 0.f;
    if (active) {
      const float h = -fprime - 3.f * G;
      c1 = G2 * (1.f - 3.f * G * delta / q);
      c2 = 6.f * G * G * (delta / q - 1.f / (3.f * G + h));
    }
    const float inv_s = snorm > 0.f ? 1.f / snorm : 0.f;
    float n[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) n[i][j] = s[i][j] * inv_s;
    j2_planes<DIM>(p.K, c1, c2, n, n, Mt);
  }
}

// J2Linear Cauchy stress at one point (materials/__init__.py
// J2Linear._common_soa, cauchy_soa): eta = s - beta, q = sqrt(3/2) |eta|,
// phi = q - (sigma_y + h_iso eqps), the increment dps = phi / (3G + h_kin +
// h_iso) where phi > 0 (the yield decision, to the bit with the plain
// version's given the same F), sigma = s - sqrt(6) G dps eta / |eta| + p I.
// With TANGENT also the NT D-hat planes, the forward derivative of that:
//   D = K 1(x)1 + 2G (1 - 3G dps/q) I_dev
//       + 6G^2 (dps/q - 1/(3G + h_kin + h_iso)) sym(n (x) dev(n)),
// n = eta / |eta|, which is K 1(x)1 + 2G I_dev on an elastic point and J2's
// shape where beta is deviatoric (dev(n) = n).
template <int DIM, bool TANGENT>
__device__ __forceinline__ void j2_linear_cauchy(const J2Params& p, const float F[DIM][DIM],
                                                 const float ps[DIM][DIM],
                                                 const float beta[DIM][DIM], float eqps,
                                                 float sig[DIM][DIM],
                                                 float Mt[Voigt<DIM>::NT]) {
  using namespace rn;
  float s[DIM][DIM], pr;
  j2_trial<DIM>(p, F, ps, s, pr);
  float n[DIM][DIM];  // eta, then eta / |eta|
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) n[i][j] = sub(s[i][j], beta[i][j]);
  const float enorm = fro_norm<DIM>(n);
  const float q = mul(sqrtf(1.5f), enorm);
  const float phi = sub(q, add(mul(eqps, p.h_iso), p.sigma_y));
  const float dps = phi > 0.f ? mul(phi, p.inv_denom) : 0.f;
  const float en = enorm > 0.f ? enorm : 1.f;
  const float c = mul(dps, p.sqrt6_g);
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      n[i][j] = div(n[i][j], en);
      const float x = sub(s[i][j], mul(c, n[i][j]));
      sig[i][j] = i == j ? add(x, pr) : x;
    }
  if (TANGENT) {
    const float G = p.G, G2 = 2.f * p.G;
    float c1 = G2, c2 = 0.f;
    if (phi > 0.f) {
      c1 = G2 * (1.f - 3.f * G * dps / q);
      c2 = 6.f * G * G * (dps / q - p.inv_denom);
    }
    float tn = n[0][0];
#pragma unroll
    for (int i = 1; i < DIM; ++i) tn += n[i][i];
    float dn[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) dn[i][j] = i == j ? n[i][j] - tn / (float)DIM : n[i][j];
    j2_planes<DIM>(p.K, c1, c2, n, dn, Mt);
  }
}

// dP = fac0 (tr(F^-1 dF) P + J (D-hat : sym dF) F^-T - P dF^T F^-T) from
// D-hat's NT upper-triangle planes M, sigma, F^-1 and J = det F: the tangent
// apply of CauchyStorage<DIM> and, on a unit dF, a column of dP/dF
template <int DIM>
__device__ __forceinline__ void cauchy_dP(const float M[Voigt<DIM>::NT],
                                          const float sig[DIM][DIM], const float fi[DIM][DIM],
                                          float J, const float dF[DIM][DIM], float fac0,
                                          float dP[DIM][DIM]) {
  using V = Voigt<DIM>;
  // d sigma = D-hat : (dF_ii, dF_ij + dF_ji), symmetric storage
  float cm[V::NS], ds[V::NS];
#pragma unroll
  for (int a = 0; a < V::NS; ++a)
    cm[a] = V::i(a) == V::j(a) ? dF[V::i(a)][V::i(a)]
                               : dF[V::i(a)][V::j(a)] + dF[V::j(a)][V::i(a)];
#pragma unroll
  for (int a = 0; a < V::NS; ++a) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < V::NS; ++b) acc += M[V::tri(a, b)] * cm[b];
    ds[a] = acc;
  }
  float dsig[DIM][DIM];
#pragma unroll
  for (int a = 0; a < V::NS; ++a) {
    dsig[V::i(a)][V::j(a)] = ds[a];
    dsig[V::j(a)][V::i(a)] = ds[a];
  }
  float P[DIM][DIM], dsf[DIM][DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        x += sig[c][k] * fi[d][k];
        y += dsig[c][k] * fi[d][k];
      }
      P[c][d] = J * x;
      dsf[c][d] = y;
    }
  float trF = 0.f;
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int k = 0; k < DIM; ++k) trF += fi[c][k] * dF[k][c];
  float A[DIM][DIM];  // A = dF^T F^-T
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) x += dF[k][a] * fi[b][k];
      A[a][b] = x;
    }
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) x += P[c][k] * A[k][d];
      dP[c][d] = fac0 * (trF * P[c][d] + J * dsf[c][d] - x);
    }
}

// ---- the Cauchy-decomposition storage -----------------------------------------

// the block of ops/sweeps.py cauchy_plane_layout(DIM): D-hat NT planes,
// sigma NS, F^-1 DIM^2, J: 21 + 6 + 9 + 1 = 37 in 3D, 6 + 3 + 4 + 1 = 14 in
// 2D.  The material's point holds Mt, sig, fi and J; `column` gives the
// same point's full dP/dF to FullStorage<DIM>.
template <int DIM>
struct CauchyStorage {
  using V = Voigt<DIM>;
  static constexpr int OFF_SIG = V::NT, OFF_FI = V::NT + V::NS;
  static constexpr int OFF_J = OFF_FI + DIM * DIM;
  static constexpr int kPlanes = OFF_J + 1;

  template <class Mat, typename CT>
  __device__ __forceinline__ static void store(CT* __restrict__ cout, long long qe,
                                               long long QE, const Mat&,
                                               const typename Mat::Point& pt) {
#pragma unroll
    for (int k = 0; k < V::NT; ++k) store_c(cout + k * QE + qe, pt.Mt[k]);
#pragma unroll
    for (int a = 0; a < V::NS; ++a)
      store_c(cout + (OFF_SIG + a) * QE + qe, pt.sig[V::i(a)][V::j(a)]);
#pragma unroll
    for (int r = 0; r < DIM; ++r)
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        store_c(cout + (OFF_FI + r * DIM + c) * QE + qe, pt.fi[r][c]);
    store_c(cout + OFF_J * QE + qe, pt.J);
  }

  // dP = fac0 (tr(F^-1 dF) P + J (D-hat : sym dF) F^-T - P dF^T F^-T)
  template <typename CT>
  __device__ __forceinline__ static void apply(const CT* __restrict__ cb, long long qe,
                                               long long QE, const float dF[DIM][DIM],
                                               float fac0, float dP[DIM][DIM]) {
    float M[V::NT];
#pragma unroll
    for (int k = 0; k < V::NT; ++k) M[k] = load_c(cb + k * QE + qe);
    float sig[DIM][DIM], fi[DIM][DIM];
#pragma unroll
    for (int a = 0; a < V::NS; ++a) {
      const float x = load_c(cb + (OFF_SIG + a) * QE + qe);
      sig[V::i(a)][V::j(a)] = x;
      sig[V::j(a)][V::i(a)] = x;
    }
#pragma unroll
    for (int r = 0; r < DIM; ++r)
#pragma unroll
      for (int c = 0; c < DIM; ++c) fi[r][c] = load_c(cb + (OFF_FI + r * DIM + c) * QE + qe);
    cauchy_dP<DIM>(M, sig, fi, load_c(cb + OFF_J * QE + qe), dF, fac0, dP);
  }

  // column b of dP/dF, C[a DIM^2 + b] = dP_a / dF_b (FullStorage<DIM>), of
  // a point of a Cauchy-decomposition material: the same map on the unit
  // direction e_b, from the point's registers instead of stored planes
  template <class Point>
  __device__ __forceinline__ static void column(const Point& pt, int b,
                                                float col[DIM * DIM]) {
    float E[DIM][DIM], dP[DIM][DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r)
#pragma unroll
      for (int c = 0; c < DIM; ++c) E[r][c] = r * DIM + c == b ? 1.f : 0.f;
    cauchy_dP<DIM>(pt.Mt, pt.sig, pt.fi, pt.J, E, 1.f, dP);
#pragma unroll
    for (int a = 0; a < DIM * DIM; ++a) col[a] = dP[a / DIM][a % DIM];
  }
};

}  // namespace
