// Small-strain J2 plasticity with Johnson-Cook hardening, shared by the
// sum-factorized (sweeps_sf.cu, through sf_common.cuh) and the dense-table
// (sweeps_dense_j2.cu) CUDA sweeps, for sm_90a: the kernel parameters, the
// hardening law, the safeguarded radial return, the Cauchy stress and its
// closed-form algorithmic tangent at one point, and the Cauchy-decomposition
// tangent storage, all templated on the dimension DIM (2 or 3).
//
// In 2D the reference uses a true 2 x 2 tensor (materials/__init__.py J2,
// fem/soa.py dev over trace / 2), not plane strain in a 3 x 3 embedding.
// The algorithmic tangent
//   M = K 1(x)1 + 2G (1 - 3G d/q) I_dev + 6G^2 (d/q - 1/(3G + h')) n(x)n,
//   I_dev = I_sym - 1(x)1 / DIM, n = s / |s|, q = sqrt(3/2) |s|,
//   h' = -dr/dd - 3G at the converged increment,
// keeps its coefficients in 2D (s is traceless over trace / 2, so
// dq / d eps = sqrt(3/2) 2G n there too).  It equals the forward derivative
// of the reference implementation (including its implicit-function-theorem
// correction d = d* - r/r') and is written as tensor components C_ijkl over
// the symmetric basis sym_basis(DIM), upper triangle: 21 planes in 3D, 6 in
// 2D (ops/sweeps.py cauchy_plane_layout).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "materials.cuh"

// the J2-family kernel parameters (the C entry points' parameter block;
// mirrored by ops/sweeps.py _J2Params)
struct J2Params {
  float K, G, A, B, n, C, eps0_dot, t_ref, t_melt, m, thermo_const, tol, xtol,
      dt, rho;
  int rate_dep, thermo_mode, max_iter;
};


namespace {

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

// r(d) = q - slope d - H(eqps0 + d) (R(d / dt) thermo) and dr/dd; slope is
// 3G (J2, J2Log) or G tr(be) (J2Simo)
__device__ __forceinline__ void rr_residual(const J2Params& p, float d, float q,
                                            float eqps0, float thermo, float slope,
                                            float& r, float& dr) {
  float H, dH, R, dR;
  jc_flow(p, eqps0 + d, H, dH);
  jc_rate(p, d / p.dt, R, dR);
  r = q - slope * d - H * (R * thermo);
  dr = -slope - (dH * (R * thermo) + H * ((dR / p.dt) * thermo));
}

// r(0) = q - H(eqps0) thermo in the plain version's operation order without
// FMA (materials/hardening.py: A + B eqps0^n; the rate contribution at rate
// 0 is 1), so that the yield decision r(0) > tol agrees with it to the bit
// given the same q: a point at the yield surface then takes the same branch
// in both, and the tangent planes can be held point by point
__device__ __forceinline__ float trial_residual(const J2Params& p, float q, float eqps0,
                                                float thermo) {
  const float H =
      fabsf(eqps0) < 1.0e-13f ? p.A : __fadd_rn(p.A, __fmul_rn(p.B, powf(eqps0, p.n)));
  return __fsub_rn(q, __fmul_rn(H, thermo));
}

// Safeguarded Newton-bisection on [0, ub] with the reference's rules
// (materials/scalar_solve.py), early exit per thread, then the
// implicit-function-theorem correction.  Returns delta (0 when elastic),
// dr/dd at the solution in *fprime and the uncorrected root in *dstar
// (both left alone when elastic).
__device__ float radial_return(const J2Params& p, float q, float eqps0,
                               float thermo, float slope, bool* active,
                               float* fprime, float* dstar) {
  *active = trial_residual(p, q, eqps0, thermo) > p.tol;
  if (!*active) return 0.f;
  float H0, dH0;
  jc_flow(p, eqps0, H0, dH0);
  const float lo = 0.f;
  const float hi = (q - H0 * thermo) / slope;
  float f_lo, f_hi, tmp;
  rr_residual(p, lo, q, eqps0, thermo, slope, f_lo, tmp);
  rr_residual(p, hi, q, eqps0, thermo, slope, f_hi, tmp);
  const bool swap = f_lo > 0.f;
  float xl = swap ? hi : lo;
  float xh = swap ? lo : hi;
  float x = (0.f < lo || 0.f > hi) ? 0.5f * (lo + hi) : 0.f;
  float dx = fabsf(hi - lo);
  float dxo = dx;
  float f, df;
  rr_residual(p, x, q, eqps0, thermo, slope, f, df);
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
  return x - fv / fp;
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

// ---- the J2 point body -------------------------------------------------------

// J2 Cauchy stress at one point; with TANGENT also the NT D-hat planes
template <int DIM, bool TANGENT>
__device__ __forceinline__ void j2_cauchy(const J2Params& p, const float F[DIM][DIM],
                                          const float ps[DIM][DIM], float eqps,
                                          float temp, float sig[DIM][DIM],
                                          float Mt[Voigt<DIM>::NT]) {
  using V = Voigt<DIM>;
  using namespace rn;
  // the trial state in the operation order of materials/__init__.py
  // J2._trial_soa without FMA (eps = sym(F) - ps - I, the deviator over
  // trace / DIM, q = sqrt(3/2) |s|): with the same F, q agrees with the
  // plain version's to the bit, and with it the yield decision
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
  const float pr = mul(p.K, tr);
  const float trd = div(tr, (float)DIM);
  const float G2 = 2.f * p.G;  // exact
  float s[DIM][DIM];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      s[i][j] = mul(G2, i == j ? sub(eps[i][j], trd) : eps[i][j]);
      ss = add(ss, mul(s[i][j], s[i][j]));
    }
  const float snorm = sqrtf(ss);
  const float q = mul(sqrtf(1.5f), snorm);
  bool active;
  float fprime = 0.f, dstar;
  const float delta =
      radial_return(p, q, eqps, jc_thermo(p, temp), 3.f * p.G, &active, &fprime, &dstar);
  const float npf = 1.5f / (q > 0.f ? q : 1.f);
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j)
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
        Mt[k++] = p.K * dij * dkl + c1 * idev +
                  c2 * (s[i][j] * inv_s) * (s[kk][l] * inv_s);
      }
  }
}

// ---- the Cauchy-decomposition storage -----------------------------------------

// the block of ops/sweeps.py cauchy_plane_layout(DIM): D-hat NT planes,
// sigma NS, F^-1 DIM^2, J: 21 + 6 + 9 + 1 = 37 in 3D, 6 + 3 + 4 + 1 = 14 in
// 2D.  The material's point holds Mt, sig, fi and J.
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
    const float J = load_c(cb + OFF_J * QE + qe);
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
};

}  // namespace
