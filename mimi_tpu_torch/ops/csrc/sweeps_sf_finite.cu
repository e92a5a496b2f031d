// Sum-factorized sweeps of the finite-strain plasticity models J2Simo and
// J2Log with the 81-plane full tangent, for sm_90a.
//
// Replaces the `full` branch of three Pallas TPU kernels of
// mimi_tpu/ops/sweeps.py on the sum-factorized tables:
//   residual_kernel<J2SimoMat | J2LogMat, FullStorage, false, ..>  <- make_residual_sweep (sf_mode)
//   residual_kernel<J2SimoMat | J2LogMat, FullStorage, true, ..>   <- make_assemble_sweep (sf, full, :620-648)
//   matvec_kernel<FullStorage, false, float>                       <- make_matvec_sweep_sf (full, :820-836)
// C entry points mimi_residual_sf_finite, mimi_assemble_sf_finite
// (`material`: 0 J2Simo, 1 J2Log) and mimi_matvec_sf_full; inviscid, the
// block in float32.  The kernel templates, the radial return and
// FullStorage are in sf_common.cuh; the plain torch versions of the same
// functions in ops/sweeps.py (full_tangent_planes, tangent_apply_full).
//
// The tangent.  The reference forms the 81 planes as jax.linearize of
// pk1_soa along 9 one-hot seeds of F.  Here each material's P(F, state) is
// one `template <class T>` body: the residual runs it with T = float; the
// assemble runs it once in float (P, and the radial return's converged
// increment d*, its r'(d*) and whether the point yields), then 9 times with
// T = Dual (dual.cuh), seeded with e_b, and writes the derivative parts as
// column b of C[a*9 + b] = dP_a / dF_b.  The dual passes do not repeat the
// scalar solve: like the reference (materials/__init__.py
// _solve_delta_eqps) they apply one implicit-function-theorem correction
// delta = d* - r(d*; q, slope) / r'(d*), with q and the slope carrying
// derivatives and r' a plain float.  Branches (yielding, J2Simo's
// near-zero deviator, q > 0, the log's range escalation) follow the value.
// One Dual (two floats) per scalar and one pass per seed, rather than nine
// derivatives at once: the J2Log body holds four 3 x 3 matrices through its
// square-root iterations, 72 floats as Dual and 360 as a nine-wide dual,
// and the kernel already sits at 255 registers with spills (PERF.md).
//
// J2Log's Hencky strain: log C_e by trace prescaling, 2 Denman-Beavers
// square roots of 7 iterations and 8 Gregory terms (materials/logm.py);
// a point whose series argument has ||X||_F > 0.40 is recomputed with 5
// roots, 14 iterations and 12 terms, and NaN-poisoned if it is still out
// of range.  The reference decides this per batch (one lax.cond: every
// point of a batch with one bad point takes the deep series); the kernel
// decides per point, so an in-range point of such a batch keeps the fast
// series here.  The two differ by the deep series' float32 rounding, which
// its five square roots scale by 2^6 in log C (chip_smoke.py phase 23
// holds them to 1e-3 of scale there).
//
// What bounds them on the H100: the matvec streams the 81-plane block
// (20.7 KB per element, 2.29 GB at 48^3) plus jinv once per GMRES
// iteration, bandwidth bound (~0.8 ms at 3.35 TB/s).  The assemble writes
// the same 2.29 GB and runs the material 10 times per point (float + 9
// dual passes; J2Log's ~50 3 x 3 inverses and products per pass), so it
// may turn compute bound; plastic points add the radial return's capped
// 100 trips once, in the float pass.

#include <float.h>

#include <type_traits>

#include "sf_common.cuh"

namespace {

// the radial return at one point, from the float pass
struct ReturnMap {
  bool active = false;
  float dstar = 0.f, fprime = 1.f;
};

// The plastic increment.  float: the safeguarded solve (sf_common.cuh
// radial_return), which records the point's ReturnMap.  Dual: the
// implicit-function-theorem correction at the recorded root,
// d* - r(d*; q, slope) / r'(d*), zero on an elastic point.
template <class T>
__device__ __forceinline__ T plastic_increment(const J2Params& p, const T& q, const T& slope,
                                               float eqps0, float thermo, ReturnMap& rm) {
  if constexpr (std::is_same<T, float>::value) {
    return radial_return(p, q, eqps0, thermo, slope, &rm.active, &rm.fprime, &rm.dstar);
  } else {
    if (!rm.active) return T(0.f);
    float H, dH, R, dR;
    jc_flow(p, eqps0 + rm.dstar, H, dH);
    jc_rate(p, rm.dstar / p.dt, R, dR);
    const T r = q - slope * rm.dstar - H * (R * thermo);
    return rm.dstar - r / rm.fprime;
  }
}

__device__ __forceinline__ void load9(const float* __restrict__ t, long long qe, long long QE,
                                      float A[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = __ldg(t + (i * 3 + j) * QE + qe);
}

// Denman-Beavers square root of SPD A, in place
template <class T>
__device__ void sqrt_db(T A[3][3], int iters) {
  T Y[3][3], Z[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Y[i][j] = A[i][j];
      Z[i][j] = T(i == j ? 1.f : 0.f);
    }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    T Yi[3][3], Zi[3][3];
    inv3(Y, det3(Y), Yi);
    inv3(Z, det3(Z), Zi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Y[i][j] = 0.5f * (Y[i][j] + Zi[i][j]);
        Z[i][j] = 0.5f * (Z[i][j] + Yi[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = Y[i][j];
}

constexpr float kLogmXMax = 0.40f;  // materials/logm.py LOGM_X_MAX

// L = log C for SPD C (materials/logm.py _logm_core): the fast
// configuration, the deep one where the series argument is out of range,
// NaN beyond that
template <class T>
__device__ void logm_spd(const T C[3][3], T L[3][3]) {
#pragma unroll 1
  for (int deep = 0; deep < 2; ++deep) {
    const int levels = deep ? 5 : 2, terms = deep ? 12 : 8, iters = deep ? 14 : 7;
    const T s = trace3(C) / 3.f;
    T A[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = C[i][j] / s;
#pragma unroll 1
    for (int l = 0; l < levels; ++l) sqrt_db(A, iters);
    T Am[3][3], Ap[3][3], Api[3][3], X[3][3], X2[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Am[i][j] = i == j ? A[i][j] - 1.f : A[i][j];
        Ap[i][j] = i == j ? A[i][j] + 1.f : A[i][j];
      }
    inv3(Ap, det3(Ap), Api);
    mat_nn(Am, Api, X);
    mat_nn(X, X, X2);
    T term[3][3], acc[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) term[i][j] = acc[i][j] = X[i][j];
#pragma unroll 1
    for (int k = 1; k < terms; ++k) {
      T t2[3][3];
      mat_nn(term, X2, t2);
      const float den = 2.f * k + 1.f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          term[i][j] = t2[i][j];
          acc[i][j] = acc[i][j] + term[i][j] / den;
        }
    }
    const float scale = deep ? 64.f : 8.f;  // 2^(levels + 1)
    const T ls = logf(s);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) L[i][j] = i == j ? scale * acc[i][j] + ls : scale * acc[i][j];
    if (val(fro_norm3(X)) <= kLogmXMax) return;  // false for NaN too
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) L[i][j] = L[i][j] * NAN;
}

// What the 9 tangent passes of a point need: F and the float pass's return
struct FinitePoint {
  float F[3][3];
  ReturnMap rm;
};

// The float pass and the 9 dual passes of a finite-strain material whose
// `pk1<T>(F, qe, QE, rm, P)` is written once for both scalars (CRTP).
template <class M>
struct FiniteMat {
  using Point = FinitePoint;
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[3][3], long long qe, long long QE,
                                       float P[3][3], Point& pt) const {
    ReturnMap rm;
    static_cast<const M*>(this)->template pk1<float>(F, qe, QE, rm, P);
    if (TANGENT) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) pt.F[i][j] = F[i][j];
      pt.rm = rm;
    }
  }
  // column b of dP/dF: one forward-mode pass seeded with e_b, b = 3g + f
  __device__ __forceinline__ void column(const Point& pt, long long qe, long long QE, int b,
                                         float col[9]) const {
    Dual F[3][3], P[3][3];
#pragma unroll
    for (int k = 0; k < 9; ++k) F[k / 3][k % 3] = Dual(pt.F[k / 3][k % 3], k == b ? 1.f : 0.f);
    ReturnMap rm = pt.rm;
    static_cast<const M*>(this)->template pk1<Dual>(F, qe, QE, rm, P);
#pragma unroll
    for (int a = 0; a < 9; ++a) col[a] = P[a / 3][a % 3].d;
  }
};

// J2Simo (materials/__init__.py J2Simo): state be_old, F_old, eqps,
// temperature.  The trial state follows the reference's sequence
// f_inv = F_old F^-1, f_bar = inv(f_inv) cbrt(det), be = f_bar be_old f_bar^T;
// the slope of the radial return is G tr(be); P = tau F^-T with
// tau = G dev(be) + K (J^2 - 1)/2 I.
struct J2SimoMat : FiniteMat<J2SimoMat> {
  J2Params p;
  const float *be_old, *F_old, *eqps, *temp;

  template <class T>
  __device__ void pk1(const T F[3][3], long long qe, long long QE, ReturnMap& rm,
                      T P[3][3]) const {
    float Fo[3][3], beo[3][3];
    load9(F_old, qe, QE, Fo);
    load9(be_old, qe, QE, beo);
    const float e0 = __ldg(eqps + qe);
    const float thermo = jc_thermo(p, __ldg(temp + qe));
    T Fi[3][3], finv[3][3], fbar[3][3], tmp[3][3], be[3][3], s[3][3], N[3][3];
    const T J = det3(F);
    inv3(F, J, Fi);
    mat_nn(Fo, Fi, finv);
    inv3(finv, det3(finv), fbar);
    const T c = cbrtf(det3(fbar));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) fbar[i][j] = fbar[i][j] * c;
    mat_nn(fbar, beo, tmp);
    mat_nt(tmp, fbar, be);
    dev3(be, p.G, s);
    const T s_norm = fro_norm3(s);
    // the reference's jnp.finfo(float32).eps
    const bool near_zero = val(s_norm) < FLT_EPSILON;
    const T shat = sqrtf(1.5f) / (near_zero ? T(1.f) : s_norm);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        N[i][j] = near_zero ? T(i == j ? sqrtf(0.5f) : 0.f) : shat * s[i][j];
    const T q = ddot3(N, s);
    const T tr = trace3(be);
    const T delta = plastic_increment(p, q, T(p.G) * tr, e0, thermo, rm);
    const T coef = (2.f / 3.f) * delta * tr;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) be[i][j] = be[i][j] - coef * N[i][j];
    dev3(be, p.G, s);
    const T kd = p.K * (J * J - 1.f) * 0.5f;
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i][i] = s[i][i] + kd;
    mat_nt(s, Fi, P);
  }
};

// J2Log (materials/__init__.py J2Log): state Fp_inv, eqps, temperature.
// E = log(F_e^T F_e) / 2 with F_e = F Fp_inv; slope 3G;
// P = J (s + p/J I) F^-T.
struct J2LogMat : FiniteMat<J2LogMat> {
  J2Params p;
  const float *fp_inv, *eqps, *temp;

  template <class T>
  __device__ void pk1(const T F[3][3], long long qe, long long QE, ReturnMap& rm,
                      T P[3][3]) const {
    float Fpi[3][3];
    load9(fp_inv, qe, QE, Fpi);
    const float e0 = __ldg(eqps + qe);
    const float thermo = jc_thermo(p, __ldg(temp + qe));
    T Fe[3][3], E[3][3], s[3][3];
    mat_nn(F, Fpi, Fe);
    {
      T Ce[3][3];
      mat_tn(Fe, Fe, Ce);
      logm_spd(Ce, E);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) E[i][j] = 0.5f * E[i][j];
    const T pr = p.K * trace3(E);
    dev3(E, 2.f * p.G, s);
    const T q = sqrtf(1.5f) * fro_norm3(s);
    const T delta = plastic_increment(p, q, T(3.f * p.G), e0, thermo, rm);
    const T npf = 1.5f / (val(q) > 0.f ? q : T(1.f));
    const T g = (2.f * p.G) * delta;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s[i][j] = s[i][j] - g * (npf * s[i][j]);
    const T J = det3(F);
    const T pj = pr / J;
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i][i] = s[i][i] + pj;
    T Fi[3][3], M[3][3];
    inv3(F, J, Fi);
    mat_nt(s, Fi, M);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = J * M[i][j];
  }
};

template <bool TANGENT>
int launch_finite_material(const float* u_el, const float* a_el, const Tables& tb,
                           const float* jinv, const float* wq, const float* s0,
                           const float* s1, const float* s2, const float* s3, float* out,
                           float* cout, const J2Params& p, int material, long long E,
                           void* stream) {
  if (material == 0) {
    J2SimoMat m;
    m.p = p;
    m.be_old = s0;
    m.F_old = s1;
    m.eqps = s2;
    m.temp = s3;
    return launch_residual<J2SimoMat, FullStorage, TANGENT, false, float>(
        u_el, a_el, nullptr, tb, jinv, wq, out, cout, m, p.rho, 0.f, E, stream);
  }
  if (material == 1) {
    J2LogMat m;
    m.p = p;
    m.fp_inv = s0;
    m.eqps = s1;
    m.temp = s2;
    return launch_residual<J2LogMat, FullStorage, TANGENT, false, float>(
        u_el, a_el, nullptr, tb, jinv, wq, out, cout, m, p.rho, 0.f, E, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points; each returns the launch's cudaGetLastError().  The state
// leaves s0..s3 in the order of ops/sweeps.py FULL_KERNELS: J2Simo be_old,
// F_old, eqps, temperature; J2Log Fp_inv, eqps, temperature (s3 unused).
extern "C" {

int mimi_residual_sf_finite(const float* u_el, const float* a_el, const float* b0,
                            const float* d0, const float* b1, const float* d1,
                            const float* b2, const float* d2, const float* jinv,
                            const float* wq, const float* s0, const float* s1,
                            const float* s2, const float* s3, float* out, J2Params p,
                            int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<false>(u_el, a_el, tb, jinv, wq, s0, s1, s2, s3, out, nullptr,
                                       p, material, E, stream);
}

int mimi_assemble_sf_finite(const float* u_el, const float* a_el, const float* b0,
                            const float* d0, const float* b1, const float* d1,
                            const float* b2, const float* d2, const float* jinv,
                            const float* wq, const float* s0, const float* s1,
                            const float* s2, const float* s3, float* out, float* cout,
                            J2Params p, int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<true>(u_el, a_el, tb, jinv, wq, s0, s1, s2, s3, out, cout, p,
                                      material, E, stream);
}

int mimi_matvec_sf_full(const float* w_el, const float* b0, const float* d0,
                        const float* b1, const float* d1, const float* b2,
                        const float* d2, const float* jinv, const float* wq,
                        const float* cf, float* out, float rho, float fac0, long long E,
                        void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_matvec<FullStorage, false, float>(w_el, tb, jinv, wq, cf, out, rho, fac0, 0.f,
                                                  E, stream);
}

}  // extern "C"
