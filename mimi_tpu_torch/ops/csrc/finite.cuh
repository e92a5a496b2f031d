// The finite-strain plasticity models J2Simo and J2Log at one quadrature
// point, templated on the dimension DIM (2 or 3), for sm_90a; shared by the
// sum-factorized (sweeps_sf_finite.cu, DIM = 3) and the dense-table
// (sweeps_dense_finite.cu, DIM = 2 and 3) CUDA sweeps with the full tangent
// storage (FullStorage<DIM>, materials.cuh).
//
// Each material's P(F, state) is one `template <class T>` body, the plain
// versions' (materials/__init__.py J2Simo, J2Log; materials/logm.py) step
// by step.  The residual runs it with T = float; the assemble runs it once
// in float (P, and the radial return's converged increment d*, its r'(d*)
// and whether the point yields), then DIM^2 times with T = Dual (dual.cuh),
// seeded with e_b, and writes the derivative parts as column b of
// C[a DIM^2 + b] = dP_a / dF_b.  The dual passes do not repeat the scalar
// solve: like the reference (materials/__init__.py _solve_delta_eqps) they
// apply one implicit-function-theorem correction
// delta = d* - r(d*; q, slope) / r'(d*), with q and the slope carrying
// derivatives and r' a plain float.  Branches (yielding, J2Simo's
// near-zero deviator, q > 0) follow the value; the log's series follows
// the launch and its poisoning the float pass.
// One Dual (two floats) per scalar and one pass per seed, rather than all
// DIM^2 derivatives at once: the J2Log body holds four DIM x DIM matrices
// through its square-root iterations, 72 floats as Dual in 3D and 360 as a
// nine-wide dual, against a thread's 128 registers at four blocks an SM
// (sweeps_dense_finite.cu, sf_common.cuh).
//
// In 2D the reference uses true 2 x 2 tensors, and so does this body: the
// deviator over trace / 2, J2Simo's cube root of the 2 x 2 det(f_bar), the
// log's trace prescaling by trace / 2.
//
// J2Log's Hencky strain: log C_e by trace prescaling, 2 Denman-Beavers
// square roots of 7 iterations and 8 Gregory terms (materials/logm.py).
// As in the reference (one lax.cond over the batch), one sweep decides for
// all its points: the C entry points launch the kernel with the fast
// series, any point whose series argument has ||X||_F > 0.40 sets the
// device flag logm_escalate, and a second launch with the deep series (5
// roots, 14 iterations, 12 terms) returns at once where the flag is unset
// and otherwise recomputes every point of the sweep, NaN-poisoning those
// still out of range (launch_runs, with_finite_material: no host read, no
// sync).  The dual passes take the float pass's series and its poisoning.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

#include <type_traits>

#include "dual.cuh"
#include "j2.cuh"
#include "materials.cuh"

namespace {

// the radial return at one point, from the float pass, and whether the
// float pass poisoned the point's log (J2Log, out of the series' range)
struct ReturnMap {
  bool active = false, log_bad = false;
  float dstar = 0.f, fprime = 1.f;
};

// The log series' decision of a J2Log sweep: set by a point of the fast
// launch out of the fast series' range; the deep launches that ran
__device__ unsigned logm_escalate;
__device__ unsigned long long logm_deep_launches;

// whether the scalar T is a float pass's (float, or RN in J2Log's deep
// launch) rather than a tangent pass's (Dual, DualRN)
template <class T>
constexpr bool kFloatPass = std::is_same<T, float>::value || std::is_same<T, RN>::value;

// The plastic increment.  A float pass: the safeguarded solve (j2.cuh
// radial_return), which records the point's ReturnMap.  A tangent pass:
// the implicit-function-theorem correction at the recorded root,
// d* - r(d*; q, slope) / r'(d*), zero on an elastic point.
template <class T>
__device__ __forceinline__ T plastic_increment(const J2Params& p, const T& q, const T& slope,
                                               bool host_slope, float eqps0, float thermo,
                                               ReturnMap& rm) {
  if constexpr (kFloatPass<T>) {
    return T(radial_return(p, val(q), eqps0, thermo, val(slope), host_slope, &rm.active,
                           &rm.fprime, &rm.dstar));
  } else {
    if (!rm.active) return T(0.f);
    float H, dH, R, dR;
    flow(p, rn::add(eqps0, rm.dstar), H, dH);
    jc_rate(p, rn::mul(rm.dstar, p.inv_dt), R, dR);
    const T r = q - slope * rm.dstar - H * (R * thermo);
    return rm.dstar - r / rm.fprime;
  }
}

// a DIM x DIM state leaf (DIM, DIM, NQ, E) at one point
template <int DIM>
__device__ __forceinline__ void load_leaf(const float* __restrict__ t, long long qe,
                                          long long QE, float A[DIM][DIM]) {
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) A[i][j] = __ldg(t + (i * DIM + j) * QE + qe);
}

// Denman-Beavers square root of SPD A, in place
template <class T, int DIM>
__device__ void sqrt_db(T A[DIM][DIM], int iters) {
  T Y[DIM][DIM], Z[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      Y[i][j] = A[i][j];
      Z[i][j] = T(i == j ? 1.f : 0.f);
    }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    T Yi[DIM][DIM], Zi[DIM][DIM];
    sm::inv(Y, sm::det(Y), Yi);
    sm::inv(Z, sm::det(Z), Zi);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        Y[i][j] = 0.5f * (Y[i][j] + Zi[i][j]);
        Z[i][j] = 0.5f * (Z[i][j] + Yi[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) A[i][j] = Y[i][j];
}

constexpr float kLogmXMax = 0.40f;  // materials/logm.py LOGM_X_MAX

// L = log C for SPD C (materials/logm.py _logm_core) in the fast or the
// deep configuration; whether the series argument is in range
// (||X||_F <= kLogmXMax, false for NaN too)
template <class T, int DIM>
__device__ bool logm_spd(const T C[DIM][DIM], T L[DIM][DIM], bool deep) {
  const int levels = deep ? 5 : 2, terms = deep ? 12 : 8, iters = deep ? 14 : 7;
  const T s = sm::trace(C) / (float)DIM;
  T A[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) A[i][j] = C[i][j] / s;
#pragma unroll 1
  for (int l = 0; l < levels; ++l) sqrt_db(A, iters);
  T Am[DIM][DIM], Ap[DIM][DIM], Api[DIM][DIM], X[DIM][DIM], X2[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      Am[i][j] = i == j ? A[i][j] - 1.f : A[i][j];
      Ap[i][j] = i == j ? A[i][j] + 1.f : A[i][j];
    }
  sm::inv(Ap, sm::det(Ap), Api);
  sm::mat_nn(Am, Api, X);
  sm::mat_nn(X, X, X2);
  T term[DIM][DIM], acc[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) term[i][j] = acc[i][j] = X[i][j];
#pragma unroll 1
  for (int k = 1; k < terms; ++k) {
    T t2[DIM][DIM];
    sm::mat_nn(term, X2, t2);
    const float den = 2.f * k + 1.f;
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        term[i][j] = t2[i][j];
        acc[i][j] = acc[i][j] + term[i][j] / den;
      }
  }
  const float scale = deep ? 64.f : 8.f;  // 2^(levels + 1)
  const T ls = logf(s);
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) L[i][j] = i == j ? scale * acc[i][j] + ls : scale * acc[i][j];
  return val(sm::fro_norm(X)) <= kLogmXMax;
}

// What the DIM^2 tangent passes of a point need: F and the float pass's
// return
template <int DIM>
struct FinitePoint {
  float F[DIM][DIM];
  ReturnMap rm;
};

// The float pass and the DIM^2 dual passes of a finite-strain material
// whose `pk1<T>(F, qe, QE, rm, P)` is written once for both scalars (CRTP),
// on the sweep kernels' material interface (`eval`, and `column` for
// FullStorage<DIM>).
template <class M, int DIM>
struct FiniteMat {
  static constexpr int D2 = DIM * DIM;
  // the assemble deals the DIM^2 passes of a round's points over the
  // kernel's warps (dense_common.cuh dense_slot_kernel)
  static constexpr bool kDealtTangent = true;
  using Point = FinitePoint<DIM>;
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[DIM][DIM], long long qe, long long QE,
                                       float P[DIM][DIM], Point& pt) const {
    ReturnMap rm;
    static_cast<const M*>(this)->template pk1<float>(F, qe, QE, rm, P);
    if (TANGENT) {
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int j = 0; j < DIM; ++j) pt.F[i][j] = F[i][j];
      pt.rm = rm;
    }
  }
  // column b of dP/dF: one forward-mode pass seeded with e_b, b = DIM g + f
  __device__ __forceinline__ void column(const Point& pt, long long qe, long long QE, int b,
                                         float col[D2]) const {
    Dual F[DIM][DIM], P[DIM][DIM];
#pragma unroll
    for (int k = 0; k < D2; ++k)
      F[k / DIM][k % DIM] = Dual(pt.F[k / DIM][k % DIM], k == b ? 1.f : 0.f);
    ReturnMap rm = pt.rm;
    static_cast<const M*>(this)->template pk1<Dual>(F, qe, QE, rm, P);
#pragma unroll
    for (int a = 0; a < D2; ++a) col[a] = P[a / DIM][a % DIM].d;
  }
  // a point's F and return map as kPointFloats floats p[k][lane] of shared
  // memory, and back: the assembles hand them from the float pass to the
  // tangent passes dealt over the warps (dense_common.cuh
  // dense_slot_kernel, sf_common.cuh sf_dealt_kernel)
  static constexpr int kPointFloats = D2 + 3;
  template <int W>
  __device__ __forceinline__ static void stage_point(const Point& pt, float (*p)[W], int lane) {
#pragma unroll
    for (int k = 0; k < D2; ++k) p[k][lane] = pt.F[k / DIM][k % DIM];
    p[D2][lane] = pt.rm.dstar;
    p[D2 + 1][lane] = pt.rm.fprime;
    p[D2 + 2][lane] = (float)((pt.rm.active ? 1 : 0) + (pt.rm.log_bad ? 2 : 0));
  }
  template <int W>
  __device__ __forceinline__ static Point staged_point(const float (*p)[W], int lane) {
    Point pt;
#pragma unroll
    for (int k = 0; k < D2; ++k) pt.F[k / DIM][k % DIM] = p[k][lane];
    pt.rm.dstar = p[D2][lane];
    pt.rm.fprime = p[D2 + 1][lane];
    const int flags = (int)p[D2 + 2][lane];
    pt.rm.active = flags & 1;
    pt.rm.log_bad = flags & 2;
    return pt;
  }
};

// J2Simo (materials/__init__.py J2Simo): state be_old, F_old (DIM, DIM,
// NQ, E), eqps, temperature (NQ, E).  The trial state follows the
// reference's sequence f_inv = F_old F^-1, f_bar = inv(f_inv) cbrt(det),
// be = f_bar be_old f_bar^T (the cube root in 2D too); the slope of the
// radial return is G tr(be); P = tau F^-T with
// tau = G dev(be) + K (J^2 - 1)/2 I.
template <int DIM>
struct J2SimoMat : FiniteMat<J2SimoMat<DIM>, DIM> {
  // its sum-factorized inviscid assemble keeps its tangent passes in the
  // point (sf_common.cuh sf_dealt)
  static constexpr bool kSfDealtInviscid = false;
  J2Params p;
  const float *be_old, *F_old, *eqps, *temp;

  template <class T>
  __device__ void pk1(const T F[DIM][DIM], long long qe, long long QE, ReturnMap& rm,
                      T P[DIM][DIM]) const {
    float Fo[DIM][DIM], beo[DIM][DIM];
    load_leaf<DIM>(F_old, qe, QE, Fo);
    load_leaf<DIM>(be_old, qe, QE, beo);
    const float e0 = __ldg(eqps + qe);
    const float thermo = jc_thermo(p, __ldg(temp + qe));
    T Fi[DIM][DIM], finv[DIM][DIM], fbar[DIM][DIM], tmp[DIM][DIM], be[DIM][DIM],
        s[DIM][DIM], N[DIM][DIM];
    const T J = sm::det(F);
    sm::inv(F, J, Fi);
    sm::mat_nn(Fo, Fi, finv);
    sm::inv(finv, sm::det(finv), fbar);
    const T c = cbrtf(sm::det(fbar));
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) fbar[i][j] = fbar[i][j] * c;
    sm::mat_nn(fbar, beo, tmp);
    sm::mat_nt(tmp, fbar, be);
    sm::dev(be, p.G, s);
    const T s_norm = sm::fro_norm(s);
    // the reference's jnp.finfo(float32).eps
    const bool near_zero = val(s_norm) < FLT_EPSILON;
    const T shat = sqrtf(1.5f) / (near_zero ? T(1.f) : s_norm);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        N[i][j] = near_zero ? T(i == j ? sqrtf(0.5f) : 0.f) : shat * s[i][j];
    const T q = sm::ddot(N, s);
    const T tr = sm::trace(be);
    const T delta = plastic_increment(p, q, T(p.G) * tr, false, e0, thermo, rm);
    const T coef = (2.f / 3.f) * delta * tr;
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) be[i][j] = be[i][j] - coef * N[i][j];
    sm::dev(be, p.G, s);
    const T kd = p.K * (J * J - 1.f) * 0.5f;
#pragma unroll
    for (int i = 0; i < DIM; ++i) s[i][i] = s[i][i] + kd;
    sm::mat_nt(s, Fi, P);
  }
};

// J2Log (materials/__init__.py J2Log): state Fp_inv (DIM, DIM, NQ, E),
// eqps, temperature (NQ, E).  E = log(F_e^T F_e) / 2 with F_e = F Fp_inv;
// slope 3G; P = J (s + p/J I) F^-T.  `deep`: the launch's log series (0
// fast, 1 deep, the header's note); the float pass of a point out of its
// range poisons the point's log and, in the fast launch, sets
// logm_escalate; the dual passes poison where their float pass did.  The
// deep launch runs every pass on single-rounding operations (dual.cuh RN,
// DualRN), also in the sum-factorized source, which contracts fused
// multiply-adds elsewhere: with them the deep series' rounding, scaled by
// 2^6, moved trial states past 1e-4 of the flow stress from the plain
// version's (PERF.md).
template <int DIM>
struct J2LogMat : FiniteMat<J2LogMat<DIM>, DIM> {
  static constexpr bool kSfDealtInviscid = true;  // sf_common.cuh sf_dealt
  J2Params p;
  const float *fp_inv, *eqps, *temp;
  int deep = 0;

  template <class T>
  __device__ void pk1(const T F[DIM][DIM], long long qe, long long QE, ReturnMap& rm,
                      T P[DIM][DIM]) const {
    if (!deep) return body(F, qe, QE, rm, P);
    using R = typename Rounded<T>::type;
    R Fr[DIM][DIM], Pr[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) Fr[i][j] = rounded(F[i][j]);
    body(Fr, qe, QE, rm, Pr);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) P[i][j] = unrounded(Pr[i][j]);
  }

  template <class T>
  __device__ void body(const T F[DIM][DIM], long long qe, long long QE, ReturnMap& rm,
                       T P[DIM][DIM]) const {
    float Fpi[DIM][DIM];
    load_leaf<DIM>(fp_inv, qe, QE, Fpi);
    const float e0 = __ldg(eqps + qe);
    const float thermo = jc_thermo(p, __ldg(temp + qe));
    T Fe[DIM][DIM], E[DIM][DIM], s[DIM][DIM];
    sm::mat_nn(F, Fpi, Fe);
    {
      T Ce[DIM][DIM];
      sm::mat_tn(Fe, Fe, Ce);
      const bool in_range = logm_spd(Ce, E, deep != 0);
      if constexpr (kFloatPass<T>) {
        rm.log_bad = !in_range;
        if (!in_range && !deep) atomicOr(&logm_escalate, 1u);
      }
      if (rm.log_bad) {
#pragma unroll
        for (int i = 0; i < DIM; ++i)
#pragma unroll
          for (int j = 0; j < DIM; ++j) E[i][j] = E[i][j] * NAN;
      }
    }
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) E[i][j] = 0.5f * E[i][j];
    const T pr = p.K * sm::trace(E);
    sm::dev(E, 2.f * p.G, s);
    const T q = sqrtf(1.5f) * sm::fro_norm(s);
    const T delta = plastic_increment(p, q, T(p.g3), true, e0, thermo, rm);
    // s - 2G delta N_p where the point yields; on an elastic point delta is 0
    // and the term is left out, as the plain version does: where q^2 is
    // subnormal the dual part of N_p = 1.5 s / q overflows, and 0 x inf
    // would turn the tangent NaN
    if (rm.active) {
      const T npf = 1.5f / (val(q) > 0.f ? q : T(1.f));
      const T g = (2.f * p.G) * delta;
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int j = 0; j < DIM; ++j) s[i][j] = s[i][j] - g * (npf * s[i][j]);
    }
    const T J = sm::det(F);
    const T pj = pr / J;
#pragma unroll
    for (int i = 0; i < DIM; ++i) s[i][i] = s[i][i] + pj;
    T Fi[DIM][DIM], M[DIM][DIM];
    sm::inv(F, J, Fi);
    sm::mat_nt(s, Fi, M);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) P[i][j] = J * M[i][j];
  }
};

// Whether a sweep kernel's launch with J2Log runs: the fast one always, the
// deep one where a point of the fast one left the series' range; its first
// thread counts the deep launches that run.  (materials.cuh: every other
// material's launch runs.)
template <int DIM>
__device__ __forceinline__ bool launch_runs(const J2LogMat<DIM>& m) {
  if (!m.deep) return true;
  const bool run = *(volatile const unsigned*)&logm_escalate != 0u;
  if (run && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&logm_deep_launches, 1ull);
  return run;
}

// the deep launches of J2Log's sweeps that ran, since the library was
// loaded (a device read: it waits for the device)
inline int logm_deep_count(long long* out) {
  void* ptr = nullptr;
  if (const cudaError_t err = cudaGetSymbolAddress(&ptr, logm_deep_launches)) return (int)err;
  unsigned long long n = 0;
  const cudaError_t err = cudaMemcpy(&n, ptr, sizeof n, cudaMemcpyDeviceToHost);
  *out = (long long)n;
  return (int)err;
}

// The material `material` (0 J2Simo, 1 J2Log: ops/sweeps.py FULL_KERNELS)
// with its state leaves s0..s3 in the entry points' order (J2Simo be_old,
// F_old, eqps, temperature; J2Log Fp_inv, eqps, temperature, s3 unused),
// passed to fn (which launches the sweep) as the material object: J2Log
// twice on `stream`, its fast launch after logm_escalate is cleared, then
// its deep launch (launch_runs); cudaErrorInvalidValue for another id.
template <int DIM, class Fn>
int with_finite_material(int material, const J2Params& p, const float* s0, const float* s1,
                         const float* s2, const float* s3, void* stream, Fn fn) {
  if (material == 0) {
    J2SimoMat<DIM> m;
    m.p = p;
    m.be_old = s0;
    m.F_old = s1;
    m.eqps = s2;
    m.temp = s3;
    return fn(m);
  }
  if (material == 1) {
    J2LogMat<DIM> m;
    m.p = p;
    m.fp_inv = s0;
    m.eqps = s1;
    m.temp = s2;
    void* flag = nullptr;
    if (const cudaError_t err = cudaGetSymbolAddress(&flag, logm_escalate)) return (int)err;
    if (const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(unsigned), (cudaStream_t)stream))
      return (int)err;
    if (const int err = fn(m)) return err;
    m.deep = 1;
    return fn(m);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
