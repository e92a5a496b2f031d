// A forward-mode dual number and the DIM x DIM algebra (DIM 2 or 3)
// templated on the scalar, for sm_90a.
//
// The CUDA kernels have no automatic differentiation.  Where a tangent has
// no practical closed form (the finite-strain plasticity models of
// finite.cuh: J2Simo's inverse of an inverse and cube root, J2Log's Hencky
// strain by square-root iterations and a series), the material is written
// once as `template <class T>` and run with T = Dual along a one-hot seed
// of F: the derivative parts of P are then one column of dP/dF, as
// `jax.linearize` / `torch.func.jvp` of `pk1_soa` give it.  Comparisons and
// branches look at the value part only.
//
// With T = float the templates are plain float code in fem/soa.py's
// formulas: the 2 x 2 inverse divides the adjugate by det, the 3 x 3 one
// multiplies the cofactors by 1 / det; the deviator is over trace / DIM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct Dual {
  float v, d;  // value and derivative along the seed
  __host__ __device__ Dual(float value = 0.f, float deriv = 0.f) : v(value), d(deriv) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -q * b.d / b.v};
}

__device__ __forceinline__ Dual sqrtf(Dual a) {
  const float s = ::sqrtf(a.v);
  return {s, a.d / (2.f * s)};
}
__device__ __forceinline__ Dual cbrtf(Dual a) {
  const float c = ::cbrtf(a.v);
  return {c, a.d / (3.f * (c * c))};
}
__device__ __forceinline__ Dual logf(Dual a) { return {::logf(a.v), a.d / a.v}; }
__device__ __forceinline__ Dual powf(Dual a, float n) {
  return {::powf(a.v, n), n * ::powf(a.v, n - 1.f) * a.d};
}

// A float whose operations are each rounded on their own: the compiler
// contracts no product and sum of two of them into a fused multiply-add
// (the _rn intrinsics), whatever the source's -fmad.  finite.cuh runs
// J2Log's deep launch on it (RN in the float pass, DualRN in the dual
// passes), whose five square roots scale rounding by 2^6 (the plain
// version rounds every torch operation).
struct RN {
  float v;
  __host__ __device__ RN(float value = 0.f) : v(value) {}
};
__device__ __forceinline__ RN operator+(RN a, RN b) { return __fadd_rn(a.v, b.v); }
__device__ __forceinline__ RN operator-(RN a, RN b) { return __fsub_rn(a.v, b.v); }
__device__ __forceinline__ RN operator-(RN a) { return -a.v; }
__device__ __forceinline__ RN operator*(RN a, RN b) { return __fmul_rn(a.v, b.v); }
__device__ __forceinline__ RN operator/(RN a, RN b) { return __fdiv_rn(a.v, b.v); }
__device__ __forceinline__ RN operator+(RN a, float b) { return a + RN(b); }
__device__ __forceinline__ RN operator*(RN a, float b) { return a * RN(b); }
__device__ __forceinline__ RN operator-(RN a, float b) { return a - RN(b); }
__device__ __forceinline__ RN operator*(float a, RN b) { return RN(a) * b; }
__device__ __forceinline__ RN operator/(RN a, float b) { return a / RN(b); }
__device__ __forceinline__ RN operator/(float a, RN b) { return RN(a) / b; }
__device__ __forceinline__ RN sqrtf(RN a) { return ::sqrtf(a.v); }
__device__ __forceinline__ RN logf(RN a) { return ::logf(a.v); }

// Dual on RN: the same formulas as Dual's, each operation rounded on its own
struct DualRN {
  RN v, d;
  __host__ __device__ DualRN(float value = 0.f, float deriv = 0.f) : v(value), d(deriv) {}
  __host__ __device__ DualRN(RN value, RN deriv) : v(value), d(deriv) {}
  __host__ __device__ explicit DualRN(Dual x) : v(x.v), d(x.d) {}
};
__device__ __forceinline__ DualRN operator+(DualRN a, DualRN b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ DualRN operator+(DualRN a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ DualRN operator+(float a, DualRN b) { return {RN(a) + b.v, b.d}; }
__device__ __forceinline__ DualRN operator-(DualRN a, DualRN b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ DualRN operator-(DualRN a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ DualRN operator-(float a, DualRN b) { return {RN(a) - b.v, -b.d}; }
__device__ __forceinline__ DualRN operator-(DualRN a) { return {-a.v, -a.d}; }
__device__ __forceinline__ DualRN operator*(DualRN a, DualRN b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ DualRN operator*(DualRN a, float b) {
  return {a.v * RN(b), a.d * RN(b)};
}
__device__ __forceinline__ DualRN operator*(float a, DualRN b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ DualRN operator/(DualRN a, DualRN b) {
  const RN q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ DualRN operator/(DualRN a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ DualRN operator/(float a, DualRN b) {
  const RN q = a / b.v;
  return {q, -q * b.d / b.v};
}
__device__ __forceinline__ DualRN sqrtf(DualRN a) {
  const RN s = sqrtf(a.v);
  return {s, a.d / (2.f * s)};
}
__device__ __forceinline__ DualRN logf(DualRN a) { return {logf(a.v), a.d / a.v}; }

// a float or Dual on its single-rounding twin and back
template <class T>
struct Rounded {
  using type = RN;
};
template <>
struct Rounded<Dual> {
  using type = DualRN;
};
__device__ __forceinline__ RN rounded(float x) { return x; }
__device__ __forceinline__ DualRN rounded(Dual x) { return DualRN(x); }
__device__ __forceinline__ float unrounded(RN x) { return x.v; }
__device__ __forceinline__ Dual unrounded(DualRN x) { return {x.v.v, x.d.v}; }

// the value part, for comparisons and branch decisions
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const Dual& x) { return x.v; }
__device__ __forceinline__ float val(RN x) { return x.v; }
__device__ __forceinline__ float val(const DualRN& x) { return x.v.v; }

// ---- D x D algebra on either scalar (D deduced from the arrays) ---------------

namespace sm {

template <class T, int D>
__device__ __forceinline__ T det(const T A[D][D]) {
  static_assert(D == 2 || D == 3, "2 x 2 or 3 x 3");
  if constexpr (D == 2) {
    return A[0][0] * A[1][1] - A[0][1] * A[1][0];
  } else {
    return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
           A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
           A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
  }
}

// R = A^-1 given det = det(A), as fem/soa.py inv: 2 x 2 the adjugate divided
// by det, 3 x 3 the cofactors times 1 / det
template <class T, int D>
__device__ __forceinline__ void inv(const T A[D][D], T det, T R[D][D]) {
  if constexpr (D == 2) {
    R[0][0] = A[1][1] / det;
    R[0][1] = -A[0][1] / det;
    R[1][0] = -A[1][0] / det;
    R[1][1] = A[0][0] / det;
  } else {
    const T id = 1.f / det;
#define MIMI_COF(i1, j1, i2, j2) (A[i1][j1] * A[i2][j2] - A[i1][j2] * A[i2][j1])
    R[0][0] = MIMI_COF(1, 1, 2, 2) * id;
    R[0][1] = MIMI_COF(0, 2, 2, 1) * id;
    R[0][2] = MIMI_COF(0, 1, 1, 2) * id;
    R[1][0] = MIMI_COF(1, 2, 2, 0) * id;
    R[1][1] = MIMI_COF(0, 0, 2, 2) * id;
    R[1][2] = MIMI_COF(0, 2, 1, 0) * id;
    R[2][0] = MIMI_COF(1, 0, 2, 1) * id;
    R[2][1] = MIMI_COF(0, 1, 2, 0) * id;
    R[2][2] = MIMI_COF(0, 0, 1, 1) * id;
#undef MIMI_COF
  }
}

// R = A B, R = A B^T, R = A^T B (sums in k order, as fem/soa.py); R must not
// alias A or B
template <class TA, class TB, class TR, int D>
__device__ __forceinline__ void mat_nn(const TA A[D][D], const TB B[D][D], TR R[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      TR s = A[i][0] * B[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A[i][k] * B[k][j];
      R[i][j] = s;
    }
}

template <class TA, class TB, class TR, int D>
__device__ __forceinline__ void mat_nt(const TA A[D][D], const TB B[D][D], TR R[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      TR s = A[i][0] * B[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A[i][k] * B[j][k];
      R[i][j] = s;
    }
}

template <class TA, class TB, class TR, int D>
__device__ __forceinline__ void mat_tn(const TA A[D][D], const TB B[D][D], TR R[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      TR s = A[0][i] * B[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A[k][i] * B[k][j];
      R[i][j] = s;
    }
}

template <class T, int D>
__device__ __forceinline__ T trace(const T A[D][D]) {
  T s = A[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) s = s + A[i][i];
  return s;
}

// R = factor dev(A): factor (A_ii - tr(A) / D) on the diagonal, factor A_ij
// off it (fem/soa.py dev); R may alias A
template <class T, int D>
__device__ __forceinline__ void dev(const T A[D][D], float factor, T R[D][D]) {
  const T trd = trace(A) / (float)D;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) R[i][j] = i == j ? factor * (A[i][j] - trd) : factor * A[i][j];
}

// sum_ij A_ij B_ij, row by row
template <class T, int D>
__device__ __forceinline__ T ddot(const T A[D][D], const T B[D][D]) {
  T s = A[0][0] * B[0][0];
#pragma unroll
  for (int k = 1; k < D * D; ++k) s = s + A[k / D][k % D] * B[k / D][k % D];
  return s;
}

template <class T, int D>
__device__ __forceinline__ T fro_norm(const T A[D][D]) {
  return sqrtf(ddot(A, A));
}

}  // namespace sm
