// A forward-mode dual number and the 3 x 3 algebra templated on the scalar,
// for sm_90a.
//
// The CUDA kernels have no automatic differentiation.  Where a tangent has
// no practical closed form (the finite-strain plasticity models of
// sweeps_sf_finite.cu: J2Simo's inverse of an inverse and cube root,
// J2Log's Hencky strain by square-root iterations and a series), the
// material is written once as `template <class T>` and run with T = Dual
// along a one-hot seed of F: the derivative parts of P are then one column
// of dP/dF, as `jax.linearize` / `torch.func.jvp` of `pk1_soa` give it.
// Comparisons and branches look at the value part only.
//
// With T = float the templates are plain float code (det3 and inv3 are
// the cofactor formulas of fem/soa.py, which the J2 kernels use).

#pragma once

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

// the value part, for comparisons and branch decisions
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const Dual& x) { return x.v; }

// ---- 3 x 3 algebra on either scalar ------------------------------------------

template <class T>
__device__ __forceinline__ T det3(const T A[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
         A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
         A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

// adjugate inverse, the same cofactor formulas as fem/soa.py inv
template <class T>
__device__ __forceinline__ void inv3(const T A[3][3], T det, T R[3][3]) {
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

// R = A B, R = A B^T, R = A^T B (sums in k order, as fem/soa.py); R must not
// alias A or B
template <class TA, class TB, class TR>
__device__ __forceinline__ void mat_nn(const TA A[3][3], const TB B[3][3], TR R[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

template <class TA, class TB, class TR>
__device__ __forceinline__ void mat_nt(const TA A[3][3], const TB B[3][3], TR R[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2];
}

template <class TA, class TB, class TR>
__device__ __forceinline__ void mat_tn(const TA A[3][3], const TB B[3][3], TR R[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j];
}

template <class T>
__device__ __forceinline__ T trace3(const T A[3][3]) {
  return A[0][0] + A[1][1] + A[2][2];
}

// R = factor dev(A): factor (A_ii - tr(A) / 3) on the diagonal, factor A_ij
// off it (fem/soa.py dev); R may alias A
template <class T>
__device__ __forceinline__ void dev3(const T A[3][3], float factor, T R[3][3]) {
  const T tr3 = trace3(A) / 3.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = i == j ? factor * (A[i][j] - tr3) : factor * A[i][j];
}

// sum_ij A_ij B_ij, row by row
template <class T>
__device__ __forceinline__ T ddot3(const T A[3][3], const T B[3][3]) {
  T s = A[0][0] * B[0][0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s = s + A[k / 3][k % 3] * B[k / 3][k % 3];
  return s;
}

template <class T>
__device__ __forceinline__ T fro_norm3(const T A[3][3]) {
  return sqrtf(ddot3(A, A));
}
