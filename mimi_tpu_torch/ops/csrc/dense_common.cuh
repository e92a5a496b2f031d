// Shared by the dense-table CUDA sources (sweeps_dense.cu, sweeps_dense_j2.cu,
// fused_neohookean.cu), for sm_90a: the element sizes of a dimension and
// degree, staging of an element's dof values in shared memory, the
// per-point interpolation and scatter on dense tables dN (ND, DIM, NQ, E),
// N (ND, NQ, E), and the residual / assemble and matvec kernel templates
// with their launchers.  One thread per element; each thread owns one
// column of the shared arrays, so no barrier is needed.  The design notes
// are at the head of sweeps_dense.cu.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "materials.cuh"

namespace {

constexpr int BLOCK = 64;

using rn::add;
using rn::mul;

// sizes of a degree-P element in DIM dimensions: (P + 1)^DIM dofs and the
// (P + 2)^DIM Gauss points of the default order 2P + 3 (fem/space.py)
template <int DIM, int P>
struct DenseShape {
  static_assert(DIM == 2 || DIM == 3, "2D or 3D");
  static constexpr int ND = DIM == 2 ? (P + 1) * (P + 1) : (P + 1) * (P + 1) * (P + 1);
  static constexpr int NQ = DIM == 2 ? (P + 2) * (P + 2) : (P + 2) * (P + 2) * (P + 2);
  static constexpr int NW = DIM * ND;  // values per element field
};

// this thread's element dof values (DIM, ND, E) into its shared column
template <int NW>
__device__ __forceinline__ void stage(const float* __restrict__ g, float (*s)[BLOCK],
                                      long long e, long long E) {
#pragma unroll 8
  for (int k = 0; k < NW; ++k) s[k][threadIdx.x] = __ldg(g + (long long)k * E + e);
}

// G[g][f] = sum_n dN[n][f](q) w(g ND + n), summed in n order without FMA
// (as ops/sweeps.py dense_grad), so F agrees with the plain version to the
// bit; `w(k)` returns value k of the element's field
template <int DIM, int ND, class W>
__device__ __forceinline__ void grad_q_of(const float* __restrict__ dN, const W& w,
                                          long long qe, long long QE, float G[DIM][DIM]) {
#pragma unroll
  for (int g = 0; g < DIM; ++g)
#pragma unroll
    for (int f = 0; f < DIM; ++f) G[g][f] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = __ldg(dN + (long long)(n * DIM + f) * QE + qe);
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      const float wv = w(g * ND + n);
#pragma unroll
      for (int f = 0; f < DIM; ++f) G[g][f] = add(G[g][f], mul(d[f], wv));
    }
  }
}

// the gradient of the field staged in this thread's shared column
template <int DIM, int ND>
__device__ __forceinline__ void grad_q(const float* __restrict__ dN, float (*w)[BLOCK],
                                       long long qe, long long QE, float G[DIM][DIM]) {
  grad_q_of<DIM, ND>(dN, [w](int k) { return w[k][threadIdx.x]; }, qe, QE, G);
}

// v[c] = sum_n N[n](q) w[c][n]
template <int DIM, int ND>
__device__ __forceinline__ void value_q(const float* __restrict__ N, float (*w)[BLOCK],
                                        long long qe, long long QE, float v[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) v[c] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < DIM; ++c) v[c] += Nn * w[c * ND + n][threadIdx.x];
  }
}

// acc[c][n] += wq (sum_d dN[n][d] X[c][d] + N[n] m[c]); without MASS the
// N[n] m[c] term is left out and N, m are not read
template <int DIM, int ND, bool MASS = true>
__device__ __forceinline__ void scatter_q(float (&acc)[DIM][ND], const float* __restrict__ dN,
                                          const float* __restrict__ N, long long qe,
                                          long long QE, float wq, const float X[DIM][DIM],
                                          const float* m) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = __ldg(dN + (long long)(n * DIM + f) * QE + qe);
    const float Nn = MASS ? __ldg(N + (long long)n * QE + qe) : 0.f;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      float x = d[0] * X[c][0];
#pragma unroll
      for (int f = 1; f < DIM; ++f) x += d[f] * X[c][f];
      if (MASS) x += Nn * m[c];
      acc[c][n] += wq * x;
    }
  }
}

inline unsigned grid_for(long long E) { return (unsigned)((E + BLOCK - 1) / BLOCK); }

// ---- kernels ---------------------------------------------------------------

// Residual y[c][n] = sum_q wq (dN[n][d] P(F)[c][d] + N[n] rho a_q[c]),
// F = I + grad u; with TANGENT also the tangent block of `Store` (the
// assemble).  `Mat` forms P and the point's tangent data from F and, for a
// material with state, the point's state leaves (`eval`).  With VISC the
// viscous flux mu_v grad v joins P before the scatter (the tangent block
// does not change).  v is read from device memory at each point, not
// staged: a third staged field would take 62 KB of static shared memory
// at 3D p = 2, past the 48 KB a static allocation may have; its rows
// come from L1 or L2 after the first point.
template <class Mat, class Store, int DIM, int P, bool TANGENT, bool VISC>
__global__ void __launch_bounds__(BLOCK)
    dense_residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                          const float* __restrict__ v_el, const float* __restrict__ dN,
                          const float* __restrict__ N, const float* __restrict__ wq,
                          float* __restrict__ out, float* __restrict__ cout, Mat mat,
                          float rho, float mu_v, long long E) {
  using S = DenseShape<DIM, P>;
  constexpr int ND = S::ND;
  __shared__ float su[S::NW][BLOCK];
  __shared__ float sa[S::NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;  // threads share nothing: no barrier below
  stage<S::NW>(u_el, su, e, E);
  stage<S::NW>(a_el, sa, e, E);
  float acc[DIM][ND];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)S::NQ * E;
#pragma unroll 1
  for (int q = 0; q < S::NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float F[DIM][DIM];
    grad_q<DIM, ND>(dN, su, qe, QE, F);
#pragma unroll
    for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
    float Pk[DIM][DIM];
    typename Mat::Point pt;
    mat.template eval<TANGENT>(F, qe, QE, Pk, pt);
    if (TANGENT) Store::store(cout, qe, QE, mat, pt);
    if (VISC) {  // P + mu_v dV, in the plain version's order
      float dV[DIM][DIM];
      grad_q_of<DIM, ND>(dN, [=](int k) { return __ldg(v_el + (long long)k * E + e); }, qe,
                         QE, dV);
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) Pk[c][d] = add(Pk[c][d], mul(mu_v, dV[c][d]));
    }
    float av[DIM], m[DIM];
    value_q<DIM, ND>(N, sa, qe, QE, av);
#pragma unroll
    for (int c = 0; c < DIM; ++c) m[c] = rho * av[c];
    scatter_q<DIM, ND>(acc, dN, N, qe, QE, __ldg(wq + qe), Pk, m);
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

// y = J w: y[c][n] = sum_q wq (dN[n][d] dP[c][d] + N[n] rho w_q[c]),
// dP = fac0 C : grad w from the tangent block of `Store`, + fac1 mu_v grad w
// with VISC
template <class Store, int DIM, int P, bool VISC>
__global__ void __launch_bounds__(BLOCK)
    dense_matvec_kernel(const float* __restrict__ w_el, const float* __restrict__ dN,
                        const float* __restrict__ N, const float* __restrict__ wq,
                        const float* __restrict__ cs, float* __restrict__ out, float rho,
                        float fac0, float fac1_mu_v, long long E) {
  using S = DenseShape<DIM, P>;
  constexpr int ND = S::ND;
  __shared__ float sw[S::NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  stage<S::NW>(w_el, sw, e, E);
  float acc[DIM][ND];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)S::NQ * E;
#pragma unroll 1
  for (int q = 0; q < S::NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float dF[DIM][DIM], v[DIM], m[DIM];
    grad_q<DIM, ND>(dN, sw, qe, QE, dF);
    value_q<DIM, ND>(N, sw, qe, QE, v);
    float dP[DIM][DIM];
    Store::apply(cs, qe, QE, dF, fac0, dP);
    if (VISC) {
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) dP[c][d] = add(dP[c][d], mul(fac1_mu_v, dF[c][d]));
    }
#pragma unroll
    for (int c = 0; c < DIM; ++c) m[c] = rho * v[c];
    scatter_q<DIM, ND>(acc, dN, N, qe, QE, __ldg(wq + qe), dP, m);
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class Mat, class Store, int DIM, int P, bool TANGENT, bool VISC = false>
int launch_dense_residual(const float* u_el, const float* a_el, const float* dN,
                          const float* N, const float* wq, float* out, float* cout,
                          const Mat& mat, float rho, long long E, void* stream,
                          const float* v_el = nullptr, float mu_v = 0.f) {
  dense_residual_kernel<Mat, Store, DIM, P, TANGENT, VISC>
      <<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(u_el, a_el, v_el, dN, N, wq, out,
                                                         cout, mat, rho, mu_v, E);
  return (int)cudaGetLastError();
}

template <class Store, int DIM, int P, bool VISC = false>
int launch_dense_matvec(const float* w_el, const float* dN, const float* N, const float* wq,
                        const float* cs, float* out, float rho, float fac0, long long E,
                        void* stream, float fac1_mu_v = 0.f) {
  dense_matvec_kernel<Store, DIM, P, VISC><<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      w_el, dN, N, wq, cs, out, rho, fac0, fac1_mu_v, E);
  return (int)cudaGetLastError();
}

// The instantiated (dimension, degree) pairs: fn(DIM, P) as integral
// constants for (2, 2), (2, 3) and (3, 2); cudaErrorInvalidValue for any
// other pair (ops/sweeps.py refuses them before a launch).
template <class Fn>
int with_dense_shape(int dim, int p, Fn fn) {
  using std::integral_constant;
  if (dim == 2 && p == 2) return fn(integral_constant<int, 2>{}, integral_constant<int, 2>{});
  if (dim == 2 && p == 3) return fn(integral_constant<int, 2>{}, integral_constant<int, 3>{});
  if (dim == 3 && p == 2) return fn(integral_constant<int, 3>{}, integral_constant<int, 2>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace
