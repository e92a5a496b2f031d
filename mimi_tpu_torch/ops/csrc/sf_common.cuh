// The sum-factorized sweep kernels shared by sweeps_sf.cu (J2 with the
// Cauchy storage, the hyperelastic materials with the symmetric storage)
// and sweeps_sf_finite.cu (J2Simo and J2Log with the full storage), for
// sm_90a: the 1D basis tables, interpolation and scatter of one element's
// fields at one point (the J2 return maps are in j2.cuh, the
// storages in materials.cuh), and the residual / matvec kernel templates
// with their launchers.  Each source instantiates what it needs; the design
// notes are at the head of sweeps_sf.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "j2.cuh"
#include "materials.cuh"

namespace {

constexpr int NG = 4;   // Gauss points per axis
constexpr int P1 = 3;   // p + 1
constexpr int NQ = NG * NG * NG;
constexpr int ND = P1 * P1 * P1;
constexpr int BLOCK = 128;

}  // namespace

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
    if constexpr (TANGENT) Store::store(cout, qe, QE, mat, pt);
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

}  // namespace
