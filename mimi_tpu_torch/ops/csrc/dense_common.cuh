// Shared by the dense-table CUDA sources (sweeps_dense.cu,
// fused_neohookean.cu): sizes, staging of an element's dof values in shared
// memory, and the per-point interpolation and scatter on dense tables
// dN (27, 3, 64, E), N (27, 64, E).  One thread per element; each thread
// owns one column of the shared arrays, so no barrier is needed.

#pragma once

#include <cuda_runtime.h>

#include "materials.cuh"

namespace {

constexpr int ND = 27;  // dofs per element (p = 2)
constexpr int NQ = 64;  // quadrature points per element
constexpr int NW = 3 * ND;
constexpr int BLOCK = 64;

using rn::add;
using rn::mul;

// this thread's element dof values (3, ND, E) into its shared column
__device__ __forceinline__ void stage(const float* __restrict__ g, float (*s)[BLOCK],
                                      long long e, long long E) {
#pragma unroll 9
  for (int k = 0; k < NW; ++k) s[k][threadIdx.x] = __ldg(g + (long long)k * E + e);
}

// G[g][f] = sum_n dN[n][f](q) w[g][n], summed in n order without FMA
__device__ __forceinline__ void grad_q(const float* __restrict__ dN, float (*w)[BLOCK],
                                       long long qe, long long QE, float G[3][3]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int f = 0; f < 3; ++f) G[g][f] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[3];
#pragma unroll
    for (int f = 0; f < 3; ++f) d[f] = __ldg(dN + (long long)(n * 3 + f) * QE + qe);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float wv = w[g * ND + n][threadIdx.x];
#pragma unroll
      for (int f = 0; f < 3; ++f) G[g][f] = add(G[g][f], mul(d[f], wv));
    }
  }
}

// v[c] = sum_n N[n](q) w[c][n]
__device__ __forceinline__ void value_q(const float* __restrict__ N, float (*w)[BLOCK],
                                        long long qe, long long QE, float v[3]) {
  v[0] = v[1] = v[2] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] += Nn * w[c * ND + n][threadIdx.x];
  }
}

// acc[c][n] += wq (sum_d dN[n][d] X[c][d] + N[n] m[c]); without MASS the
// N[n] m[c] term is left out and N, m are not read
template <bool MASS = true>
__device__ __forceinline__ void scatter_q(float (&acc)[3][ND], const float* __restrict__ dN,
                                          const float* __restrict__ N, long long qe,
                                          long long QE, float wq, const float X[3][3],
                                          const float* m) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float d0 = __ldg(dN + (long long)(n * 3 + 0) * QE + qe);
    const float d1 = __ldg(dN + (long long)(n * 3 + 1) * QE + qe);
    const float d2 = __ldg(dN + (long long)(n * 3 + 2) * QE + qe);
    if (MASS) {
      const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c][n] += wq * (d0 * X[c][0] + d1 * X[c][1] + d2 * X[c][2] + Nn * m[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c][n] += wq * (d0 * X[c][0] + d1 * X[c][1] + d2 * X[c][2]);
    }
  }
}

inline unsigned grid_for(long long E) { return (unsigned)((E + BLOCK - 1) / BLOCK); }

}  // namespace
