// Dense-table quadrature sweeps of the implicit step, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch (dN (27,3,64,E),
// N (27,64,E), w det J (64,E) streamed from device memory), with the
// 45-plane symmetric tangent (c_storage="sym"):
//   mimi_residual_dense  <- make_residual_sweep (dense, inviscid)   residual only
//   mimi_assemble_dense  <- make_assemble_sweep (dense, "sym")      residual + 45 tangent planes
//   mimi_matvec_dense    <- make_matvec_sweep ("sym")              y = J w
// The plain torch versions of the same functions are in ops/sweeps.py
// (residual_dense_plain, assemble_dense_plain, matvec_dense_plain).
//
// The residual and the assemble are templated on the material (its first
// Piola stress and closed-form dP/dF as device functions, materials.cuh)
// and on the tangent storage; the matvec on the storage.  Instantiated:
// the compressible Ogden neo-Hookean and the St. Venant-Kirchhoff material
// with the symmetric storage, plane (a, b), a <= b, of tri_index_map(9)
// holding (C_ab + C_ba) / 2 with C_ab = dP_a / dF_b, a = 3 c + d.
//
// Design: one thread per element, 64 elements per block, looping over the
// element's 64 quadrature points.  The batch-last layout puts neighbouring
// elements on neighbouring addresses, so every table read and tangent
// write of a warp coalesces.  Each thread stages its element's dof values
// (81 floats per field) in its own column of shared memory, which keeps
// them out of the register file; its 81 output sums stay in registers, so
// no thread touches another's data (no barrier, no atomics).  The scatter
// reads each point's dN and N rows a second time, from L1.
//
// What bounds them on the H100: bytes.  Per call at E = 109,744 the
// residual streams dN 2.28 GB, N 0.76 GB and w det J 0.03 GB plus the
// element fields, 3.17 GB, about 0.95 ms at 3.35 TB/s; the assemble writes
// the 45 planes as well (1.26 GB, 4.43 GB in all, ~1.32 ms); the matvec
// reads the planes instead (4.40 GB, ~1.31 ms).  Per point they do a few
// hundred flops against ~450 bytes, under one flop per byte.
//
// Rounding: the deformation gradient and the stress are formed with
// single-rounding intrinsics (no fused multiply-add), in the order of the
// plain torch version's separate operations, so F and P agree with it to
// the bit (materials.cuh says why that matters near F = I).

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "materials.cuh"

namespace {

// ---- kernels ---------------------------------------------------------------

template <class Mat, class Store, bool TANGENT>
__global__ void __launch_bounds__(BLOCK)
    residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                    const float* __restrict__ dN, const float* __restrict__ N,
                    const float* __restrict__ wq, float* __restrict__ out,
                    float* __restrict__ cout, Mat mat, float rho, long long E) {
  __shared__ float su[NW][BLOCK];
  __shared__ float sa[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;  // threads share nothing: no barrier below
  stage(u_el, su, e, E);
  stage(a_el, sa, e, E);
  float acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float F[3][3];
    grad_q(dN, su, qe, QE, F);
    F[0][0] = add(F[0][0], 1.f);
    F[1][1] = add(F[1][1], 1.f);
    F[2][2] = add(F[2][2], 1.f);
    float P[3][3];
    mat.pk1(F, P);
    if (TANGENT) Store::store(cout, qe, QE, mat, mat.tangent(F));
    float av[3];
    value_q(N, sa, qe, QE, av);
    const float m[3] = {rho * av[0], rho * av[1], rho * av[2]};
    scatter_q(acc, dN, N, qe, QE, __ldg(wq + qe), P, m);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class Store>
__global__ void __launch_bounds__(BLOCK)
    matvec_kernel(const float* __restrict__ w_el, const float* __restrict__ dN,
                  const float* __restrict__ N, const float* __restrict__ wq,
                  const float* __restrict__ cs, float* __restrict__ out, float rho,
                  float fac0, long long E) {
  __shared__ float sw[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  stage(w_el, sw, e, E);
  float acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float dF[3][3], v[3];
    grad_q(dN, sw, qe, QE, dF);
    value_q(N, sw, qe, QE, v);
    float dP[3][3];
    Store::apply(cs, qe, QE, dF, fac0, dP);
    const float m[3] = {rho * v[0], rho * v[1], rho * v[2]};
    scatter_q(acc, dN, N, qe, QE, __ldg(wq + qe), dP, m);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class Mat, bool TANGENT>
int launch_residual(const float* u_el, const float* a_el, const float* dN, const float* N,
                    const float* wq, float* out, float* cout, const HyperelasticParams& p,
                    long long E, void* stream) {
  residual_kernel<Mat, SymStorage, TANGENT><<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      u_el, a_el, dN, N, wq, out, cout, Mat{p.mu, p.lam}, p.rho, E);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, symmetric storage.  `material`: 0 the neo-Hookean, 1 the
// St. Venant-Kirchhoff material.  Each returns the launch's
// cudaGetLastError().
extern "C" {

int mimi_residual_dense(const float* u_el, const float* a_el, const float* dN,
                        const float* N, const float* wq, float* out, HyperelasticParams p,
                        int material, long long E, void* stream) {
  if (E <= 0) return 0;
  if (material == 0)
    return launch_residual<NeoHookean, false>(u_el, a_el, dN, N, wq, out, nullptr, p, E, stream);
  if (material == 1)
    return launch_residual<StVK, false>(u_el, a_el, dN, N, wq, out, nullptr, p, E, stream);
  return (int)cudaErrorInvalidValue;
}

int mimi_assemble_dense(const float* u_el, const float* a_el, const float* dN,
                        const float* N, const float* wq, float* out, float* cout,
                        HyperelasticParams p, int material, long long E, void* stream) {
  if (E <= 0) return 0;
  if (material == 0)
    return launch_residual<NeoHookean, true>(u_el, a_el, dN, N, wq, out, cout, p, E, stream);
  if (material == 1)
    return launch_residual<StVK, true>(u_el, a_el, dN, N, wq, out, cout, p, E, stream);
  return (int)cudaErrorInvalidValue;
}

int mimi_matvec_dense(const float* w_el, const float* dN, const float* N, const float* wq,
                      const float* cs, float* out, float rho, float fac0, long long E,
                      void* stream) {
  if (E <= 0) return 0;
  matvec_kernel<SymStorage><<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      w_el, dN, N, wq, cs, out, rho, fac0, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
