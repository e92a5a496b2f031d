// The sum-factorized sweep kernels shared by sweeps_sf.cu (J2 and J2Linear
// with the Cauchy storage), sweeps_sf_hyper.cu (the hyperelastic materials
// with the symmetric storage) and sweeps_sf_finite.cu (J2Simo and J2Log
// with the full storage), for sm_90a: the 1D basis tables, interpolation
// and scatter of one element's fields at one point (the J2 return maps are
// in j2.cuh, the storages in materials.cuh), and the residual / matvec
// kernel templates with their launchers, all templated on the element's
// shape SfShape<P1, NG> (P1 = p + 1 nodes and NG Gauss points per axis).
// Each source instantiates what it needs at one shape: the three sources
// at p = 2 (SfShape<3, 4>), their _p3 twins (sweeps_sf_p3.cu and the
// like, which define MIMI_SF_P1 / MIMI_SF_NG and include them) at p = 3
// (SfShape<4, 5>), with the suffix _p3 on their C entry points.
//
// residual_kernel (residual, and with TANGENT the tangent planes) maps one
// thread to an (element, point slot): a block takes a tile of TILE = 32
// consecutive elements, one per lane, and SLOTS = 4 warps, warp s taking
// the points q = s (mod SLOTS) of every element in the tile.  The tile's
// element fields (u, a and, viscous, v: (3, ND) values each) are staged
// once in shared memory as [3 ND][TILE], so a lane reads its own column
// without bank conflicts, and every batch-last read and write at
// qe = q E + e (tables, jinv, w det J, state, tangent planes) is one
// 128-byte line per warp.  The NQ points run in NQ / SLOTS rounds: each
// warp forms its point's F from shared memory (interp_grad, the operations
// of the one-thread-per-element kernel it replaced, so F and every yield
// decision round as before), runs the material, stores the planes, and
// hands its 1D basis values and its flux (Z = jinv w det J P, w det J rho
// a) to shared memory; after a barrier each thread adds the round's SLOTS
// points, in q order, to the outputs of the nodes n = s + SLOTS j it owns,
// all three components (the transpose of the scatter): the reduction is
// deterministic and uses no atomics; a thread holds 21 accumulators at
// p = 2 (48 at p = 3) instead of 81 (192).  The outputs are written
// coalesced at the end.  Shared memory (dynamic, launch.cuh): 36.2 KB a
// block, 46.5 KB viscous at p = 2; 67.7 KB and 92.2 KB at p = 3, so 3 and
// 2 blocks fit an SM there (SfShape::MIN_BLOCKS).  Design notes and what
// bounds the kernels: the head of sweeps_sf.cu.
//
// matvec_kernel is one thread per element, looping over its NQ points
// with the element's w and its 3 ND accumulators in registers (at p = 3
// 384 values: they spill to local memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "j2.cuh"
#include "launch.cuh"
#include "materials.cuh"

namespace {

constexpr int BLOCK = 128;  // matvec_kernel: elements per block

// residual_kernel: elements per block (a warp's lanes) and point slots
// (one warp each)
constexpr int TILE = 32;
constexpr int SLOTS = 4;

// The element of one shape: P1 = p + 1 nodes and NG Gauss points per axis.
// What a residual_kernel thread sums (OWN outputs of OWN_NODES nodes), what
// one point hands to the reduction per lane (its 1D basis values b[ax][a],
// d[ax][a] at ST_B, ST_D, its flux Z[c][a] at ST_Z, its mass term mm[c] at
// ST_M), and the blocks of 128 threads an SM must hold (__launch_bounds__),
// which cap a thread's registers at 65536 / (MIN_BLOCKS * 128): at p = 2 4
// (128 registers; 4 tiles of 36.2 or 46.5 KB fit the SM's 228 KB), at
// p = 3 3 inviscid (170 registers, 3 x 67.7 KB) and 2 viscous (255,
// 2 x 92.2 KB).
template <int P1_, int NG_>
struct SfShape {
  static constexpr int P1 = P1_, NG = NG_;
  static constexpr int NQ = NG * NG * NG;
  static constexpr int ND = P1 * P1 * P1;
  static constexpr int NV = 3 * ND;  // values of a vector field on one element
  static constexpr int OWN_NODES = (ND + SLOTS - 1) / SLOTS;
  static constexpr int OWN = 3 * OWN_NODES;
  static constexpr int ST_B = 0, ST_D = 3 * P1, ST_Z = 6 * P1, ST_M = ST_Z + 9;
  static constexpr int NSTAGE = ST_M + 3;
  static constexpr int MIN_BLOCKS = P1 <= 3 ? 4 : 3, MIN_BLOCKS_VISC = P1 <= 3 ? 4 : 2;
};

}  // namespace

// The shape this translation unit instantiates: p = 2 unless the source
// defines MIMI_SF_P1 and MIMI_SF_NG before including this header (the _p3
// sources), and the name of its C entry points (MIMI_SF_ENTRY: the _p3
// sources append _p3)
#ifndef MIMI_SF_P1
#define MIMI_SF_P1 3
#define MIMI_SF_NG 4
#define MIMI_SF_ENTRY(name) name
#endif

struct Tables {
  const float* t[6];  // B0, D0, B1, D1, B2, D2, each (NG, P1, E)
};

namespace {

using Sf = SfShape<MIMI_SF_P1, MIMI_SF_NG>;

template <class S>
struct Basis {
  float b[3][S::P1];
  float d[3][S::P1];
};

template <class S>
__device__ __forceinline__ void load_basis(const Tables& tb, int q, long long e,
                                           long long E, Basis<S>& s) {
  const int qs[3] = {q % S::NG, (q / S::NG) % S::NG, q / (S::NG * S::NG)};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int a = 0; a < S::P1; ++a) {
      const long long off = (long long)(qs[ax] * S::P1 + a) * E + e;
      s.b[ax][a] = __ldg(tb.t[2 * ax] + off);
      s.d[ax][a] = __ldg(tb.t[2 * ax + 1] + off);
    }
  }
}

template <class S>
__device__ __forceinline__ void load_jinv(const float* __restrict__ jinv, int q,
                                          long long e, long long E,
                                          float ji[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int f = 0; f < 3; ++f)
      ji[a][f] = __ldg(jinv + ((long long)(a * 3 + f) * S::NQ + q) * E + e);
}

// physical gradient g[c][f] and (optionally) values v[c] of a field at one
// point; `w(c, n)` returns the element's value n of component c
template <bool VALUES, class S, class W>
__device__ __forceinline__ void interp_grad(const W& w, const Basis<S>& s, const float ji[3][3],
                                            float g[3][3], float v[3]) {
  constexpr int P1 = S::P1;
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
          const float wn = w(c, n);
          gp[c][0] += g0 * wn;
          gp[c][1] += g1 * wn;
          gp[c][2] += g2 * wn;
          if (VALUES) v[c] += N * wn;
        }
      }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int f = 0; f < 3; ++f)
      g[c][f] = gp[c][0] * ji[0][f] + gp[c][1] * ji[1][f] + gp[c][2] * ji[2][f];
}

// values v[c] of a field at one point
template <class S, class W>
__device__ __forceinline__ void interp_value(const W& w, const Basis<S>& s, float v[3]) {
  constexpr int P1 = S::P1;
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
        for (int c = 0; c < 3; ++c) v[c] += N * w(c, n);
      }
}

// the flux of one point: Z[c][a] = sum_f jinv[a][f] wq X[c][f], mm[c] = wq m[c]
__device__ __forceinline__ void point_flux(const float ji[3][3], float wq, const float X[3][3],
                                           const float m[3], float Z[3][3], float mm[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      Z[c][a] = ji[a][0] * (wq * X[c][0]) + ji[a][1] * (wq * X[c][1]) +
                ji[a][2] * (wq * X[c][2]);
    mm[c] = wq * m[c];
  }
}

// acc[c][n] += dN[n][f] Z[c][f] + N[n] mm[c] of one point, wq in Z and mm
template <class S>
__device__ __forceinline__ void scatter(float (&acc)[3][S::ND], const Basis<S>& s,
                                        const float Z[3][3], const float mm[3]) {
  constexpr int P1 = S::P1;
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

// ---- residual_kernel: one thread per (element, point slot) --------------------

// a block's shared memory: the tile's element fields, [value][lane], and
// the NSTAGE values each slot's current point hands to the reduction
template <class S, bool VISC>
struct TileShared {
  float u[S::NV][TILE];
  float a[S::NV][TILE];
  float v[VISC ? S::NV : 1][TILE];
  float pt[SLOTS][S::NSTAGE][TILE];
};

// point q of element e (this thread's lane): F, grad v and a from the
// staged fields, the basis values into st[k][lane] (so that only jinv, grad
// v and a stay live across the material), the material and the tangent
// planes, then the point's flux into st[k][lane]
template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
__device__ __forceinline__ void tile_point(const TileShared<S, VISC>& sh, int lane, int q,
                                           long long e, long long E, const Tables& tb,
                                           const float* __restrict__ jinv,
                                           const float* __restrict__ wq, CT* __restrict__ cout,
                                           const Mat& mat, float rho, float mu_v,
                                           float (*st)[TILE]) {
  constexpr int P1 = S::P1, ND = S::ND;
  float ji[3][3];
  load_jinv<S>(jinv, q, e, E, ji);
  float F[3][3], dV[3][3], av[3];
  {
    Basis<S> s;
    load_basis<S>(tb, q, e, E, s);
    float vdum[3];
    interp_grad<false>([&](int c, int n) { return sh.u[c * ND + n][lane]; }, s, ji, F, vdum);
    if constexpr (VISC)
      interp_grad<false>([&](int c, int n) { return sh.v[c * ND + n][lane]; }, s, ji, dV,
                         vdum);
    interp_value([&](int c, int n) { return sh.a[c * ND + n][lane]; }, s, av);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        st[S::ST_B + ax * P1 + a][lane] = s.b[ax][a];
        st[S::ST_D + ax * P1 + a][lane] = s.d[ax][a];
      }
  }
  F[0][0] += 1.f;
  F[1][1] += 1.f;
  F[2][2] += 1.f;
  const long long QE = (long long)S::NQ * E, qe = (long long)q * E + e;
  float P[3][3];
  {  // the point's tangent data is dead before the flux is formed
    typename Mat::Point pt;
    mat.template eval<TANGENT>(F, qe, QE, P, pt);
    if constexpr (TANGENT) Store::store(cout, qe, QE, mat, pt);
  }
  if constexpr (VISC) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) P[c][d] += mu_v * dV[c][d];
  }
  const float m[3] = {rho * av[0], rho * av[1], rho * av[2]};
  float Z[3][3], mm[3];
  point_flux(ji, __ldg(wq + qe), P, m, Z, mm);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a) st[S::ST_Z + c * 3 + a][lane] = Z[c][a];
    st[S::ST_M + c][lane] = mm[c];
  }
}

// acc[3 j + c] += the round's SLOTS points, in slot (= q) order, for the
// outputs (c, n) of the nodes n = W + SLOTS j this thread owns; the terms
// are scatter's, the basis products formed once per node.  `left` is the
// round's points still to add (NQ - q0): at p = 3 the last round of the
// 125 points holds one.
template <class S, int W>
__device__ __forceinline__ void add_round(float (&acc)[S::OWN],
                                          float (*pt)[S::NSTAGE][TILE], int lane, int left) {
  constexpr int P1 = S::P1, ST_B = S::ST_B, ST_D = S::ST_D, ST_Z = S::ST_Z, ST_M = S::ST_M;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if constexpr (S::NQ % SLOTS != 0) {
      if (s >= left) break;
    }
    const float(*p)[TILE] = pt[s];
#pragma unroll
    for (int j = 0; j < S::OWN_NODES; ++j) {
      const int n = W + SLOTS * j;
      if (n < S::ND) {
        const int a0 = n % P1, a1 = (n / P1) % P1, a2 = n / (P1 * P1);
        const float b0 = p[ST_B + a0][lane], b1 = p[ST_B + P1 + a1][lane],
                    b2 = p[ST_B + 2 * P1 + a2][lane];
        const float d0 = p[ST_D + a0][lane], d1 = p[ST_D + P1 + a1][lane],
                    d2 = p[ST_D + 2 * P1 + a2][lane];
        const float bb = b1 * b2;
        const float g0 = d0 * bb;
        const float g1 = b0 * d1 * b2;
        const float g2 = b0 * b1 * d2;
        const float N = b0 * bb;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[3 * j + c] += g0 * p[ST_Z + c * 3][lane] + g1 * p[ST_Z + c * 3 + 1][lane] +
                            g2 * p[ST_Z + c * 3 + 2][lane] + N * p[ST_M + c][lane];
      }
    }
  }
}

// add_round<slot>, the slot known at compile time in each branch (the
// branch is uniform across a warp)
template <class S, int W = 0>
__device__ __forceinline__ void add_round_of(int slot, float (&acc)[S::OWN],
                                             float (*pt)[S::NSTAGE][TILE], int lane, int left) {
  if constexpr (W + 1 < SLOTS) {
    if (slot != W) {
      add_round_of<S, W + 1>(slot, acc, pt, lane, left);
      return;
    }
  }
  add_round<S, W>(acc, pt, lane, left);
}

template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(TILE * SLOTS, VISC ? S::MIN_BLOCKS_VISC : S::MIN_BLOCKS)
    residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                    const float* __restrict__ v_el, Tables tb,
                    const float* __restrict__ jinv, const float* __restrict__ wq,
                    float* __restrict__ out, CT* __restrict__ cout, Mat mat, float rho,
                    float mu_v, long long E) {
  constexpr int NV = S::NV, ND = S::ND, OWN = S::OWN;
  using Tile = TileShared<S, VISC>;
  MIMI_DYNAMIC_SHARED(Tile, tile);
  Tile& sh = *tile;
  const int lane = threadIdx.x % TILE, slot = threadIdx.x / TILE;
  const long long e = (long long)blockIdx.x * TILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % TILE != 0
  for (int r = slot; r < NV; r += SLOTS) {
    const long long off = (long long)r * E + e;
    sh.u[r][lane] = live ? __ldg(u_el + off) : 0.f;
    sh.a[r][lane] = live ? __ldg(a_el + off) : 0.f;
    if constexpr (VISC) sh.v[r][lane] = live ? __ldg(v_el + off) : 0.f;
  }
  __syncthreads();
  float acc[OWN];
#pragma unroll
  for (int k = 0; k < OWN; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int q0 = 0; q0 < S::NQ; q0 += SLOTS) {
    // the last round is partial where SLOTS does not divide NQ (p = 3)
    if (live && (S::NQ % SLOTS == 0 || q0 + slot < S::NQ))
      tile_point<S, Mat, Store, TANGENT, VISC, CT>(sh, lane, q0 + slot, e, E, tb, jinv, wq,
                                                   cout, mat, rho, mu_v, sh.pt[slot]);
    __syncthreads();
    if (live) add_round_of<S>(slot, acc, sh.pt, lane, S::NQ - q0);
    __syncthreads();  // the round's points are read before the next overwrites them
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < S::OWN_NODES; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < 3; ++c) out[(long long)(c * ND + n) * E + e] = acc[3 * j + c];
    }
  }
}

// ---- matvec_kernel: one thread per element ----------------------------------

template <class S, class Store, bool VISC, typename CT>
__global__ void __launch_bounds__(BLOCK)
    matvec_kernel(const float* __restrict__ w_el, Tables tb,
                  const float* __restrict__ jinv, const float* __restrict__ wq,
                  const CT* __restrict__ cb, float* __restrict__ out, float rho,
                  float fac0, float fac1_mu_v, long long E) {
  constexpr int ND = S::ND;
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
  const auto wf = [&](int c, int n) { return ww[c][n]; };
  const long long QE = (long long)S::NQ * E;
#pragma unroll 1
  for (int q = 0; q < S::NQ; ++q) {
    Basis<S> s;
    load_basis<S>(tb, q, e, E, s);
    float ji[3][3];
    load_jinv<S>(jinv, q, e, E, ji);
    float dF[3][3], v[3];
    interp_grad<true>(wf, s, ji, dF, v);
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
    float Z[3][3], mm[3];
    point_flux(ji, __ldg(wq + qe), dP, m, Z, mm);
    scatter(acc, s, Z, mm);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
int launch_residual(const float* u_el, const float* a_el, const float* v_el,
                    const Tables& tb, const float* jinv, const float* wq, float* out,
                    void* cout, const Mat& mat, float rho, float mu_v, long long E,
                    void* stream) {
  constexpr size_t smem = sizeof(TileShared<S, VISC>);
  if (const int err = allow_dynamic_smem<residual_kernel<S, Mat, Store, TANGENT, VISC, CT>>(smem))
    return err;
  const unsigned tiles = (unsigned)((E + TILE - 1) / TILE);
  residual_kernel<S, Mat, Store, TANGENT, VISC, CT>
      <<<tiles, TILE * SLOTS, smem, (cudaStream_t)stream>>>(
          u_el, a_el, v_el, tb, jinv, wq, out, static_cast<CT*>(cout), mat, rho, mu_v, E);
  return (int)cudaGetLastError();
}

template <class S, class Store, bool VISC, typename CT>
int launch_matvec(const float* w_el, const Tables& tb, const float* jinv,
                  const float* wq, const void* cb, float* out, float rho,
                  float fac0, float fac1_mu_v, long long E, void* stream) {
  const unsigned grid = (unsigned)((E + BLOCK - 1) / BLOCK);
  matvec_kernel<S, Store, VISC, CT><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      w_el, tb, jinv, wq, static_cast<const CT*>(cb), out, rho, fac0, fac1_mu_v, E);
  return (int)cudaGetLastError();
}

}  // namespace
