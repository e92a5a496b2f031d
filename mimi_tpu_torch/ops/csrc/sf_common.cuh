// The sum-factorized sweep kernels shared by sweeps_sf.cu (J2 and J2Linear
// with the Cauchy storage), sweeps_sf_hyper.cu (the hyperelastic materials
// with the symmetric storage) and sweeps_sf_finite.cu (J2Simo and J2Log
// with the full storage), for sm_90a: the 1D basis tables and the
// interpolation of one element's fields at one point (the J2 return maps
// are in j2.cuh, the storages in materials.cuh), and one kernel template,
// sf_tile_kernel, with its launcher, for the residual, the assemble and
// the matvec, all templated on the element's shape SfShape<P1, NG> (P1 =
// p + 1 nodes and NG Gauss points per axis).  Each source instantiates
// what it needs at one shape: the three sources at p = 2 (SfShape<3, 4>),
// their _p3 twins (sweeps_sf_p3.cu and the like, which define MIMI_SF_P1 /
// MIMI_SF_NG and include them) at p = 3 (SfShape<4, 5>), with the suffix
// _p3 on their C entry points.
//
// sf_tile_kernel maps one thread to an (element, point slot): a block
// takes a tile of TILE = 32 consecutive elements, one per lane, and SLOTS
// = 4 warps, warp s taking the points q = s (mod SLOTS) of every element
// in the tile.  The tile's element fields (the residual's u, a and,
// viscous, v; the matvec's w: (3, ND) values each) are staged once in
// shared memory as [3 ND][TILE], so a lane reads its own column without
// bank conflicts, and every batch-last read and write at qe = q E + e
// (tables, jinv, w det J, state, tangent planes) is one 128-byte line per
// warp.  The NQ points run in NQ / SLOTS rounds: each warp runs its point
// (SfResidualPoint: F from shared memory with interp_grad, the material,
// the planes; SfMatvecPoint: grad w and w, the block's apply), and hands
// its 1D basis values and its flux (Z = jinv w det J X, w det J rho a) to
// shared memory; after a barrier each thread adds the round's SLOTS
// points, in q order, to the outputs of the nodes n = s + SLOTS j it owns,
// all three components (the transpose of a scatter): the reduction is
// deterministic and uses no atomics; a thread holds 21 accumulators at
// p = 2 (48 at p = 3) instead of 81 (192).  The outputs are written
// coalesced at the end.  The per-point operations, and the q order of the
// sums, are those of the one-thread-per-element kernels the template
// replaced, so the outputs round as theirs did.  Shared memory (dynamic, launch.cuh): 36.2 KB a
// block, 46.5 KB viscous, 25.7 KB for the matvec at p = 2; 67.6 KB, 92.2 KB
// and 43.0 KB at p = 3 (SfShape::MIN_BLOCKS*).  Design notes and what
// bounds the kernels: the head of sweeps_sf.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "j2.cuh"
#include "launch.cuh"
#include "materials.cuh"

namespace {

// sf_tile_kernel: elements per block (a warp's lanes) and point slots (one
// warp each)
constexpr int TILE = 32;
constexpr int SLOTS = 4;

// The element of one shape: P1 = p + 1 nodes and NG Gauss points per axis.
// What an sf_tile_kernel thread sums (OWN outputs of OWN_NODES nodes), what
// one point hands to the reduction per lane (its 1D basis values b[ax][a],
// d[ax][a] at ST_B, ST_D, its flux Z[c][a] at ST_Z, its mass term mm[c] at
// ST_M), and the blocks of 128 threads an SM must hold (__launch_bounds__),
// which cap a thread's registers at 65536 / (MIN_BLOCKS * 128).  The
// residual and assemble: at p = 2 4 (128 registers; 4 tiles of 36.2 or
// 46.5 KB fit the SM's 228 KB), at p = 3 3 inviscid (170 registers, 3 x
// 67.6 KB) and 2 viscous (255, 2 x 92.2 KB).  The matvec: 4 at p = 2 (128
// registers, 4 x 25.7 KB), 3 at p = 3 (170, 3 x 43.0 KB).
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
  static constexpr int MIN_BLOCKS_MATVEC = P1 <= 3 ? 4 : 3;
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

// ---- sf_tile_kernel: one thread per (element, point slot) -----------------------

// a block's shared memory: the tile's NF element fields, [value][lane], and
// the NSTAGE values each slot's current point hands to the reduction
template <class S, int NF>
struct TileShared {
  float f[NF][S::NV][TILE];
  float pt[SLOTS][S::NSTAGE][TILE];
};

// the staged fields of a tile, f[field][value][lane]
template <class S>
using Staged = const float (*)[S::NV][TILE];

// the point's basis values into st[k][lane], as the reduction reads them
template <class S>
__device__ __forceinline__ void stage_basis(const Basis<S>& s, int lane, float (*st)[TILE]) {
  constexpr int P1 = S::P1;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      st[S::ST_B + ax * P1 + a][lane] = s.b[ax][a];
      st[S::ST_D + ax * P1 + a][lane] = s.d[ax][a];
    }
}

// the point's flux into st[k][lane]
template <class S>
__device__ __forceinline__ void stage_flux(const float Z[3][3], const float mm[3], int lane,
                                           float (*st)[TILE]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a) st[S::ST_Z + c * 3 + a][lane] = Z[c][a];
    st[S::ST_M + c][lane] = mm[c];
  }
}

// The points of sf_tile_kernel: what a point keeps beside the kernel's
// arguments (the material and its scalars), the fields it stages (NF), the
// blocks an SM must hold (MIN_BLOCKS) and the type of the tangent block
// (Block: written by the assemble, read by the matvec).  The block, jinv
// and w det J reach the point as the kernel's __restrict__ arguments, so
// the compiler knows that the block's stores alias no table or state read.

// point q of element e (this thread's lane) of the residual (and, with
// TANGENT, the assemble): F, grad v and a from the staged fields u (f[0]),
// a (f[1]) and, viscous, v (f[2]), the basis values into st (so that only
// jinv, grad v and a stay live across the material), the material and the
// tangent planes, then the point's flux into st
template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
struct SfResidualPoint {
  static constexpr int NF = VISC ? 3 : 2;
  static constexpr int MIN_BLOCKS = VISC ? S::MIN_BLOCKS_VISC : S::MIN_BLOCKS;
  using Block = CT;
  Mat mat;
  float rho, mu_v;
  __device__ __forceinline__ void operator()(Staged<S> f, int lane, int q, long long e,
                                             long long E, const Tables& tb,
                                             const float* __restrict__ jinv,
                                             const float* __restrict__ wq,
                                             CT* __restrict__ cout, float (*st)[TILE]) const {
    constexpr int ND = S::ND;
    float ji[3][3];
    load_jinv<S>(jinv, q, e, E, ji);
    float F[3][3], dV[3][3], av[3];
    {
      Basis<S> s;
      load_basis<S>(tb, q, e, E, s);
      float vdum[3];
      interp_grad<false>([&](int c, int n) { return f[0][c * ND + n][lane]; }, s, ji, F, vdum);
      if constexpr (VISC)
        interp_grad<false>([&](int c, int n) { return f[2][c * ND + n][lane]; }, s, ji, dV,
                           vdum);
      interp_value([&](int c, int n) { return f[1][c * ND + n][lane]; }, s, av);
      stage_basis(s, lane, st);
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
    stage_flux<S>(Z, mm, lane, st);
  }
};

// point q of element e of the matvec: grad w and w from the staged field
// w (f[0]), the basis values into st, the tangent block's apply (plus
// fac1 mu_v grad w, viscous), then the point's flux into st
template <class S, class Store, bool VISC, typename CT>
struct SfMatvecPoint {
  static constexpr int NF = 1;
  static constexpr int MIN_BLOCKS = S::MIN_BLOCKS_MATVEC;
  using Block = const CT;
  float rho, fac0, fac1_mu_v;
  __device__ __forceinline__ void operator()(Staged<S> f, int lane, int q, long long e,
                                             long long E, const Tables& tb,
                                             const float* __restrict__ jinv,
                                             const float* __restrict__ wq,
                                             const CT* __restrict__ cb, float (*st)[TILE]) const {
    constexpr int ND = S::ND;
    float ji[3][3];
    load_jinv<S>(jinv, q, e, E, ji);
    float dF[3][3], v[3];
    {
      Basis<S> s;
      load_basis<S>(tb, q, e, E, s);
      interp_grad<true>([&](int c, int n) { return f[0][c * ND + n][lane]; }, s, ji, dF, v);
      stage_basis(s, lane, st);
    }
    const long long QE = (long long)S::NQ * E, qe = (long long)q * E + e;
    float dP[3][3];
    Store::apply(cb, qe, QE, dF, fac0, dP);
    if constexpr (VISC) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) dP[c][d] += fac1_mu_v * dF[c][d];
    }
    const float m[3] = {rho * v[0], rho * v[1], rho * v[2]};
    float Z[3][3], mm[3];
    point_flux(ji, __ldg(wq + qe), dP, m, Z, mm);
    stage_flux<S>(Z, mm, lane, st);
  }
};

// acc[3 j + c] += the round's SLOTS points, in slot (= q) order, for the
// outputs (c, n) of the nodes n = W + SLOTS j this thread owns: dN[n] . Z +
// N[n] mm, the basis products formed once per node from the staged 1D
// values.  `left` is the round's points still to add (NQ - q0): at p = 3
// the last round of the 125 points holds one.
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

// y[c][n] = sum_q (dN[n](q) . Z(q) + N[n](q) mm(q)) over the element's
// points, each point's flux Z, mm from `point` (SfResidualPoint or
// SfMatvecPoint) on the Pt::NF staged fields f0 (, f1, f2)
template <class S, class Pt>
__global__ void __launch_bounds__(TILE * SLOTS, Pt::MIN_BLOCKS)
    sf_tile_kernel(Pt point, const float* __restrict__ f0, const float* __restrict__ f1,
                   const float* __restrict__ f2, Tables tb, const float* __restrict__ jinv,
                   const float* __restrict__ wq, typename Pt::Block* __restrict__ block,
                   float* __restrict__ out, long long E) {
  constexpr int NF = Pt::NF, NV = S::NV, ND = S::ND, OWN = S::OWN;
  using Tile = TileShared<S, NF>;
  MIMI_DYNAMIC_SHARED(Tile, tile);
  Tile& sh = *tile;
  const float* const fields[3] = {f0, f1, f2};
  const int lane = threadIdx.x % TILE, slot = threadIdx.x / TILE;
  const long long e = (long long)blockIdx.x * TILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % TILE != 0
  for (int r = slot; r < NV; r += SLOTS) {
    const long long off = (long long)r * E + e;
#pragma unroll
    for (int k = 0; k < NF; ++k) sh.f[k][r][lane] = live ? __ldg(fields[k] + off) : 0.f;
  }
  __syncthreads();
  float acc[OWN];
#pragma unroll
  for (int k = 0; k < OWN; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int q0 = 0; q0 < S::NQ; q0 += SLOTS) {
    // the last round is partial where SLOTS does not divide NQ (p = 3)
    if (live && (S::NQ % SLOTS == 0 || q0 + slot < S::NQ))
      point(sh.f, lane, q0 + slot, e, E, tb, jinv, wq, block, sh.pt[slot]);
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

template <class S, class Pt>
int launch_sf_tile(const Pt& point, const float* f0, const float* f1, const float* f2,
                   const Tables& tb, const float* jinv, const float* wq,
                   typename Pt::Block* block, float* out, long long E, void* stream) {
  constexpr size_t smem = sizeof(TileShared<S, Pt::NF>);
  if (const int err = allow_dynamic_smem<sf_tile_kernel<S, Pt>>(smem)) return err;
  const unsigned tiles = (unsigned)((E + TILE - 1) / TILE);
  sf_tile_kernel<S, Pt><<<tiles, TILE * SLOTS, smem, (cudaStream_t)stream>>>(
      point, f0, f1, f2, tb, jinv, wq, block, out, E);
  return (int)cudaGetLastError();
}

template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
int launch_residual(const float* u_el, const float* a_el, const float* v_el,
                    const Tables& tb, const float* jinv, const float* wq, float* out,
                    void* cout, const Mat& mat, float rho, float mu_v, long long E,
                    void* stream) {
  const SfResidualPoint<S, Mat, Store, TANGENT, VISC, CT> point{mat, rho, mu_v};
  return launch_sf_tile<S>(point, u_el, a_el, v_el, tb, jinv, wq, static_cast<CT*>(cout), out,
                           E, stream);
}

template <class S, class Store, bool VISC, typename CT>
int launch_matvec(const float* w_el, const Tables& tb, const float* jinv,
                  const float* wq, const void* cb, float* out, float rho,
                  float fac0, float fac1_mu_v, long long E, void* stream) {
  const SfMatvecPoint<S, Store, VISC, CT> point{rho, fac0, fac1_mu_v};
  return launch_sf_tile<S>(point, w_el, nullptr, nullptr, tb, jinv, wq,
                           static_cast<const CT*>(cb), out, E, stream);
}

}  // namespace
