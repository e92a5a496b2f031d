// The sum-factorized sweep kernels shared by sweeps_sf.cu (J2 and J2Linear
// with the Cauchy storage), sweeps_sf_hyper.cu (the hyperelastic materials
// with the symmetric storage) and sweeps_sf_finite.cu (J2Simo and J2Log
// with the full storage), for sm_90a: the 1D basis tables and the
// interpolation of one element's fields at one point (the J2 return maps
// are in j2.cuh, the storages in materials.cuh), and four kernel templates
// with their launchers, all templated on the element's shape
// SfShape<P1, NG> (P1 = p + 1 nodes and NG Gauss points per axis):
// up to p = 3 sf_tile_kernel for the residual, the assemble and the
// matvec, and at p = 2 sf_dealt_kernel for the assemble of a material
// whose tangent is forward-mode passes (J2Log, J2Simo viscous; its notes
// are above it); from p = 4 on sf_axis_residual_kernel (the residual and
// the assemble) and sf_axis_matvec_kernel (the matvec), which contract one
// axis at a time (their notes are above them).  Each source instantiates
// what it needs at the one shape its build defines (MIMI_SF_P1,
// MIMI_SF_NG: ops/build.py compiles the three sources once per shape the
// step asks for, each shape into a library of its own, as the reference
// traces one kernel per shape).
//
// sf_tile_kernel maps one thread to an (element, point slot): a block
// takes a tile of TILE = 32 consecutive elements, one per lane, and
// SLOTS = 4 warps, warp s taking the points q = s (mod 4) of every element
// in the tile.  The tile's element fields (the residual's u, a and,
// viscous, v; the matvec's w: (3, ND) values each) are staged once in
// shared memory as [3 ND][TILE], so a lane reads its own column without
// bank conflicts, and every batch-last read and write at qe = q E + e
// (tables, jinv, w det J, state, tangent planes) is one 128-byte line per
// warp.  The NQ points run in NQ / 4 rounds: each warp runs its point
// (SfResidualPoint: F from shared memory with interp_grad, the material,
// the planes; SfMatvecPoint: grad w and w, the block's apply), and hands
// its 1D basis values and its flux (Z = jinv w det J X, w det J rho a) to
// shared memory; after a barrier each thread adds the round's 4 points, in
// q order, to the outputs of the nodes n = s + 4 j it owns, all three
// components (the transpose of a scatter): the reduction is deterministic
// and uses no atomics; a thread holds 21 accumulators at p = 2 (48 at
// p = 3; 6 at p = 1) instead of 81 (192).  The outputs are written
// coalesced at the end.  The per-point operations, and the q order of the
// sums, are those of the one-thread-per-element kernels the template
// replaced, so the outputs round as theirs did.  Shared memory (dynamic,
// launch.cuh): 36.2 KB a block, 46.5 KB viscous, 25.7 KB for the matvec at
// p = 2; 67.6 KB, 92.2 KB and 43.0 KB at p = 3 (SfShape::blocks).  Design
// notes and what bounds the kernels: the head of sweeps_sf.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "j2.cuh"
#include "launch.cuh"
#include "materials.cuh"

namespace {

// sf_tile_kernel: elements per block (a warp's lanes)
constexpr int TILE = 32;
// shared memory of one SM, and what each resident block reserves of it
constexpr size_t SM_SHARED = 228 * 1024, BLOCK_RESERVED = 1024;

// The element of one shape: P1 = p + 1 nodes and NG Gauss points per axis.
// What an sf_tile_kernel thread sums (OWN outputs of OWN_NODES nodes of
// its slot), what one point hands to the reduction per lane (its 1D basis
// values b[ax][a], d[ax][a] at ST_B, ST_D, its flux Z[c][a] at ST_Z, its
// mass term mm[c] at ST_M), and the blocks an SM must hold
// (__launch_bounds__), which cap a thread's registers at
// 65536 / (blocks * 32 SLOTS): as many tiles of `tile_bytes` as the SM's
// shared memory holds, at most MAX_BLOCKS (4 at p <= 2, 3 at p = 3: the
// registers the tile needs).  The residual and assemble: at p = 2 4 (128
// registers; 4 tiles of 36.2 or 46.5 KB), at p = 3 3 inviscid (170
// registers, 3 x 67.6 KB) and 2 viscous (255, 2 x 92.2 KB).  The matvec: 4
// at p = 2 (25.7 KB), 3 at p = 3 (43.0 KB).
template <int P1_, int NG_>
struct SfShape {
  static constexpr int P1 = P1_, NG = NG_;
  static constexpr int NQ = NG * NG * NG;
  static constexpr int ND = P1 * P1 * P1;
  static constexpr int NV = 3 * ND;  // values of a vector field on one element
  static constexpr int SLOTS = 4;
  static constexpr int OWN_NODES = (ND + SLOTS - 1) / SLOTS;
  static constexpr int OWN = 3 * OWN_NODES;
  static constexpr int ST_B = 0, ST_D = 3 * P1, ST_Z = 6 * P1, ST_M = ST_Z + 9;
  static constexpr int NSTAGE = ST_M + 3;
  static constexpr int MAX_BLOCKS = P1 <= 3 ? 4 : 3;
  // shared memory of a tile with nf staged fields (TileShared)
  static constexpr size_t tile_bytes(int nf) {
    return sizeof(float) * TILE * ((size_t)nf * NV + (size_t)SLOTS * NSTAGE);
  }
  static constexpr int blocks(int nf) { return blocks_of(tile_bytes(nf)); }
  // as many blocks of `bytes` as an SM's shared memory holds, at most MAX_BLOCKS
  static constexpr int blocks_of(size_t bytes) {
    const size_t fit = SM_SHARED / (bytes + BLOCK_RESERVED);
    return fit < (size_t)MAX_BLOCKS ? (fit < 1 ? 1 : (int)fit) : MAX_BLOCKS;
  }
};

}  // namespace

// The shape this translation unit instantiates, defined by the build
// (ops/build.py: -DMIMI_SF_P1=<p + 1> -DMIMI_SF_NG=<Gauss points per axis>)
#if !defined(MIMI_SF_P1) || !defined(MIMI_SF_NG)
#error "define MIMI_SF_P1 and MIMI_SF_NG: the sf element's shape (ops/build.py)"
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
  float pt[S::SLOTS][S::NSTAGE][TILE];
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
//
// A material whose tangent is forward-mode passes (dealt_tangent: J2Simo,
// J2Log) runs its assemble at p = 2 on sf_dealt_kernel instead (below),
// but for J2Simo's inviscid one (kSfDealtInviscid): the point's float pass
// hands its F and return map to shared memory after its flux (stage_point)
// and stores no plane; its 9 tangent columns are dealt over the warps
// (`tangent`).  There a is read from device memory, not staged.  At p = 3
// the dealt kernel spilled more than this one, and J2Simo's inviscid one
// spilled at (3, 3) once its round's points were added one at a time
// (PERF.md).
template <class S, class Mat, bool TANGENT, bool VISC>
constexpr bool sf_dealt() {
  if constexpr (TANGENT && dealt_tangent<Mat>::value)
    return S::P1 == 3 && (VISC || Mat::kSfDealtInviscid);
  else
    return false;
}
template <class Mat>
constexpr int point_floats() {  // a point's F and return map (stage_point)
  if constexpr (dealt_tangent<Mat>::value)
    return Mat::kPointFloats;
  else
    return 0;
}

template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
struct SfResidualPoint {
  static constexpr bool DEALT = sf_dealt<S, Mat, TANGENT, VISC>();
  static constexpr bool A_STAGED = !DEALT;  // a staged beside u (and v)
  static constexpr int NF = 1 + A_STAGED + VISC;
  // floats a slot hands to the round's reduction: its basis values and
  // flux, and with dealt tangent passes its F and return map
  static constexpr int STAGE = S::NSTAGE + (DEALT ? point_floats<Mat>() : 0);
  // shared memory of sf_dealt_kernel's block: the staged fields, the
  // slots' STAGE floats and the owners' sums (DealtShared)
  static constexpr size_t DEALT_BYTES =
      sizeof(float) * TILE * ((size_t)NF * S::NV + (size_t)S::SLOTS * (STAGE + S::OWN));
  static constexpr int MIN_BLOCKS = DEALT ? S::blocks_of(DEALT_BYTES) : S::blocks(NF);
  using Block = CT;
  Mat mat;
  float rho, mu_v;
  const float* a_el = nullptr;  // a in device memory, where not staged
  __device__ __forceinline__ bool runs() const { return launch_runs(mat); }
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
        interp_grad<false>([&](int c, int n) { return f[A_STAGED ? 2 : 1][c * ND + n][lane]; },
                           s, ji, dV, vdum);
      if constexpr (A_STAGED)
        interp_value([&](int c, int n) { return f[1][c * ND + n][lane]; }, s, av);
      else
        interp_value([&](int c, int n) { return __ldg(a_el + (long long)(c * ND + n) * E + e); },
                     s, av);
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
      if constexpr (DEALT)
        Mat::stage_point(pt, st + S::NSTAGE, lane);
      else if constexpr (TANGENT)
        Store::store(cout, qe, QE, mat, pt);
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
  // column b of point q's tangent (DEALT): one forward-mode pass from the
  // point's F and return map at p (stage_point), stored as the 9 planes
  // (a 9 + b) QE + qe, one line a warp each
  __device__ __forceinline__ void tangent(const float (*p)[TILE], int lane, int q, long long e,
                                          long long E, int b, CT* __restrict__ cout) const {
    constexpr int D2 = 9;
    const long long QE = (long long)S::NQ * E, qe = (long long)q * E + e;
    float col[D2];
    mat.column(Mat::staged_point(p, lane), qe, QE, b, col);
#pragma unroll
    for (int a = 0; a < D2; ++a) store_c(cout + (a * D2 + b) * QE + qe, col[a]);
  }
};

// point q of element e of the matvec: grad w and w from the staged field
// w (f[0]), the basis values into st, the tangent block's apply (plus
// fac1 mu_v grad w, viscous), then the point's flux into st
template <class S, class Store, bool VISC, typename CT>
struct SfMatvecPoint {
  static constexpr int NF = 1;
  static constexpr int MIN_BLOCKS = S::blocks(NF);
  using Block = const CT;
  float rho, fac0, fac1_mu_v;
  __device__ __forceinline__ bool runs() const { return true; }
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

// acc[3 j + c] += one point's terms (its staged values p[k][lane]) for the
// outputs (c, n) of the nodes n = W + SLOTS j this thread owns: dN[n] . Z +
// N[n] mm, the basis products formed once per node from the staged 1D
// values
template <class S, int W>
__device__ __forceinline__ void add_point(float (&acc)[S::OWN], const float (*p)[TILE],
                                          int lane) {
  constexpr int P1 = S::P1, ST_B = S::ST_B, ST_D = S::ST_D, ST_Z = S::ST_Z, ST_M = S::ST_M;
  constexpr int SLOTS = S::SLOTS;
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

// the round's SLOTS points, in slot (= q) order (add_point).  `left` is the
// round's points still to add (NQ - q0): where SLOTS does not divide NQ
// (p = 3: 125 points) the last round is partial
template <class S, int W, int R = S::NSTAGE>
__device__ __forceinline__ void add_round(float (&acc)[S::OWN], float (*pt)[R][TILE], int lane,
                                          int left) {
#pragma unroll
  for (int s = 0; s < S::SLOTS; ++s) {
    if constexpr (S::NQ % S::SLOTS != 0) {
      if (s >= left) break;
    }
    add_point<S, W>(acc, pt[s], lane);
  }
}

// add_round<slot>, the slot known at compile time in each branch (the
// branch is uniform across a warp); a slot's values are R floats a lane
template <class S, int W = 0, int R = S::NSTAGE>
__device__ __forceinline__ void add_round_of(int slot, float (&acc)[S::OWN], float (*pt)[R][TILE],
                                             int lane, int left) {
  if constexpr (W + 1 < S::SLOTS) {
    if (slot != W) {
      add_round_of<S, W + 1, R>(slot, acc, pt, lane, left);
      return;
    }
  }
  add_round<S, W, R>(acc, pt, lane, left);
}

// y[c][n] = sum_q (dN[n](q) . Z(q) + N[n](q) mm(q)) over the element's
// points, each point's flux Z, mm from `point` (SfResidualPoint or
// SfMatvecPoint) on the Pt::NF staged fields f0 (, f1, f2)
template <class S, class Pt>
__global__ void __launch_bounds__(TILE * S::SLOTS, Pt::MIN_BLOCKS)
    sf_tile_kernel(Pt point, const float* __restrict__ f0, const float* __restrict__ f1,
                   const float* __restrict__ f2, Tables tb, const float* __restrict__ jinv,
                   const float* __restrict__ wq, typename Pt::Block* __restrict__ block,
                   float* __restrict__ out, long long E) {
  constexpr int NF = Pt::NF, NV = S::NV, ND = S::ND, OWN = S::OWN, SLOTS = S::SLOTS;
  using Tile = TileShared<S, NF>;
  MIMI_DYNAMIC_SHARED(Tile, tile);
  Tile& sh = *tile;
  if (!point.runs()) return;  // the whole launch: J2Log's deep one where no point needs it
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
    // the last round is partial where SLOTS does not divide NQ
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
  static_assert(S::P1 <= 4, "from p = 4 on the sf sweeps contract axis by axis");
  constexpr size_t smem = sizeof(TileShared<S, Pt::NF>);
  static_assert(smem == S::tile_bytes(Pt::NF), "tile_bytes counts TileShared");
  if (const int err = allow_dynamic_smem<sf_tile_kernel<S, Pt>>(smem)) return err;
  const unsigned tiles = (unsigned)((E + TILE - 1) / TILE);
  sf_tile_kernel<S, Pt><<<tiles, TILE * S::SLOTS, smem, (cudaStream_t)stream>>>(
      point, f0, f1, f2, tb, jinv, wq, block, out, E);
  return (int)cudaGetLastError();
}

// ---- sf_dealt_kernel: the assemble with forward-mode tangent passes -----------------
//
// The assemble of J2Log and J2Simo's viscous one at p = 2 (sf_dealt: at
// p = 3 it spilled more than sf_tile_kernel).  sf_tile_kernel ran their
// 9 tangent passes inside the point, after its float pass, with the
// owners' OWN output sums live in registers through them (21 floats at
// p = 2, 48 at p = 3; beside jinv, a and grad v): at 128 registers J2Log's
// spilled 520 B.  Here, as in dense_common.cuh dense_slot_kernel, a block
// takes the same tile of TILE elements in SLOTS warps and runs the NQ
// points in rounds of SLOTS: warp s runs the float pass of point q0 + s
// (SfResidualPoint: F, the material, the flux) and hands its basis
// values, flux, F and return map to shared memory (STAGE floats a lane);
// after a barrier each thread adds the round's points, in q order, to the
// sums of the nodes it owns (add_round: the same operations in the same
// order as sf_tile_kernel's, so the residual is its residual to the bit),
// held in registers for the round's additions only and in shared memory
// between rounds; then the round's points' 9 tangent columns (each a
// forward-mode pass, SfResidualPoint::tangent) are dealt over the block's
// warps, no output sum live during them.  The fields u (and v) are staged;
// a is read from device memory, one line a warp, so that the tile keeps
// four blocks an SM: shared memory 42.5 KB a block, 53.0 KB viscous.
template <class S, int NF, int STAGE>
struct DealtShared {
  float f[NF][S::NV][TILE];
  float pt[S::SLOTS][STAGE][TILE];
  float sums[S::SLOTS][S::OWN][TILE];
};

template <class S, class Pt>
__global__ void __launch_bounds__(TILE * S::SLOTS, Pt::MIN_BLOCKS)
    sf_dealt_kernel(Pt point, const float* __restrict__ f0, const float* __restrict__ f1,
                    Tables tb, const float* __restrict__ jinv, const float* __restrict__ wq,
                    typename Pt::Block* __restrict__ block, float* __restrict__ out,
                    long long E) {
  constexpr int NF = Pt::NF, NV = S::NV, ND = S::ND, OWN = S::OWN, SLOTS = S::SLOTS;
  constexpr int STAGE = Pt::STAGE;
  using Tile = DealtShared<S, NF, STAGE>;
  MIMI_DYNAMIC_SHARED(Tile, tile);
  Tile& sh = *tile;
  if (!point.runs()) return;  // the whole launch: J2Log's deep one where no point needs it
  const float* const fields[2] = {f0, f1};
  const int lane = threadIdx.x % TILE, slot = threadIdx.x / TILE;
  const long long e = (long long)blockIdx.x * TILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % TILE != 0
  for (int r = slot; r < NV; r += SLOTS) {
    const long long off = (long long)r * E + e;
#pragma unroll
    for (int k = 0; k < NF; ++k) sh.f[k][r][lane] = live ? __ldg(fields[k] + off) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < OWN; ++k) sh.sums[slot][k][lane] = 0.f;
  __syncthreads();
#pragma unroll 1
  for (int q0 = 0; q0 < S::NQ; q0 += SLOTS) {
    // the round's points: SLOTS, fewer in a partial last round (p = 3)
    const int left = S::NQ - q0 < SLOTS ? S::NQ - q0 : SLOTS;
    if (live && slot < left)
      point(sh.f, lane, q0 + slot, e, E, tb, jinv, wq, block, sh.pt[slot]);
    __syncthreads();
    if (live) {
      float acc[OWN];
#pragma unroll
      for (int k = 0; k < OWN; ++k) acc[k] = sh.sums[slot][k][lane];
      add_round_of<S, 0, STAGE>(slot, acc, sh.pt, lane, S::NQ - q0);
#pragma unroll
      for (int k = 0; k < OWN; ++k) sh.sums[slot][k][lane] = acc[k];
#pragma unroll 1
      for (int i = slot; i < left * 9; i += SLOTS)
        point.tangent(sh.pt[i / 9] + S::NSTAGE, lane, q0 + i / 9, e, E, i % 9, block);
    }
    __syncthreads();  // the round's points are read before the next overwrites them
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < S::OWN_NODES; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          out[(long long)(c * ND + n) * E + e] = sh.sums[slot][3 * j + c][lane];
    }
  }
}

template <class S, class Pt>
int launch_sf_dealt(const Pt& point, const float* u_el, const float* v_el, const Tables& tb,
                    const float* jinv, const float* wq, typename Pt::Block* block, float* out,
                    long long E, void* stream) {
  constexpr size_t smem = sizeof(DealtShared<S, Pt::NF, Pt::STAGE>);
  static_assert(smem == Pt::DEALT_BYTES && smem <= BLOCK_SMEM_MAX, "DealtShared's bytes");
  if (const int err = allow_dynamic_smem<sf_dealt_kernel<S, Pt>>(smem)) return err;
  const unsigned tiles = (unsigned)((E + TILE - 1) / TILE);
  sf_dealt_kernel<S, Pt><<<tiles, TILE * S::SLOTS, smem, (cudaStream_t)stream>>>(
      point, u_el, v_el, tb, jinv, wq, block, out, E);
  return (int)cudaGetLastError();
}

// ---- the axis-by-axis kernels: the residual, assemble and matvec from p = 4 on ------
//
// At p = 4 (125 nodes, 216 points) sf_tile_kernel's point forms F (or
// grad w) from all 125 nodes and each owner adds every point to its 16
// nodes: 27,000 node-point pairs an element each way, ~35 multiply-adds each
// with their shared-memory reads (~470k an element), at 218-243 registers
// (one 256-thread block an SM).  The residual and assemble ran at 34x and
// 15x their bounds, the matvec at 15x.  These kernels contract one axis at
// a time, as the plain version (ops/sweeps.py sf_param_grad, sf_value,
// sf_scatter) and the TPU kernel (mimi_tpu/ops/sweeps.py:185-290,
// :941-951) do: ~25k multiply-adds an element each way.  A block of
// AXIS_THREADS = 288 threads takes TE = 16 consecutive elements (fewer
// where 16 do not fit, below), so that every read of a batch-last row (the
// tables, jinv, w det J, the state, the fields; the block's planes, written
// by the assemble, read by the matvec; the output's writes) is 64
// contiguous bytes in float32, 32 in bfloat16: whole sectors (at 8
// elements the float32 matvec took 1.96 ms at path K, at 16 1.60:
// scripts/ab_sf_sweeps.py).  Thread t works for element t % TE; the rest of
// t (GROUPS = 288 / TE) walks each phase's items.  The element's values
// live in shared memory as [row][TE] (AxisShared): its six 1D tables (NG,
// P1), read once; each field staged in the region of its axis-1 values;
// the axis-2 contractions of one field with B2 (and D2), [c][2][q2][a1][a0],
// a scratch region the fields take in turn; per gradient field (u, v; the
// matvec's w) the axis-1 contractions tBB, tDB, tBD, [c][3][q2][q1][a0]; per
// value field (the residual's a) tBB alone, [c][q2][q1][a0].  The phases,
// a barrier after each: (A) items (c, a1, a0) contract a field along axis 2;
// (B) items (c, q2, a0) along axis 1 (u; then v, viscous; then a for values
// only; the matvec's w); (C) items (q2, q1), pencils of NG points along
// axis 0: per point the pencil forms the parametric gradient (and value)
// from its axis-1 values (axis 0), F = I + grad u (dF) with jinv, the
// point's material and planes (the block's apply), the flux Z = jinv^T wq X
// and wq rho a (point_flux), and contracts them back along axis 0 into
// 45 sums of its own, which it writes over its own axis-1 values of u (w);
// (B') items (c, q2, a0) contract back along axis 1 into the axis-2
// region; (A') items (c, a1, a0) along axis 2 and write the output.  The
// sums are the plain version's contractions in its order of axes, each a
// fixed order: deterministic, no atomics; the forward terms of the mass and
// of D0 Z0, which share B1 and B2 on the way back, are summed at axis 0.
// The matvec's pencil holds its 45 axis-1 values in registers across its
// points; the residual's reads them from shared memory at each point, so
// that the material runs beside the pencil's 45 sums alone.  One block an
// SM; 288 threads put three warps on one of the SM's four schedulers, which
// caps a thread at 168 registers.
constexpr int AXIS_THREADS = 288;

// elements a block of an axis kernel takes: the most of 16, 8, 4, 2, 1
// whose `rows` floats an element fit in a block's shared memory
constexpr int axis_tile(int rows) {
  for (int te = 16; te > 1; te /= 2)
    if (sizeof(float) * rows * te <= BLOCK_SMEM_MAX) return te;
  return 1;
}

// floats an element of an axis kernel keeps in shared memory, and the row
// of each value, with NU gradient fields (the residual's u and, viscous, v;
// the matvec's w) and NA value fields (the residual's a).  Floats an
// element at SfShape<5, 6>: the matvec 2700 (172.8 KB a block of 16), the
// residual 3240 (207.4 KB), viscous 4860 (8 elements, 155.5 KB); at
// SfShape<5, 8> 5280 and at SfShape<6, 7> 5292 (8 elements), viscous 8160
// and 7938 (4).
template <class S, int NU = 1, int NA = 0>
struct AxisShared {
  static constexpr int P1 = S::P1, NG = S::NG, PP = P1 * P1;
  static constexpr int TAB = 6 * NG * P1, A = 3 * 2 * NG * PP;
  static constexpr int B = 3 * 3 * NG * NG * P1, BV = 3 * NG * NG * P1;
  static constexpr int ROWS = TAB + A + NU * B + NA * BV;
  static_assert(S::NV <= BV, "each field is staged in its axis-1 region");
  static constexpr int TE = axis_tile(ROWS);  // elements a block
  static constexpr int GROUPS = AXIS_THREADS / TE;
  static constexpr size_t SMEM = sizeof(float) * ROWS * TE;
  static_assert(SMEM <= BLOCK_SMEM_MAX && AXIS_THREADS % TE == 0,
                "one element's rows exceed a block's shared memory");
  // table t (B0, D0, B1, D1, B2, D2) at point q, node a
  __host__ __device__ static constexpr int tab(int t, int q, int a) { return (t * NG + q) * P1 + a; }
  // axis 2 contracted with B2 (k 0) or D2 (k 1): [c][k][q2][a1 a0]
  __host__ __device__ static constexpr int a2(int c, int k, int q2, int a10) {
    return TAB + ((c * 2 + k) * NG + q2) * PP + a10;
  }
  // the first row of gradient field f's axis-1 region, and of the value field's
  __host__ __device__ static constexpr int grad(int f) { return TAB + A + f * B; }
  __host__ __device__ static constexpr int val() { return TAB + A + NU * B; }
  // a field's axis-1 values at region `base` with K contractions a component
  // (a gradient field's 3: k 0 tBB, 1 tDB, 2 tBD; a value field's 1, tBB):
  // [c][k][q2][q1][a0]
  template <int K>
  __host__ __device__ static constexpr int row(int base, int c, int k, int q2, int q1, int a0) {
    return base + (((c * K + k) * NG + q2) * NG + q1) * P1 + a0;
  }
  // gradient field 0's (the matvec's w)
  __host__ __device__ static constexpr int a1(int c, int k, int q2, int q1, int a0) {
    return row<3>(grad(0), c, k, q2, q1, a0);
  }
};

// the block's six 1D tables and the NF fields fields[f] into the rows
// rows[f] (each field's axis-1 region); zeros on a ragged tile's dead lanes
template <class L, int NF>
__device__ __forceinline__ void axis_stage(float (*sh)[L::TE], const Tables& tb,
                                           const float* const (&fields)[NF],
                                           const int (&rows)[NF], int lane, int grp,
                                           long long e, long long E, bool live) {
#pragma unroll
  for (int t = 0; t < 6; ++t)
    for (int r = grp; r < L::NG * L::P1; r += L::GROUPS)
      sh[L::tab(t, 0, 0) + r][lane] = live ? __ldg(tb.t[t] + (long long)r * E + e) : 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    for (int r = grp; r < 3 * L::P1 * L::PP; r += L::GROUPS)
      sh[rows[f] + r][lane] = live ? __ldg(fields[f] + (long long)r * E + e) : 0.f;
}

// (A) the field x[c][a2][a1 a0] staged at row `src` -> sum_a2 B2[q2][a2] x
// (and, GRAD, sum_a2 D2[q2][a2] x) into the axis-2 region
template <class L, bool GRAD>
__device__ __forceinline__ void forward_axis2(float (*sh)[L::TE], int src, int lane, int grp) {
  constexpr int P1 = L::P1, NG = L::NG, PP = L::PP;
  const auto T = [&](int t, int q, int a) { return sh[L::tab(t, q, a)][lane]; };
#pragma unroll 1
  for (int i = grp; i < 3 * PP; i += L::GROUPS) {
    const int c = i / PP, a10 = i % PP;
    float x[P1];
#pragma unroll
    for (int a = 0; a < P1; ++a) x[a] = sh[src + c * P1 * PP + a * PP + a10][lane];
#pragma unroll
    for (int q2 = 0; q2 < NG; ++q2) {
      float sB = 0.f, sD = 0.f;
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        sB += T(4, q2, a) * x[a];
        if (GRAD) sD += T(5, q2, a) * x[a];
      }
      sh[L::a2(c, 0, q2, a10)][lane] = sB;
      if (GRAD) sh[L::a2(c, 1, q2, a10)][lane] = sD;
    }
  }
}

// (B) the axis-2 region -> along axis 1 into the field's axis-1 region at
// row `dst`: tBB = B1 sB, and (GRAD) tDB = D1 sB, tBD = B1 sD, over a1
template <class L, bool GRAD>
__device__ __forceinline__ void forward_axis1(float (*sh)[L::TE], int dst, int lane, int grp) {
  constexpr int P1 = L::P1, NG = L::NG, K = GRAD ? 3 : 1;
  const auto T = [&](int t, int q, int a) { return sh[L::tab(t, q, a)][lane]; };
#pragma unroll 1
  for (int i = grp; i < 3 * NG * P1; i += L::GROUPS) {
    const int c = i / (NG * P1), q2 = i / P1 % NG, a0 = i % P1;
    float xB[P1], xD[P1];
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      xB[a] = sh[L::a2(c, 0, q2, a * P1 + a0)][lane];
      xD[a] = GRAD ? sh[L::a2(c, 1, q2, a * P1 + a0)][lane] : 0.f;
    }
#pragma unroll
    for (int q1 = 0; q1 < NG; ++q1) {
      float bb = 0.f, db = 0.f, bd = 0.f;
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        const float b1 = T(2, q1, a), d1 = T(3, q1, a);
        bb += b1 * xB[a];
        if (GRAD) {
          db += d1 * xB[a];
          bd += b1 * xD[a];
        }
      }
      sh[L::template row<K>(dst, c, 0, q2, q1, a0)][lane] = bb;
      if (GRAD) {
        sh[L::template row<K>(dst, c, 1, q2, q1, a0)][lane] = db;
        sh[L::template row<K>(dst, c, 2, q2, q1, a0)][lane] = bd;
      }
    }
  }
}

// a pencil's point q0 (axis 0): the physical gradient g[c][f] of a field
// from its axis-1 values x(c, k, a) (tBB, tDB, tBD) with b0, d0 at q0 and
// jinv
template <int P1, class X>
__device__ __forceinline__ void pencil_grad(const X& x, const float (&b0)[P1],
                                            const float (&d0)[P1], const float ji[3][3],
                                            float g[3][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      g0 += d0[a] * x(c, 0, a);
      g1 += b0[a] * x(c, 1, a);
      g2 += b0[a] * x(c, 2, a);
    }
#pragma unroll
    for (int f = 0; f < 3; ++f) g[c][f] = g0 * ji[0][f] + g1 * ji[1][f] + g2 * ji[2][f];
  }
}

// (B') and (A'): the pencils' sums (in gradient field 0's axis-1 region)
// back along axis 1 into the axis-2 region, B1 (D0 Z0 + B0 mm) + D1 (B0 Z1)
// and B1 (B0 Z2), a barrier, then along axis 2 into the output,
// y[c][a2][a1][a0] = B2 r0 + D2 r1 over q2
template <class L>
__device__ __forceinline__ void axis_back(float (*sh)[L::TE], float* __restrict__ out,
                                          int lane, int grp, long long e, long long E,
                                          bool live) {
  constexpr int P1 = L::P1, NG = L::NG, PP = L::PP, ND = P1 * PP, U = L::grad(0);
  const auto T = [&](int t, int q, int a) { return sh[L::tab(t, q, a)][lane]; };
#pragma unroll 1
  for (int i = grp; i < 3 * NG * P1; i += L::GROUPS) {
    const int c = i / (NG * P1), q2 = i / P1 % NG, a0 = i % P1;
    float x0[NG], x1[NG], x2[NG];
#pragma unroll
    for (int q1 = 0; q1 < NG; ++q1) {
      x0[q1] = sh[L::template row<3>(U, c, 0, q2, q1, a0)][lane];
      x1[q1] = sh[L::template row<3>(U, c, 1, q2, q1, a0)][lane];
      x2[q1] = sh[L::template row<3>(U, c, 2, q2, q1, a0)][lane];
    }
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int q1 = 0; q1 < NG; ++q1) {
        const float b1 = T(2, q1, a);
        r0 += b1 * x0[q1] + T(3, q1, a) * x1[q1];
        r1 += b1 * x2[q1];
      }
      sh[L::a2(c, 0, q2, a * P1 + a0)][lane] = r0;
      sh[L::a2(c, 1, q2, a * P1 + a0)][lane] = r1;
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int i = grp; i < 3 * PP; i += L::GROUPS) {
    const int c = i / PP, a10 = i % PP;
    float y0[NG], y1[NG];
#pragma unroll
    for (int q2 = 0; q2 < NG; ++q2) {
      y0[q2] = sh[L::a2(c, 0, q2, a10)][lane];
      y1[q2] = sh[L::a2(c, 1, q2, a10)][lane];
    }
    if (live) {
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        float o = 0.f;
#pragma unroll
        for (int q2 = 0; q2 < NG; ++q2) o += T(4, q2, a) * y0[q2] + T(5, q2, a) * y1[q2];
        out[(long long)(c * ND + a * PP + a10) * E + e] = o;
      }
    }
  }
}

// The residual (and, TANGENT, the assemble) from p = 4 on: y[c][n] =
// sum_q wq (dN[n] . (P(F) + mu_v dV)[c] + N[n] rho a[c]) with F = I +
// grad u, dV = grad v (VISC), and the material's tangent planes at every
// point into cout (the block of Store in CT).  J2Log's deep launch returns
// at once where no point of the fast one left its log series' range
// (launch_runs).
template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(AXIS_THREADS, 1)
    sf_axis_residual_kernel(Mat mat, float rho, float mu_v, const float* __restrict__ u_el,
                            const float* __restrict__ a_el, const float* __restrict__ v_el,
                            Tables tb, const float* __restrict__ jinv,
                            const float* __restrict__ wq, CT* __restrict__ cout,
                            float* __restrict__ out, long long E) {
  using L = AxisShared<S, VISC ? 2 : 1, 1>;
  constexpr int P1 = S::P1, NG = S::NG, TE = L::TE, U = L::grad(0), V = L::grad(1);
  constexpr int AV = L::val();
  MIMI_DYNAMIC_SHARED(float, smem);  // sh[L::ROWS][TE]
  float(*sh)[TE] = reinterpret_cast<float(*)[TE]>(smem);
  if (!launch_runs(mat)) return;  // the whole launch: J2Log's deep one where no point needs it
  const int lane = threadIdx.x % TE, grp = threadIdx.x / TE;
  const long long e = (long long)blockIdx.x * TE + lane;
  const bool live = e < E;  // the last tile is ragged where E % TE != 0
  const long long QE = (long long)S::NQ * E;
  if constexpr (VISC)
    axis_stage<L, 3>(sh, tb, {u_el, a_el, v_el}, {U, AV, V}, lane, grp, e, E, live);
  else
    axis_stage<L, 2>(sh, tb, {u_el, a_el}, {U, AV}, lane, grp, e, E, live);
  __syncthreads();
  forward_axis2<L, true>(sh, U, lane, grp);
  __syncthreads();
  forward_axis1<L, true>(sh, U, lane, grp);
  __syncthreads();
  if constexpr (VISC) {
    forward_axis2<L, true>(sh, V, lane, grp);
    __syncthreads();
    forward_axis1<L, true>(sh, V, lane, grp);
    __syncthreads();
  }
  forward_axis2<L, false>(sh, AV, lane, grp);
  __syncthreads();
  forward_axis1<L, false>(sh, AV, lane, grp);
  __syncthreads();

  // (C) the pencils: per point F, the material, the flux, back along axis 0
#pragma unroll 1
  for (int i = grp; i < NG * NG; i += L::GROUPS) {
    const int q2 = i / NG, q1 = i % NG;
    float bk[3][3][P1];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < P1; ++a) bk[c][k][a] = 0.f;
    if (live) {
#pragma unroll 1
      for (int q0 = 0; q0 < NG; ++q0) {
        const int q = q0 + NG * q1 + NG * NG * q2;
        const long long qe = (long long)q * E + e;
        float b0[P1], d0[P1], ji[3][3], F[3][3], dV[3][3], av[3];
#pragma unroll
        for (int a = 0; a < P1; ++a) {
          b0[a] = sh[L::tab(0, q0, a)][lane];
          d0[a] = sh[L::tab(1, q0, a)][lane];
        }
        load_jinv<S>(jinv, q, e, E, ji);
        pencil_grad<P1>(
            [&](int c, int k, int a) { return sh[L::template row<3>(U, c, k, q2, q1, a)][lane]; },
            b0, d0, ji, F);
        if constexpr (VISC)
          pencil_grad<P1>(
              [&](int c, int k, int a) { return sh[L::template row<3>(V, c, k, q2, q1, a)][lane]; },
              b0, d0, ji, dV);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float s = 0.f;
#pragma unroll
          for (int a = 0; a < P1; ++a) s += b0[a] * sh[L::template row<1>(AV, c, 0, q2, q1, a)][lane];
          av[c] = s;
        }
        F[0][0] += 1.f;
        F[1][1] += 1.f;
        F[2][2] += 1.f;
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
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int a = 0; a < P1; ++a) {
            bk[c][0][a] += d0[a] * Z[c][0] + b0[a] * mm[c];
            bk[c][1][a] += b0[a] * Z[c][1];
            bk[c][2][a] += b0[a] * Z[c][2];
          }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < P1; ++a) sh[L::template row<3>(U, c, k, q2, q1, a)][lane] = bk[c][k][a];
  }
  __syncthreads();
  axis_back<L>(sh, out, lane, grp, e, E, live);
}

// y = J w from p = 4 on: the matvec's pencils hold their 45 axis-1 values
// of w in registers and apply the block at each point (plus fac1 mu_v grad
// w, viscous) with the mass term rho w.  Its phases are written out here
// rather than through the residual's helpers: through them the same
// operations, equal to the bit, ran 13% slower (1.60 -> 1.82 ms at path
// K, scripts/ab_sf_sweeps.py --part p4)
template <class S, class Store, bool VISC, typename CT>
__global__ void __launch_bounds__(AXIS_THREADS, 1)
    sf_axis_matvec_kernel(const float* __restrict__ w_el, Tables tb,
                          const float* __restrict__ jinv, const float* __restrict__ wq,
                          const CT* __restrict__ cb, float* __restrict__ out, float rho,
                          float fac0, float fac1_mu_v, long long E) {
  using L = AxisShared<S>;
  constexpr int P1 = S::P1, NG = S::NG, ND = S::ND, PP = L::PP;
  constexpr int TE = L::TE, GROUPS = AXIS_THREADS / TE;
  MIMI_DYNAMIC_SHARED(float, smem);  // sh[L::ROWS][TE]
  float(*sh)[TE] = reinterpret_cast<float(*)[TE]>(smem);
  const int lane = threadIdx.x % TE, grp = threadIdx.x / TE;
  const long long e = (long long)blockIdx.x * TE + lane;
  const bool live = e < E;  // the last tile is ragged where E % TE != 0
  const long long QE = (long long)S::NQ * E;
#pragma unroll
  for (int t = 0; t < 6; ++t)
    for (int r = grp; r < NG * P1; r += GROUPS)
      sh[L::tab(t, 0, 0) + r][lane] = live ? __ldg(tb.t[t] + (long long)r * E + e) : 0.f;
  for (int r = grp; r < S::NV; r += GROUPS)
    sh[L::a1(0, 0, 0, 0, 0) + r][lane] = live ? __ldg(w_el + (long long)r * E + e) : 0.f;
  __syncthreads();
  const auto T = [&](int t, int q, int a) { return sh[L::tab(t, q, a)][lane]; };

  // (A) w[c][a2][a1][a0] -> sum_a2 {B2, D2}[q2][a2] w
#pragma unroll 1
  for (int i = grp; i < 3 * PP; i += GROUPS) {
    const int c = i / PP, a10 = i % PP;
    float x[P1];
#pragma unroll
    for (int a = 0; a < P1; ++a) x[a] = sh[L::a1(0, 0, 0, 0, 0) + c * ND + a * PP + a10][lane];
#pragma unroll
    for (int q2 = 0; q2 < NG; ++q2) {
      float sB = 0.f, sD = 0.f;
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        sB += T(4, q2, a) * x[a];
        sD += T(5, q2, a) * x[a];
      }
      sh[L::a2(c, 0, q2, a10)][lane] = sB;
      sh[L::a2(c, 1, q2, a10)][lane] = sD;
    }
  }
  __syncthreads();

  // (B) -> tBB = B1 sB, tDB = D1 sB, tBD = B1 sD over a1
#pragma unroll 1
  for (int i = grp; i < 3 * NG * P1; i += GROUPS) {
    const int c = i / (NG * P1), q2 = i / P1 % NG, a0 = i % P1;
    float xB[P1], xD[P1];
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      xB[a] = sh[L::a2(c, 0, q2, a * P1 + a0)][lane];
      xD[a] = sh[L::a2(c, 1, q2, a * P1 + a0)][lane];
    }
#pragma unroll
    for (int q1 = 0; q1 < NG; ++q1) {
      float bb = 0.f, db = 0.f, bd = 0.f;
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        const float b1 = T(2, q1, a), d1 = T(3, q1, a);
        bb += b1 * xB[a];
        db += d1 * xB[a];
        bd += b1 * xD[a];
      }
      sh[L::a1(c, 0, q2, q1, a0)][lane] = bb;
      sh[L::a1(c, 1, q2, q1, a0)][lane] = db;
      sh[L::a1(c, 2, q2, q1, a0)][lane] = bd;
    }
  }
  __syncthreads();

  // (C) the pencils: axis 0, the points, and back along axis 0
#pragma unroll 1
  for (int i = grp; i < NG * NG; i += GROUPS) {
    const int q2 = i / NG, q1 = i % NG;
    float fw[3][3][P1], bk[3][3][P1];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < P1; ++a) {
          fw[c][k][a] = sh[L::a1(c, k, q2, q1, a)][lane];
          bk[c][k][a] = 0.f;
        }
    if (live) {
#pragma unroll 1
      for (int q0 = 0; q0 < NG; ++q0) {
        const int q = q0 + NG * q1 + NG * NG * q2;
        const long long qe = (long long)q * E + e;
        float b0[P1], d0[P1];
#pragma unroll
        for (int a = 0; a < P1; ++a) {
          b0[a] = T(0, q0, a);
          d0[a] = T(1, q0, a);
        }
        float ji[3][3];
        load_jinv<S>(jinv, q, e, E, ji);
        float dF[3][3], v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float g0 = 0.f, g1 = 0.f, g2 = 0.f, vc = 0.f;
#pragma unroll
          for (int a = 0; a < P1; ++a) {
            g0 += d0[a] * fw[c][0][a];
            g1 += b0[a] * fw[c][1][a];
            g2 += b0[a] * fw[c][2][a];
            vc += b0[a] * fw[c][0][a];
          }
          v[c] = vc;
#pragma unroll
          for (int f = 0; f < 3; ++f) dF[c][f] = g0 * ji[0][f] + g1 * ji[1][f] + g2 * ji[2][f];
        }
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
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int a = 0; a < P1; ++a) {
            bk[c][0][a] += d0[a] * Z[c][0] + b0[a] * mm[c];
            bk[c][1][a] += b0[a] * Z[c][1];
            bk[c][2][a] += b0[a] * Z[c][2];
          }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < P1; ++a) sh[L::a1(c, k, q2, q1, a)][lane] = bk[c][k][a];
  }
  __syncthreads();

  // (B') back along axis 1: B1 (D0 Z0 + B0 mm) + D1 (B0 Z1), B1 (B0 Z2)
#pragma unroll 1
  for (int i = grp; i < 3 * NG * P1; i += GROUPS) {
    const int c = i / (NG * P1), q2 = i / P1 % NG, a0 = i % P1;
    float x0[NG], x1[NG], x2[NG];
#pragma unroll
    for (int q1 = 0; q1 < NG; ++q1) {
      x0[q1] = sh[L::a1(c, 0, q2, q1, a0)][lane];
      x1[q1] = sh[L::a1(c, 1, q2, q1, a0)][lane];
      x2[q1] = sh[L::a1(c, 2, q2, q1, a0)][lane];
    }
#pragma unroll
    for (int a = 0; a < P1; ++a) {
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int q1 = 0; q1 < NG; ++q1) {
        const float b1 = T(2, q1, a);
        r0 += b1 * x0[q1] + T(3, q1, a) * x1[q1];
        r1 += b1 * x2[q1];
      }
      sh[L::a2(c, 0, q2, a * P1 + a0)][lane] = r0;
      sh[L::a2(c, 1, q2, a * P1 + a0)][lane] = r1;
    }
  }
  __syncthreads();

  // (A') back along axis 2: y[c][a2][a1][a0] = B2 r0 + D2 r1 over q2
#pragma unroll 1
  for (int i = grp; i < 3 * PP; i += GROUPS) {
    const int c = i / PP, a10 = i % PP;
    float y0[NG], y1[NG];
#pragma unroll
    for (int q2 = 0; q2 < NG; ++q2) {
      y0[q2] = sh[L::a2(c, 0, q2, a10)][lane];
      y1[q2] = sh[L::a2(c, 1, q2, a10)][lane];
    }
    if (live) {
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        float o = 0.f;
#pragma unroll
        for (int q2 = 0; q2 < NG; ++q2) o += T(4, q2, a) * y0[q2] + T(5, q2, a) * y1[q2];
        out[(long long)(c * ND + a * PP + a10) * E + e] = o;
      }
    }
  }
}

// the residual and assemble: sf_tile_kernel with SfResidualPoint up to
// p = 3, sf_axis_residual_kernel from p = 4 on
template <class S, class Mat, class Store, bool TANGENT, bool VISC, typename CT>
int launch_residual(const float* u_el, const float* a_el, const float* v_el,
                    const Tables& tb, const float* jinv, const float* wq, float* out,
                    void* cout, const Mat& mat, float rho, float mu_v, long long E,
                    void* stream) {
  if constexpr (S::P1 >= 5) {
    using L = AxisShared<S, VISC ? 2 : 1, 1>;
    if (const int err = allow_dynamic_smem<
            sf_axis_residual_kernel<S, Mat, Store, TANGENT, VISC, CT>>(L::SMEM))
      return err;
    const unsigned tiles = (unsigned)((E + L::TE - 1) / L::TE);
    sf_axis_residual_kernel<S, Mat, Store, TANGENT, VISC, CT>
        <<<tiles, AXIS_THREADS, L::SMEM, (cudaStream_t)stream>>>(
            mat, rho, mu_v, u_el, a_el, v_el, tb, jinv, wq, static_cast<CT*>(cout), out, E);
    return (int)cudaGetLastError();
  } else {
    using Pt = SfResidualPoint<S, Mat, Store, TANGENT, VISC, CT>;
    const Pt point{mat, rho, mu_v, a_el};
    if constexpr (Pt::DEALT)
      return launch_sf_dealt<S>(point, u_el, v_el, tb, jinv, wq, static_cast<CT*>(cout), out, E,
                                stream);
    else
      return launch_sf_tile<S>(point, u_el, a_el, v_el, tb, jinv, wq, static_cast<CT*>(cout),
                               out, E, stream);
  }
}

// the matvec: sf_tile_kernel with SfMatvecPoint up to p = 3,
// sf_axis_matvec_kernel from p = 4 on
template <class S, class Store, bool VISC, typename CT>
int launch_matvec(const float* w_el, const Tables& tb, const float* jinv,
                  const float* wq, const void* cb, float* out, float rho,
                  float fac0, float fac1_mu_v, long long E, void* stream) {
  if constexpr (S::P1 >= 5) {
    using L = AxisShared<S>;
    if (const int err = allow_dynamic_smem<sf_axis_matvec_kernel<S, Store, VISC, CT>>(L::SMEM))
      return err;
    const unsigned tiles = (unsigned)((E + L::TE - 1) / L::TE);
    sf_axis_matvec_kernel<S, Store, VISC, CT><<<tiles, AXIS_THREADS, L::SMEM, (cudaStream_t)stream>>>(
        w_el, tb, jinv, wq, static_cast<const CT*>(cb), out, rho, fac0, fac1_mu_v, E);
    return (int)cudaGetLastError();
  } else {
    const SfMatvecPoint<S, Store, VISC, CT> point{rho, fac0, fac1_mu_v};
    return launch_sf_tile<S>(point, w_el, nullptr, nullptr, tb, jinv, wq,
                             static_cast<const CT*>(cb), out, E, stream);
  }
}

}  // namespace
