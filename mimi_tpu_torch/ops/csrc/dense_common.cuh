// Shared by the dense-table CUDA sources (sweeps_dense.cu, sweeps_dense_j2.cu,
// sweeps_dense_finite.cu, their bfloat16 twins, fused_neohookean.cu), for
// sm_90a: the element's shape (dimension, dofs and points), staging of an
// element's dof values in shared memory, the per-point interpolation and
// scatter on dense tables dN (ND, DIM, NQ, E), N (ND, NQ, E), and the
// residual / assemble and matvec kernel templates with their launchers.
// The tangent block's element type (CT) and the matvec's tables' (TT) are
// template parameters, float or __nv_bfloat16, widened on load
// (materials.cuh load_c; a float load is the __ldg it always was).  Up to
// 27 dofs in 3D and 16 in 2D one thread per element; each thread owns one
// column of the shared arrays (dynamic shared memory, launch.cuh: 40.5 KB
// a block for the residual at 3D p = 2), so no barrier is needed.  Past
// that (DenseShape::TILED) the launchers take the tiled kernels below
// instead: the residual, assemble and matvec on owners of 8 nodes and a
// flux warp (dense_residual_tile_kernel, dense_matvec_tile_kernel), the
// fused neo-Hookean residual (and the 2D tangent apply) on point slots
// (dense_tile_kernel).  The
// residual and assemble of J2Simo and J2Log at every shape, and of J2 in
// 2D and on the tiled shapes, take dense_slot_kernel (one thread per
// element and point slot), 3D J2's up to 27 dofs, inviscid with a float32
// block, dense_ring_kernel (one thread per element, its rows copied ahead
// into shared memory; sweeps_dense_j2.cu j2_kernel).  Each
// translation unit instantiates its kernels at the one shape its build defines
// (MIMI_DENSE_DIM, MIMI_DENSE_ND, MIMI_DENSE_NQ: ops/build.py compiles the
// dense sources once per shape the step asks for, each shape into a
// library of its own).  The design notes are at the head of
// sweeps_dense.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"
#include "materials.cuh"

// The element type of the block that a dense source's assemble writes and
// its matvec reads, with the matvec's tables in the same type, and the
// names of its C entry points: float and the plain names, or, where the
// source defines MIMI_DENSE_BF16 before including its float32 twin
// (sweeps_dense_bf16.cu and the like), __nv_bfloat16 and the suffix _bf16.
#ifdef MIMI_DENSE_BF16
#define MIMI_DENSE_ENTRY(name) name##_bf16
#else
#define MIMI_DENSE_ENTRY(name) name
#endif

namespace {

#ifdef MIMI_DENSE_BF16
using DenseBlock = __nv_bfloat16;
#else
using DenseBlock = float;
#endif

// T in a context where it is not deduced (a pointer that may be nullptr)
template <class T>
struct same_type {
  using type = T;
};

constexpr int BLOCK = 64;
// elements of a dense_ring_kernel block
constexpr int DTILE_RING = 32;

using rn::add;
using rn::mul;

// An element on dense tables: DIM dimensions, ND dofs and NQ points.  The
// kernels loop over n < ND and q < NQ and use no per-axis structure, so
// one shape covers any degree ((p + 1)^DIM dofs), any quadrature order
// (NQ points) and degrees that differ per axis ((p0 + 1)(p1 + 1) dofs).
// TILED: the one-thread kernels hold DIM ND output sums a thread and spill
// past the shapes where ptxas keeps them in registers (3D: 27 dofs; 2D: 16,
// at 25 every one spilled 56-480 B at 255 registers), so past those the
// launchers take the tiled kernels, with SLOTS point slots (4; 8 past 64
// dofs, so that a thread owns 16 nodes at 3D p = 4 as at p = 3).
template <int DIM_, int ND_, int NQ_>
struct DenseShape {
  static_assert(DIM_ == 2 || DIM_ == 3, "2D or 3D");
  static constexpr int DIM = DIM_, ND = ND_, NQ = NQ_;
  static constexpr int NW = DIM * ND;  // values per element field
  static constexpr bool TILED = DIM == 2 ? ND > 16 : ND > 27;
  static constexpr int SLOTS = ND > 64 ? 8 : 4;
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
// bit; `row(k)` returns entry k = n DIM + f of the point's dN rows, `w(k)`
// value k of the element's field.  The loop over the nodes is unrolled 5
// at a time past 27 dofs (the tiled shapes, where the sums are no per-node
// registers): fully unrolled at 125 it made each (3, 125, 216) source take
// 62-129 s of nvcc, at 64 each (3, 64, 125) one 25-53 s
template <int DIM, int ND, class R, class W>
__device__ __forceinline__ void grad_rows(const R& row, const W& w, float G[DIM][DIM]) {
#pragma unroll
  for (int g = 0; g < DIM; ++g)
#pragma unroll
    for (int f = 0; f < DIM; ++f) G[g][f] = 0.f;
  const auto node = [&](int n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = row(n * DIM + f);
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      const float wv = w(g * ND + n);
#pragma unroll
      for (int f = 0; f < DIM; ++f) G[g][f] = add(G[g][f], mul(d[f], wv));
    }
  };
  if constexpr (ND <= 27) {
#pragma unroll
    for (int n = 0; n < ND; ++n) node(n);
  } else {
#pragma unroll 5
    for (int n = 0; n < ND; ++n) node(n);
  }
}

// grad_rows on the point's rows of the dense table dN (ND, DIM, NQ, E)
template <int DIM, int ND, typename TT, class W>
__device__ __forceinline__ void grad_q_of(const TT* __restrict__ dN, const W& w,
                                          long long qe, long long QE, float G[DIM][DIM]) {
  grad_rows<DIM, ND>([=](int k) { return load_c(dN + (long long)k * QE + qe); }, w, G);
}

// the gradient of the field staged in this thread's shared column
template <int DIM, int ND, typename TT>
__device__ __forceinline__ void grad_q(const TT* __restrict__ dN, float (*w)[BLOCK],
                                       long long qe, long long QE, float G[DIM][DIM]) {
  grad_q_of<DIM, ND>(dN, [w](int k) { return w[k][threadIdx.x]; }, qe, QE, G);
}

// v[c] = sum_n N[n](q) w(c ND + n), `nrow(n)` the point's N[n]
template <int DIM, int ND, class R, class W>
__device__ __forceinline__ void value_rows(const R& nrow, const W& w, float v[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) v[c] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float Nn = nrow(n);
#pragma unroll
    for (int c = 0; c < DIM; ++c) v[c] += Nn * w(c * ND + n);
  }
}

// value_rows on the dense table N (ND, NQ, E) and the field staged in this
// thread's shared column
template <int DIM, int ND, typename TT>
__device__ __forceinline__ void value_q(const TT* __restrict__ N, float (*w)[BLOCK],
                                        long long qe, long long QE, float v[DIM]) {
  value_rows<DIM, ND>([=](int n) { return load_c(N + (long long)n * QE + qe); },
                      [w](int k) { return w[k][threadIdx.x]; }, v);
}

// acc[c][n] += wq (sum_d dN[n][d] X[c][d] + N[n] m[c]), `row(k)` and
// `nrow(n)` the point's dN and N entries; without MASS the N[n] m[c] term
// is left out and N, m are not read
template <int DIM, int ND, bool MASS, class R, class NR>
__device__ __forceinline__ void scatter_rows(float (&acc)[DIM][ND], const R& row, const NR& nrow,
                                             float wq, const float X[DIM][DIM],
                                             const float* m) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = row(n * DIM + f);
    const float Nn = MASS ? nrow(n) : 0.f;
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

// scatter_rows on the dense tables dN, N
template <int DIM, int ND, bool MASS = true, typename TT>
__device__ __forceinline__ void scatter_q(float (&acc)[DIM][ND], const TT* __restrict__ dN,
                                          const typename same_type<TT>::type* __restrict__ N,
                                          long long qe, long long QE, float wq,
                                          const float X[DIM][DIM], const float* m) {
  scatter_rows<DIM, ND, MASS>(
      acc, [=](int k) { return load_c(dN + (long long)k * QE + qe); },
      [=](int n) { return MASS ? load_c(N + (long long)n * QE + qe) : 0.f; }, wq, X, m);
}

inline unsigned grid_for(long long E) { return (unsigned)((E + BLOCK - 1) / BLOCK); }

// ---- kernels ---------------------------------------------------------------

// Residual y[c][n] = sum_q wq (dN[n][d] P(F)[c][d] + N[n] rho a_q[c]),
// F = I + grad u; with TANGENT also the tangent block of `Store` (the
// assemble).  `Mat` forms P and the point's tangent data from F and, for a
// material with state, the point's state leaves (`eval`).  With VISC the
// viscous flux mu_v grad v joins P before the scatter (the tangent block
// does not change).  v is read from device memory at each point, not
// staged: a third staged field would take 62 KB of shared memory at 3D
// p = 2 (144 KB at p = 3) and halve the blocks an SM holds; its rows come
// from L1 or L2 after the first point.  The block is stored in CT (float,
// or bfloat16 rounded to nearest even); the tables are read in float32.
template <class Mat, class Store, class S, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(BLOCK)
    dense_residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                          const float* __restrict__ v_el, const float* __restrict__ dN,
                          const float* __restrict__ N, const float* __restrict__ wq,
                          float* __restrict__ out, CT* __restrict__ cout, Mat mat,
                          float rho, float mu_v, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND;
  MIMI_DYNAMIC_SHARED(float, smem);  // su[NW][BLOCK], sa[NW][BLOCK]
  float(*su)[BLOCK] = reinterpret_cast<float(*)[BLOCK]>(smem);
  float(*sa)[BLOCK] = su + S::NW;
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

// dense_residual_kernel's operations with the point's dN and N rows of
// the thread's element brought into shared memory ahead (3D J2 up to 27
// dofs, inviscid, float32 block: sweeps_dense_j2.cu j2_kernel): a tile of
// DTILE_RING = 32
// consecutive elements a block (one warp), one per thread, u and a staged
// as there; each thread copies its own element's DIM ND + ND rows of point
// q + 1 (cp.async, 4 bytes each, one 128-byte line a warp, cached in L1)
// into its own column of a ring of RingTile::STAGES points while it
// computes point q, and reads point q's rows from its column: no barrier.
// grad_rows, value_rows and scatter_rows run as in dense_residual_kernel,
// so the outputs are its outputs to the bit.  What it changes: the rows'
// loads no longer wait in the point's chain, and without a register pair
// per row address ptxas keeps a thread at 167-168 registers, 0 B spilled
// (dense_residual_kernel: 255, 360-384 B); but the tile's 48.4 KB leave 4
// warps an SM against the one-thread kernel's 8 (PERF.md: 1.01-1.09x at
// the driven elastic states, 0.64-0.80x on random plastic input; 16-byte
// copies with a warp barrier, 0.74-0.82x; the N rows left out of the ring
// for 5 warps an SM, 0.98-1.05x).
template <class S>
struct RingTile {
  static constexpr int STAGES = 2, ROWS = S::NW + S::ND;  // a point's dN and N rows
  static constexpr size_t BYTES = sizeof(float) * DTILE_RING * (2 * S::NW + STAGES * ROWS);
};

template <class Mat, class Store, class S, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(DTILE_RING)
    dense_ring_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                      const float* __restrict__ v_el, const float* __restrict__ dN,
                      const float* __restrict__ N, const float* __restrict__ wq,
                      float* __restrict__ out, CT* __restrict__ cout, Mat mat, float rho,
                      float mu_v, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ;
  constexpr int STAGES = RingTile<S>::STAGES, ROWS = RingTile<S>::ROWS, T = DTILE_RING;
  MIMI_DYNAMIC_SHARED(float, smem);  // su[NW][T], sa[NW][T], ring[STAGES][ROWS][T]
  float(*su)[T] = reinterpret_cast<float(*)[T]>(smem);
  float(*sa)[T] = su + NW;
  float(*ring)[ROWS][T] = reinterpret_cast<float(*)[ROWS][T]>(smem + 2 * NW * T);
  const int lane = threadIdx.x;
  const long long e = (long long)blockIdx.x * T + lane;
  if (e >= E) return;  // a thread reads only its own column: no barrier below
#pragma unroll 8
  for (int k = 0; k < NW; ++k) {
    su[k][lane] = __ldg(u_el + (long long)k * E + e);
    sa[k][lane] = __ldg(a_el + (long long)k * E + e);
  }
  const long long QE = (long long)NQ * E;
  // point q's rows of this thread's element into its ring column
  const auto fetch = [&](int q) {
    float(*r)[T] = ring[q % STAGES];
    const long long qe = (long long)q * E + e;
#pragma unroll 9
    for (int k = 0; k < NW; ++k) cp_async4(&r[k][lane], dN + (long long)k * QE + qe);
#pragma unroll 9
    for (int n = 0; n < ND; ++n) cp_async4(&r[NW + n][lane], N + (long long)n * QE + qe);
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) fetch(q);
  float acc[DIM][ND];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    if (q + STAGES - 1 < NQ)
      fetch(q + STAGES - 1);
    else
      cp_async_commit();  // an empty group: the wait below counts groups
    cp_async_wait<STAGES - 1>();  // point q's rows have landed
    const float(*r)[T] = ring[q % STAGES];
    const auto row = [=](int k) { return r[k][lane]; };
    const auto nrow = [=](int n) { return r[NW + n][lane]; };
    const long long qe = (long long)q * E + e;
    float F[DIM][DIM];
    grad_rows<DIM, ND>(row, [=](int k) { return su[k][lane]; }, F);
#pragma unroll
    for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
    float Pk[DIM][DIM];
    typename Mat::Point pt;
    mat.template eval<TANGENT>(F, qe, QE, Pk, pt);
    if (TANGENT) Store::store(cout, qe, QE, mat, pt);
    if (VISC) {  // P + mu_v dV, in the plain version's order
      float dV[DIM][DIM];
      grad_rows<DIM, ND>(row, [=](int k) { return __ldg(v_el + (long long)k * E + e); }, dV);
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) Pk[c][d] = add(Pk[c][d], mul(mu_v, dV[c][d]));
    }
    float av[DIM], m[DIM];
    value_rows<DIM, ND>(nrow, [=](int k) { return sa[k][lane]; }, av);
#pragma unroll
    for (int c = 0; c < DIM; ++c) m[c] = rho * av[c];
    scatter_rows<DIM, ND, true>(acc, row, nrow, __ldg(wq + qe), Pk, m);
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

// y = J w: y[c][n] = sum_q wq (dN[n][d] dP[c][d] + N[n] rho w_q[c]),
// dP = fac0 C : grad w from the tangent block of `Store`, + fac1 mu_v grad w
// with VISC; the block in CT and the tables dN, N in TT (float, or the
// bfloat16 copies of the matvec's table streams), each widened on load
template <class Store, class S, bool VISC, typename CT, typename TT>
__global__ void __launch_bounds__(BLOCK)
    dense_matvec_kernel(const float* __restrict__ w_el, const TT* __restrict__ dN,
                        const TT* __restrict__ N, const float* __restrict__ wq,
                        const CT* __restrict__ cs, float* __restrict__ out, float rho,
                        float fac0, float fac1_mu_v, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND;
  MIMI_DYNAMIC_SHARED(float, smem);  // sw[NW][BLOCK]
  float(*sw)[BLOCK] = reinterpret_cast<float(*)[BLOCK]>(smem);
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

// ---- the tiled kernels (S::TILED: 3D p >= 3, 2D p >= 4) -------------------------
//
// At (3, 3) a thread of the kernels above would hold 192 output sums: they
// spill to local memory, and the two staged fields take 96 KB a block (2
// blocks, 4 warps an SM).  The tiled kernels take a tile of DTILE = 32
// consecutive elements a block, one per lane, so that every table read of
// a warp is one 128-byte line.  The residual, assemble and matvec split a
// block into owner warps, each lane of which holds the dN and N rows of
// its nodes at a point in registers from the point's partial sums to the
// scatter, and one flux warp that runs the point's material or block
// (dense_residual_tile_kernel, dense_matvec_tile_kernel below): dN and N
// cross device memory once; the fused neo-Hookean tangent apply takes the
// same design in 3D (fused_neohookean.cu).  The fused neo-Hookean residual,
// and the tangent apply on the tiled 2D shapes, keep the point slots of
// dense_tile_kernel: warp s takes the points q = s (mod SLOTS) of every
// element, forms the point's F from its lane's staged column and the
// point's dN row (grad_q_of's operations), runs the point and hands X[c][d]
// and w det J to shared memory; after a barrier each thread adds the
// round's SLOTS points, in q order, to the outputs of the nodes
// n = s + SLOTS j it owns, reading those nodes' dN rows again (scatter_q's
// operations, no mass term).  Shared memory of dense_tile_kernel: the
// staged field(s) [DIM ND][DTILE] and the round's points; the second field
// (the tangent apply's w) is staged only where both fit in a block's 227 KB
// and read from device memory otherwise.

constexpr int DTILE = 32;

// what one point hands to its nodes' owners: X[c][d], m[c] and w det J
template <int DIM>
struct TileStage {
  static constexpr int M = DIM * DIM, W = DIM * DIM + DIM, N = DIM * DIM + DIM + 1;
};

// dense_tile_kernel's shared memory with NF fields: the first field staged,
// the second (NF = 2) where both fit in a block's shared memory, and the
// round's points (PS floats each)
template <class S, int NF>
struct DenseTile {
  static constexpr int PS = S::DIM * S::DIM + 1;
  static constexpr size_t stage_floats = (size_t)DTILE * S::SLOTS * PS;
  static constexpr int STAGED =
      sizeof(float) * (stage_floats + (size_t)DTILE * NF * S::NW) <= BLOCK_SMEM_MAX ? NF : 1;
  static constexpr size_t BYTES = sizeof(float) * (stage_floats + (size_t)DTILE * STAGED * S::NW);
  static_assert(BYTES <= BLOCK_SMEM_MAX, "one field and the round's points exceed a block");
};

// v[c] = sum_n N[n](q) w(c ND + n), as value_q
template <int DIM, int ND, typename TT, class W>
__device__ __forceinline__ void value_q_of(const TT* __restrict__ N, const W& w,
                                           long long qe, long long QE, float v[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) v[c] = 0.f;
#pragma unroll 8
  for (int n = 0; n < ND; ++n) {
    const float Nn = load_c(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < DIM; ++c) v[c] += Nn * w(c * ND + n);
  }
}

// y[c][n] = sum_q wq dN[n][d] X[c][d] with the point's flux X from `point`
// (a fused neo-Hookean point, fused_neohookean.cu: X from the point's F,
// `s0` the lane's staged column, and the second field's values f1(k)) on
// the NF fields f0 (and f1; staged as DenseTile says)
template <class S, int NF, class Pt>
__global__ void __launch_bounds__(DTILE * S::SLOTS)
    dense_tile_kernel(Pt point, const float* __restrict__ f0, const float* __restrict__ f1,
                      const float* __restrict__ dN, const float* __restrict__ wq,
                      float* __restrict__ out, long long E) {
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, DSLOTS = S::SLOTS;
  constexpr int OWN_NODES = (ND + DSLOTS - 1) / DSLOTS, SF = DenseTile<S, NF>::STAGED;
  constexpr int PS = DenseTile<S, NF>::PS, W = PS - 1;  // a point's X[c][d] and w det J
  MIMI_DYNAMIC_SHARED(float, smem);  // s0[NW][DTILE] (, s1[NW][DTILE]), st[DSLOTS][PS][DTILE]
  float(*s0)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem);
  float(*s1)[DTILE] = s0 + (SF > 1 ? NW : 0);
  float(*st)[PS][DTILE] = reinterpret_cast<float(*)[PS][DTILE]>(s0 + SF * NW);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  for (int r = slot; r < NW; r += DSLOTS) {
    const long long off = (long long)r * E + e;
    s0[r][lane] = live ? __ldg(f0 + off) : 0.f;
    if (SF > 1) s1[r][lane] = live ? __ldg(f1 + off) : 0.f;
  }
  __syncthreads();
  // value k of the lane's element's second field
  const auto field1 = [=](int k) {
    if constexpr (SF > 1)
      return s1[k][lane];
    else
      return __ldg(f1 + (long long)k * E + e);
  };
  float acc[OWN_NODES][DIM];
#pragma unroll
  for (int j = 0; j < OWN_NODES; ++j)
#pragma unroll
    for (int c = 0; c < DIM; ++c) acc[j][c] = 0.f;
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q0 = 0; q0 < NQ; q0 += DSLOTS) {
    const int q = q0 + slot;
    if (live && q < NQ) {  // the last round is partial where DSLOTS does not divide NQ
      const long long qe = (long long)q * E + e;
      float X[DIM][DIM];
      point(s0, field1, lane, qe, QE, X);
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) st[slot][c * DIM + d][lane] = X[c][d];
      st[slot][W][lane] = __ldg(wq + qe);
    }
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (int s = 0; s < DSLOTS && q0 + s < NQ; ++s) {
        const long long qe = (long long)(q0 + s) * E + e;
        const float(*p)[DTILE] = st[s];
#pragma unroll
        for (int j = 0; j < OWN_NODES; ++j) {
          const int n = slot + DSLOTS * j;
          if (n < ND) {  // scatter_q's operations for node n, no mass term
            float d[DIM];
#pragma unroll
            for (int f = 0; f < DIM; ++f) d[f] = __ldg(dN + (long long)(n * DIM + f) * QE + qe);
#pragma unroll
            for (int c = 0; c < DIM; ++c) {
              float x = d[0] * p[c * DIM][lane];
#pragma unroll
              for (int f = 1; f < DIM; ++f) x += d[f] * p[c * DIM + f][lane];
              acc[j][c] += p[W][lane] * x;
            }
          }
        }
      }
    }
    __syncthreads();  // the round's points are read before the next overwrites them
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < OWN_NODES; ++j) {
      const int n = slot + DSLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c) out[(long long)(c * ND + n) * E + e] = acc[j][c];
    }
  }
}

template <class S, int NF, class Pt>
int launch_dense_tile(const Pt& point, const float* f0, const float* f1, const float* dN,
                      const float* wq, float* out, long long E, void* stream) {
  constexpr size_t smem = DenseTile<S, NF>::BYTES;
  if (const int err = allow_dynamic_smem<dense_tile_kernel<S, NF, Pt>>(smem)) return err;
  const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
  dense_tile_kernel<S, NF, Pt><<<tiles, DTILE * S::SLOTS, smem, (cudaStream_t)stream>>>(
      point, f0, f1, dN, wq, out, E);
  return (int)cudaGetLastError();
}

// ---- the tiled matvec: every dN and N entry loaded once ------------------------
//
// y = J w on the tiled shapes.  What bounds it on the H100 is bytes: per
// element and point it reads DIM ND + ND table entries (256 floats at
// (3, 64, 125)) against the block's 10-81 planes, so dN and N are ~85% of
// its traffic at path I's 2 x 38^3 (14.0 of 16.7 GB, 5.00 ms at 3.35
// TB/s).  dense_tile_kernel read each entry twice (the point's gradient,
// then each node's owner for the scatter: 30.8 GB).  Here the nodes'
// owners carry the tables.  A block takes DTILE = 32 consecutive elements,
// one per lane, in MatvecTile::SLOTS owner warps and one flux warp; the
// owner (slot s, lane) holds the nodes n = s + SLOTS j, at most 8 up to
// 128 nodes; past that SLOTS stays 16 (544 threads) and an owner holds
// more (14 at 3D p = 5, 22 at p = 6), so the block stays within 1024.  For
// each point q in turn an owner loads dN[n][:][q] and N[n][q] of its nodes
// into registers (one 128-byte line a warp each, 32 floats at (3, 64, 125)),
// adds its nodes' share of grad w and w (DIM^2 + DIM partial sums, one
// component at a time) and hands the partials to shared memory.  After a
// barrier the flux warp sums the SLOTS partials in slot order, applies the
// block (Store::apply, its rows asked for in L1 a point ahead: prefetch_l1)
// with fac1 mu_v grad w, and hands X, m = rho w and w det J to shared
// memory; after a second barrier each owner adds wq (dN[n] . X[c] + N[n]
// m[c]) to its nodes' sums from the same registers, points in q order: no
// atomics, deterministic.  The owners' sums are fused multiply-adds
// (fmaf) in every source, -fmad=false ones too: without them the
// finite-strain source's float32 full matvec spilled 8-12 B at 3D.  The two roles
// run loops of their own with the same barriers, so an owner's registers
// never hold the block's planes nor the flux warp's the tables; both form
// their rows' addresses at each point from an opaque QE (launch.cuh), not
// from a register pair per row kept across the loop.  ptxas (CUDA 12.8):
// 96 registers in 3D, 82-96 in 2D, 0 B spilled; 2 blocks (18 warps) an SM
// at (3, 64, 125), 1 (17 warps) at (3, 125, 216), 4 (20 warps) at
// (2, 25, 36).  The gradient's sum over n is regrouped by slot, so outputs
// differ from dense_tile_kernel's by float32 rounding (<= 1e-6 of their
// max).  Shared memory: the staged w [DIM ND][DTILE], the partials
// [SLOTS][DIM^2 + DIM][DTILE] and one point's flux [DIM^2 + DIM + 1][DTILE]:
// 38.8 KB at (3, 64, 125) (8 owner warps), 74.2 KB at (3, 125, 216) (16),
// 10.4 KB at (2, 25, 36) (4).  Tried and dropped (scripts/ab_dense_sweeps.py
// --part tiled): asking L2 for the next point's rows (8.67 against 7.48 ms
// at path I), holding two points' rows (11.9 ms: one block an SM), blocks
// that walk the tiles together (0.93x), 3 points a step in 2D (0.87x);
// the full storage's rows one at a time (12.02 against 9.50 ms, three at
// a time: FluxApply).
// The flux warp's apply of the block to dF, X into st[c DIM + d][lane]
// (+ fac1 mu_v dF viscous): the storage's own apply, but the full
// storage's rows DIM at a time (a rolled loop over P's components, fused
// multiply-adds, each row's sum straight to shared memory): in the
// finite-strain source, built without FMA, its 81 unrolled products kept
// too many loads in flight and spilled 8-12 B at 96 registers.
template <class Store, bool VISC, int DIM, typename CT>
struct FluxApply {
  __device__ __forceinline__ static void apply(const CT* __restrict__ cs, long long qe,
                                               long long QE, const float dF[DIM][DIM],
                                               float fac0, float fac1_mu_v,
                                               float (*st)[DTILE], int lane) {
    float X[DIM][DIM];
    Store::apply(cs, qe, QE, dF, fac0, X);
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        st[c * DIM + d][lane] = VISC ? add(X[c][d], mul(fac1_mu_v, dF[c][d])) : X[c][d];
  }
};

template <bool VISC, int DIM, typename CT>
struct FluxApply<FullStorage<DIM>, VISC, DIM, CT> {
  __device__ __forceinline__ static void apply(const CT* __restrict__ cf, long long qe,
                                               long long QE, const float dF[DIM][DIM],
                                               float fac0, float fac1_mu_v,
                                               float (*st)[DTILE], int lane) {
    constexpr int D2 = DIM * DIM;
#pragma unroll 1
    for (int c = 0; c < DIM; ++c) {  // the DIM rows of P's component c
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const int a = c * DIM + d;
        const CT* row = cf + (long long)(a * D2) * QE + qe;
        float s = load_c(row) * dF[0][0];
#pragma unroll
        for (int b = 1; b < D2; ++b) s = fmaf(load_c(row + b * QE), dF[b / DIM][b % DIM], s);
        float x = fac0 * s;
        if (VISC) {
          float dFa = dF[0][d];  // dF[c][d] without a dynamic index
#pragma unroll
          for (int k = 1; k < DIM; ++k)
            if (k == c) dFa = dF[k][d];
          x = add(x, mul(fac1_mu_v, dFa));
        }
        st[a][lane] = x;
      }
    }
  }
};

template <class S>
struct MatvecTile {
  // owner warps: 8 nodes each up to 128 nodes, past that 16 warps (3D
  // p = 5: 14 nodes each), so that a block stays within 1024 threads
  static constexpr int SLOTS = (S::ND + 7) / 8 < 16 ? (S::ND + 7) / 8 : 16;
  static constexpr int OWN = (S::ND + SLOTS - 1) / SLOTS;
  static constexpr int THREADS = DTILE * (SLOTS + 1);
  static_assert(THREADS <= 1024, "a block has at most 1024 threads");
  static constexpr int MIN_BLOCKS = THREADS <= 288 ? 2 : 1;
  static constexpr size_t SMEM =
      sizeof(float) * DTILE * (S::NW + (SLOTS + 1) * TileStage<S::DIM>::W + 1);
};

template <class Store, class S, bool VISC, typename CT, typename TT>
__global__ void __launch_bounds__(MatvecTile<S>::THREADS, MatvecTile<S>::MIN_BLOCKS)
    dense_matvec_tile_kernel(const float* __restrict__ w_el, const TT* __restrict__ dN,
                             const TT* __restrict__ N, const float* __restrict__ wq,
                             const CT* __restrict__ cs, float* __restrict__ out, float rho,
                             float fac0, float fac1_mu_v, long long E) {
  using T = TileStage<S::DIM>;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ;
  constexpr int SLOTS = MatvecTile<S>::SLOTS, OWN = MatvecTile<S>::OWN, G = T::W;
  MIMI_DYNAMIC_SHARED(float, smem);  // sw[NW][DTILE], part[SLOTS][G][DTILE], st[T::N][DTILE]
  float(*sw)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem);
  float(*part)[G][DTILE] = reinterpret_cast<float(*)[G][DTILE]>(smem + NW * DTILE);
  float(*st)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem + (NW + SLOTS * G) * DTILE);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  for (int r = slot; r < NW; r += SLOTS + 1)
    sw[r][lane] = live ? __ldg(w_el + (long long)r * E + e) : 0.f;
  __syncthreads();
  const long long QE = (long long)NQ * E;
  if (slot == SLOTS) {  // the flux warp: two barriers a point, as the owners
    // the point's rows, into L1 ahead of the apply
    const auto ask = [&](long long qe, long long QEq) {
      for (int k = 0; k < Store::kPlanes; ++k) prefetch_l1(cs + k * QEq + qe);
      prefetch_l1(wq + qe);
    };
    if (live) ask(e, QE);
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      __syncthreads();
      if (live) {
        // the planes' addresses formed here, from an opaque QE, as the owners'
        const long long qe = (long long)q * E + e, QEq = opaque(QE);
        float dF[DIM][DIM], v[DIM];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          float s = part[0][k][lane];
#pragma unroll
          for (int p = 1; p < SLOTS; ++p) s += part[p][k][lane];
          if (k < T::M)
            dF[k / DIM][k % DIM] = s;
          else
            v[k - T::M] = s;
        }
        FluxApply<Store, VISC, DIM, CT>::apply(cs, qe, QEq, dF, fac0, fac1_mu_v, st, lane);
#pragma unroll
        for (int c = 0; c < DIM; ++c) st[T::M + c][lane] = rho * v[c];
        st[T::W][lane] = __ldg(wq + qe);
        if (q + 1 < NQ) ask(qe + E, QEq);
      }
      __syncthreads();
    }
    return;
  }
  // the owners
  float acc[OWN][DIM];
#pragma unroll
  for (int j = 0; j < OWN; ++j)
#pragma unroll
    for (int c = 0; c < DIM; ++c) acc[j][c] = 0.f;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    // this thread's nodes' tables at q, loaded once (the row addresses
    // formed here, from an opaque QE, not kept in registers across points)
    const long long qe = (long long)q * E + e, QEq = opaque(QE);
    float d[OWN][DIM], nv[OWN];
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      const bool own = live && n < ND;
#pragma unroll
      for (int f = 0; f < DIM; ++f)
        d[j][f] = own ? load_c(dN + (long long)(n * DIM + f) * QEq + qe) : 0.f;
      nv[j] = own ? load_c(N + (long long)n * QEq + qe) : 0.f;
    }
    // this thread's share of grad w and w, one component g at a time
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      float gp[DIM + 1] = {};
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        const int n = slot + SLOTS * j;
        if (n < ND) {
          const float wv = sw[g * ND + n][lane];
#pragma unroll
          for (int f = 0; f < DIM; ++f) gp[f] = fmaf(d[j][f], wv, gp[f]);
          gp[DIM] = fmaf(nv[j], wv, gp[DIM]);
        }
      }
#pragma unroll
      for (int f = 0; f < DIM; ++f) part[slot][g * DIM + f][lane] = gp[f];
      part[slot][T::M + g][lane] = gp[DIM];
    }
    __syncthreads();  // the flux warp reads the partials
    __syncthreads();  // and has written the point's flux
    if (live) {  // the scatter for this thread's nodes, from the same registers
      const float wqv = st[T::W][lane];
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        if (slot + SLOTS * j < ND) {
#pragma unroll
          for (int c = 0; c < DIM; ++c) {
            float x = d[j][0] * st[c * DIM][lane];
#pragma unroll
            for (int f = 1; f < DIM; ++f) x = fmaf(d[j][f], st[c * DIM + f][lane], x);
            x = fmaf(nv[j], st[T::M + c][lane], x);
            acc[j][c] = fmaf(wqv, x, acc[j][c]);
          }
        }
      }
    }
    // no third barrier: the next point writes `part` after its reader (the
    // flux warp) passed the barrier above, and the flux warp writes `st`
    // after the next point's first barrier, which every owner reaches after
    // its scatter
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c) out[(long long)(c * ND + n) * E + e] = acc[j][c];
    }
  }
}

// ---- the tiled residual and assemble: every dN and N entry loaded once -------------
//
// y[c][n] = sum_q wq (dN[n][d] P(F)[c][d] + N[n] rho a_q[c]) (+ mu_v grad v
// in P, viscous) and, with TANGENT, the point's block of `Store`, on the
// tiled shapes, for the hyperelastic materials and J2Linear (J2, J2Simo and
// J2Log take dense_slot_kernel below: a return map's trips on one flux
// warp a block ran at 0.6x the point slots).  What bounds it on the H100
// is bytes: per element and point it reads DIM ND + ND table entries (256
// floats at (3, 64, 125)), 4.29 ms of the residual's and 5.02 of the
// assemble's bound at path I's 2 x 38^3.  The point-slot kernel it
// replaces read dN twice from device memory (each point's F, then each
// node's owner for the scatter, 4 points apart).  This one is the tiled
// matvec's design (dense_matvec_tile_kernel above): a block takes DTILE =
// 32 consecutive elements, one per lane, in MatvecTile::SLOTS owner warps
// and one flux warp.  For each point q in turn an owner (slot s, lane)
// loads dN[n][:][q] and N[n][q] of its nodes n = s + SLOTS j into
// registers, copies the dN rows to shared memory and hands its nodes'
// share of a's value (and of grad v, viscous), fused multiply-adds, to
// shared memory.  After a barrier every warp, the flux warp too, sums
// entries of grad u over all the nodes from those rows, in n order without
// FMA (grad_q_of's operations: entry c on warp c mod (SLOTS + 1)), so
// that F is the plain version's to the bit: the materials cancel F near
// F = I (mu (F - F^-T), det F - 1, the trial strain sym(F) - I), where
// grad u summed by slot moved the residual by 1.5e-4 of its max at path
// L's state (6.8e-6 with the diagonal alone summed in n order: det F's
// off-diagonal products), and a warp that summed its entries from device
// memory waited on a load a few nodes, at 2x the time.  After a second
// barrier the flux warp forms F, sums the SLOTS partials in slot order,
// runs the material (`Mat::eval`), stores the point's block
// (`Store::store`, the assemble) and hands X = P (+ mu_v grad v),
// m = rho a and w det J to shared memory; after a third barrier each
// owner adds wq (dN[n] . X[c] + N[n] m[c]) to its nodes' sums from the
// same registers, points in q order: no atomics, deterministic.  a's value
// and grad v are regrouped by slot (float32 rounding against the plain
// version; neither cancels).  The fields u, a (and v) are staged in
// shared memory as [DIM ND][DTILE] in that order while they fit in a
// block's 227 KB, the rest read from device memory (ResidualTile::STAGED:
// none at 3D p = 6).  Shared memory at (3, 64, 125): 79.6 KB a block (2
// blocks an SM), 113.4 KB viscous (one block an SM); at (2, 25, 36)
// 21.6 KB; at (3, 343, 512) 140.7 KB, no field staged.
template <class S, bool VISC>
struct ResidualTile {
  using MT = MatvecTile<S>;
  static constexpr int DIM = S::DIM, D2 = DIM * DIM;
  // a slot's partials: a's value (DIM) and, viscous, grad v (D2)
  static constexpr int G = DIM + (VISC ? D2 : 0);
  // the partials, the point's dN rows [ND DIM][DTILE], grad u [D2][DTILE]
  // and the point's flux
  static constexpr size_t REST =
      (size_t)DTILE * (MT::SLOTS * G + S::NW + D2 + TileStage<DIM>::N);
  static constexpr int stage_count() {
    int n = VISC ? 3 : 2;
    while (n > 0 && sizeof(float) * (REST + (size_t)DTILE * n * S::NW) > BLOCK_SMEM_MAX) --n;
    return n;
  }
  static constexpr int STAGED = stage_count();
  static constexpr size_t BYTES = sizeof(float) * (REST + (size_t)DTILE * STAGED * S::NW);
  static_assert(BYTES <= BLOCK_SMEM_MAX, "the point's rows and the partials exceed a block");
};

template <class Mat, class Store, class S, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(MatvecTile<S>::THREADS, MatvecTile<S>::MIN_BLOCKS)
    dense_residual_tile_kernel(Mat mat, const float* __restrict__ u_el,
                               const float* __restrict__ a_el, const float* __restrict__ v_el,
                               const float* __restrict__ dN, const float* __restrict__ N,
                               const float* __restrict__ wq, float* __restrict__ out,
                               CT* __restrict__ cout, float rho, float mu_v, long long E) {
  using T = TileStage<S::DIM>;
  using RT = ResidualTile<S, VISC>;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, D2 = RT::D2, G = RT::G;
  constexpr int SLOTS = MatvecTile<S>::SLOTS, OWN = MatvecTile<S>::OWN, NF = RT::STAGED;
  // staged[NF][NW][DTILE], part[SLOTS][G][DTILE], rows[NW][DTILE],
  // gu[D2][DTILE], st[T::N][DTILE]
  MIMI_DYNAMIC_SHARED(float, smem);
  float(*staged)[NW][DTILE] = reinterpret_cast<float(*)[NW][DTILE]>(smem);
  float(*part)[G][DTILE] = reinterpret_cast<float(*)[G][DTILE]>(smem + NF * NW * DTILE);
  float(*rows)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem + (NF * NW + SLOTS * G) * DTILE);
  float(*gu)[DTILE] = rows + NW;
  float(*st)[DTILE] = gu + D2;
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  const float* const fields[3] = {u_el, a_el, v_el};
  for (int r = slot; r < NW; r += SLOTS + 1)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      staged[f][r][lane] = live ? __ldg(fields[f] + (long long)r * E + e) : 0.f;
  __syncthreads();
  // value k of field f of the lane's element, staged or from device memory
  const auto field = [=](int f, int k) {
    return f < NF ? staged[f][k][lane] : live ? __ldg(fields[f] + (long long)k * E + e) : 0.f;
  };
  // the entries c = g DIM + f, c = slot (mod SLOTS + 1), of grad u at the
  // point whose dN rows are in `rows`: sum_n dN[n][f] u[g][n] in n order
  // without FMA (grad_q_of's operations, so F is the plain version's)
  const auto gradient = [&]() {
#pragma unroll 1
    for (int c = slot; c < D2; c += SLOTS + 1) {
      const int g = c / DIM, f = c % DIM;
      float x = 0.f;
#pragma unroll 8
      for (int n = 0; n < ND; ++n) x = add(x, mul(rows[n * DIM + f][lane], field(0, g * ND + n)));
      gu[c][lane] = x;
    }
  };
  const long long QE = (long long)NQ * E;
  if (slot == SLOTS) {  // the flux warp: three barriers a point, as the owners
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      __syncthreads();  // the owners wrote the point's rows
      gradient();
      __syncthreads();  // grad u and the partials are written
      if (live) {
        const long long qe = (long long)q * E + e, QEq = opaque(QE);
        float F[DIM][DIM], av[DIM], dV[DIM][DIM];
#pragma unroll
        for (int k = 0; k < D2; ++k) F[k / DIM][k % DIM] = gu[k][lane];
#pragma unroll
        for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
#pragma unroll
        for (int k = 0; k < G; ++k) {
          float s = part[0][k][lane];
#pragma unroll
          for (int p = 1; p < SLOTS; ++p) s = add(s, part[p][k][lane]);
          if (k < DIM)
            av[k] = s;
          else
            dV[(k - DIM) / DIM][(k - DIM) % DIM] = s;
        }
        float X[DIM][DIM];
        typename Mat::Point pt;
        mat.template eval<TANGENT>(F, qe, QEq, X, pt);
        if (TANGENT) Store::store(cout, qe, QEq, mat, pt);
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
#pragma unroll
          for (int d = 0; d < DIM; ++d)  // P + mu_v dV, in the plain version's order
            st[c * DIM + d][lane] = VISC ? add(X[c][d], mul(mu_v, dV[c][d])) : X[c][d];
          st[T::M + c][lane] = rho * av[c];
        }
        st[T::W][lane] = __ldg(wq + qe);
      }
      __syncthreads();
    }
    return;
  }
  // the owners
  float acc[OWN][DIM];
#pragma unroll
  for (int j = 0; j < OWN; ++j)
#pragma unroll
    for (int c = 0; c < DIM; ++c) acc[j][c] = 0.f;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    // this thread's nodes' tables at q, loaded once (the row addresses
    // formed here, from an opaque QE, as the tiled matvec's), the dN rows
    // also into shared memory for the gradient
    const long long qe = (long long)q * E + e, QEq = opaque(QE);
    float d[OWN][DIM], nv[OWN];
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      const bool own = live && n < ND;
#pragma unroll
      for (int f = 0; f < DIM; ++f)
        d[j][f] = own ? __ldg(dN + (long long)(n * DIM + f) * QEq + qe) : 0.f;
      nv[j] = own ? __ldg(N + (long long)n * QEq + qe) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < OWN; ++j)
      if (slot + SLOTS * j < ND)
#pragma unroll
        for (int f = 0; f < DIM; ++f) rows[(slot + SLOTS * j) * DIM + f][lane] = d[j][f];
    // this thread's share of a (and grad v), one component g at a time
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      float gv[DIM] = {}, ga = 0.f;
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        const int n = slot + SLOTS * j;
        if (n < ND) {
          ga = fmaf(nv[j], field(1, g * ND + n), ga);
          if (VISC) {
            const float vv = field(2, g * ND + n);
#pragma unroll
            for (int f = 0; f < DIM; ++f) gv[f] = fmaf(d[j][f], vv, gv[f]);
          }
        }
      }
      part[slot][g][lane] = ga;
      if (VISC)
#pragma unroll
        for (int f = 0; f < DIM; ++f) part[slot][DIM + g * DIM + f][lane] = gv[f];
    }
    __syncthreads();  // the point's rows are in shared memory
    gradient();
    __syncthreads();  // the flux warp reads grad u and the partials
    __syncthreads();  // and has written the point's flux
    if (live) {  // the scatter for this thread's nodes, from the same registers
      const float wqv = st[T::W][lane];
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        if (slot + SLOTS * j < ND) {
#pragma unroll
          for (int c = 0; c < DIM; ++c) {
            float x = d[j][0] * st[c * DIM][lane];
#pragma unroll
            for (int f = 1; f < DIM; ++f) x = fmaf(d[j][f], st[c * DIM + f][lane], x);
            x = fmaf(nv[j], st[T::M + c][lane], x);
            acc[j][c] = fmaf(wqv, x, acc[j][c]);
          }
        }
      }
    }
    // no fourth barrier: the next point writes `rows` and `part` after
    // their readers passed the barriers above, and the flux warp writes
    // `st` after the next point's second barrier, which every owner
    // reaches after its scatter
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c) out[(long long)(c * ND + n) * E + e] = acc[j][c];
    }
  }
}

// ---- dense_slot_kernel: one thread per (element, point slot) -------------------
//
// The residual and the assemble of J2Simo and J2Log at every dense shape,
// and of J2 in 2D and on the tiled shapes.  One thread per element ran
// the J2Log body 10 times a point with the element's DIM ND output sums
// live (81 floats in 3D), at 255 registers with 560-648 B spilled and 8
// warps an SM, and the golden J2 cantilever's return map (up to 40 trips a
// point) on 262,144 threads at 512^2.  Here a block takes DTILE = 32
// consecutive elements, one per lane (every table, state and plane access
// of a warp is one 128-byte line), in SLOTS warps (4; 8 past 64 dofs).
// The tile's u and a (and v, viscous) are staged in shared memory as
// [DIM ND][DTILE].  The NQ points run in rounds of SLOTS: warp s runs the
// float pass of point q0 + s (F with grad_q_of's operations, mu_v grad v,
// the material, rho a) and hands the point's flux X, m and w det J to
// shared memory; a material whose tangent is closed form (J2, J2Linear:
// the Cauchy block, or its columns for the full one) stores the point's
// block there, in the float pass; a material whose tangent is
// forward-mode passes (dealt_tangent: J2Simo, J2Log, finite.cuh) hands its
// F and return map (FinitePoint) to shared memory instead.  After a
// barrier each thread adds the round's points, in q order, to the sums of
// the nodes n = s + SLOTS j it owns, with scatter_q's operations; the sums
// are in registers for the round's scatter only and in shared memory
// between rounds, so that none is live across a tangent pass.  The
// assemble of a dealt material then deals the round's SLOTS x DIM^2
// (point, column b) items over the block's warps: a thread runs one
// forward-mode pass at a time from the point's FinitePoint
// (FiniteMat::column) and stores column b's DIM^2 planes
// (a DIM^2 + b) QE + qe, one line a warp each.  F, P, the sums' order and
// the planes are the one-thread kernel's (dense_residual_kernel above), so
// the outputs equal its outputs to the bit, under each source's own flags
// (ops/build.py: the finite-strain source without FMA).  Shared memory of
// J2Log's assemble: 44.3 KB a block at (3, 27, 64), 54.6 KB viscous (v
// staged and mu_v grad v formed before the material: read from device
// memory after it, its loads spilled 0.8-1.8 KB at 128 registers), 19.5 KB
// at (2, 16, 25), 14.8 KB at (2, 9, 16).  Where all of u, a and v would
// pass the 227 KB a block may have (3D from p = 5: 256-268 KB at
// (3, 216, 343)), the fields are staged in that order while they fit and
// the rest read from device memory, one line a warp (SlotTile::staged).

template <class S>
struct SlotTile {
  static constexpr int DIM = S::DIM, D2 = DIM * DIM, SLOTS = S::SLOTS;
  static constexpr int OWN_NODES = (S::ND + SLOTS - 1) / SLOTS;
  static constexpr int SUMS = DIM * OWN_NODES;  // a thread's output sums
  static constexpr int PT = D2 + 3;  // a point's F, d*, r'(d*), flags (FiniteMat::stage_point)
  static constexpr int THREADS = DTILE * SLOTS;
  // floats of a block's shared memory beside the staged fields: the
  // round's fluxes; the owners' sums; with dealt tangent passes, the
  // round's points
  __host__ __device__ static constexpr size_t rest(bool dealt) {
    return (size_t)DTILE * SLOTS * (TileStage<DIM>::N + SUMS + (dealt ? PT : 0));
  }
  // the fields staged in shared memory: u, a (and v, viscous), as many of
  // them as fit in a block's shared memory
  __host__ __device__ static constexpr int staged(bool dealt, bool visc) {
    int n = visc ? 3 : 2;
    while (n > 0 && sizeof(float) * (rest(dealt) + (size_t)DTILE * n * S::NW) > BLOCK_SMEM_MAX)
      --n;
    return n;
  }
  __host__ __device__ static constexpr size_t bytes(bool dealt, bool visc) {
    return sizeof(float) * (rest(dealt) + (size_t)DTILE * staged(dealt, visc) * S::NW);
  }
  // blocks an SM (__launch_bounds__): the assemble and the 3D residual
  // four (16 warps, 128 registers a thread), the 2D residual eight (32
  // warps, 64 registers: at four J2Simo's ran 0.82-0.96x the one-thread
  // kernel at 512^2, PERF.md), each at most as many as the SM's 228 KB of
  // shared memory holds
  static constexpr int blocks(bool tangent, bool dealt, bool visc) {
    const int want = tangent || DIM == 3 ? 4 : 8;
    const size_t fit = 228 * 1024 / (bytes(dealt, visc) + 1024);
    return fit >= (size_t)want ? want : fit < 1 ? 1 : (int)fit;
  }
};

template <class Mat, class Store, class S, bool TANGENT, bool VISC, typename CT>
__global__ void __launch_bounds__(SlotTile<S>::THREADS,
                                  SlotTile<S>::blocks(TANGENT,
                                                      TANGENT && dealt_tangent<Mat>::value, VISC))
    dense_slot_kernel(Mat mat, const float* __restrict__ u_el, const float* __restrict__ a_el,
                      const float* __restrict__ v_el, const float* __restrict__ dN,
                      const float* __restrict__ N, const float* __restrict__ wq,
                      float* __restrict__ out, CT* __restrict__ cout, float rho, float mu_v,
                      long long E) {
  if (!launch_runs(mat)) return;  // J2Log's deep launch where no point needs it
  using FT = SlotTile<S>;
  using T = TileStage<S::DIM>;
  constexpr bool DEALT = TANGENT && dealt_tangent<Mat>::value;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, D2 = FT::D2;
  constexpr int SLOTS = FT::SLOTS, SUMS = FT::SUMS, PT = FT::PT;
  constexpr int NF = FT::staged(DEALT, VISC);  // staged fields: u, a (, v)
  static_assert(FT::bytes(DEALT, VISC) <= BLOCK_SMEM_MAX, "a block's shared memory");
  // staged[NF][NW][DTILE], st[SLOTS][T::N][DTILE], sums[SLOTS][SUMS][DTILE],
  // pts[SLOTS][PT][DTILE] (dealt tangent passes only)
  MIMI_DYNAMIC_SHARED(float, smem);
  float(*staged)[NW][DTILE] = reinterpret_cast<float(*)[NW][DTILE]>(smem);
  float(*st)[T::N][DTILE] = reinterpret_cast<float(*)[T::N][DTILE]>(smem + NF * NW * DTILE);
  float(*sums)[SUMS][DTILE] =
      reinterpret_cast<float(*)[SUMS][DTILE]>(smem + (NF * NW + SLOTS * T::N) * DTILE);
  float(*pts)[PT][DTILE] = reinterpret_cast<float(*)[PT][DTILE]>(
      smem + (NF * NW + SLOTS * (T::N + SUMS)) * DTILE);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  const float* const fields[3] = {u_el, a_el, v_el};
  // entry k of field f (0 u, 1 a, 2 v) of this thread's element, staged
  // or from device memory
  auto field = [=](int f, int k) {
    return f < NF ? staged[f][k][lane] : __ldg(fields[f] + (long long)k * E + e);
  };
  for (int r = slot; r < NW; r += SLOTS)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      staged[f][r][lane] = live ? __ldg(fields[f] + (long long)r * E + e) : 0.f;
#pragma unroll
  for (int k = 0; k < SUMS; ++k) sums[slot][k][lane] = 0.f;
  __syncthreads();
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q0 = 0; q0 < NQ; q0 += SLOTS) {
    const int left = NQ - q0 < SLOTS ? NQ - q0 : SLOTS;  // the round's points
    if (live && slot < left) {  // the float pass of point q0 + slot
      const long long qe = (long long)(q0 + slot) * E + e;
      float F[DIM][DIM], X[DIM][DIM];
      grad_q_of<DIM, ND>(dN, [=](int k) { return field(0, k); }, qe, QE, F);
#pragma unroll
      for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
      if (VISC) {  // mu_v dV, into the flux slots: added to P below
        float dV[DIM][DIM];
        grad_q_of<DIM, ND>(dN, [=](int k) { return field(2, k); }, qe, QE, dV);
#pragma unroll
        for (int c = 0; c < DIM; ++c)
#pragma unroll
          for (int d = 0; d < DIM; ++d) st[slot][c * DIM + d][lane] = mul(mu_v, dV[c][d]);
      }
      {
        typename Mat::Point pt;
        mat.template eval<TANGENT>(F, qe, QE, X, pt);
        if constexpr (DEALT) {
          Mat::stage_point(pt, pts[slot], lane);
        } else if constexpr (TANGENT) {
          Store::store(cout, qe, QE, mat, pt);
        }
      }
      float av[DIM];
      value_q_of<DIM, ND>(N, [=](int k) { return field(1, k); }, qe, QE, av);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
#pragma unroll
        for (int d = 0; d < DIM; ++d)  // P + mu_v dV, in the plain version's order
          st[slot][c * DIM + d][lane] =
              VISC ? add(X[c][d], st[slot][c * DIM + d][lane]) : X[c][d];
        st[slot][T::M + c][lane] = rho * av[c];
      }
      st[slot][T::W][lane] = __ldg(wq + qe);
    }
    __syncthreads();
    if (live) {
      // the round's points, in q order, into this thread's nodes' sums
      // (scatter_q's operations for node n), held in registers for the
      // round only: each point's flux is read from shared memory once
      float acc[FT::OWN_NODES][DIM];
#pragma unroll
      for (int j = 0; j < FT::OWN_NODES; ++j)
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          acc[j][c] = slot + SLOTS * j < ND ? sums[slot][j * DIM + c][lane] : 0.f;
#pragma unroll 1
      for (int s = 0; s < left; ++s) {
        const long long qe = (long long)(q0 + s) * E + e;
        const float(*p)[DTILE] = st[s];
        float X[DIM][DIM], m[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
#pragma unroll
          for (int d = 0; d < DIM; ++d) X[c][d] = p[c * DIM + d][lane];
          m[c] = p[T::M + c][lane];
        }
        const float wqv = p[T::W][lane];
#pragma unroll
        for (int j = 0; j < FT::OWN_NODES; ++j) {
          const int n = slot + SLOTS * j;
          if (n < ND) {
            float d[DIM];
#pragma unroll
            for (int f = 0; f < DIM; ++f) d[f] = __ldg(dN + (long long)(n * DIM + f) * QE + qe);
            const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
            for (int c = 0; c < DIM; ++c) {
              float x = d[0] * X[c][0];
#pragma unroll
              for (int f = 1; f < DIM; ++f) x += d[f] * X[c][f];
              x += Nn * m[c];
              acc[j][c] += wqv * x;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < FT::OWN_NODES; ++j)
        if (slot + SLOTS * j < ND)
#pragma unroll
          for (int c = 0; c < DIM; ++c) sums[slot][j * DIM + c][lane] = acc[j][c];
      if constexpr (DEALT) {  // the round's (point, column) items, dealt over the warps
#pragma unroll 1
        for (int i = slot; i < left * D2; i += SLOTS) {
          const int s = i / D2, b = i % D2;
          const long long qe = (long long)(q0 + s) * E + e;
          const typename Mat::Point pt = Mat::staged_point(pts[s], lane);
          float col[D2];
          mat.column(pt, qe, QE, b, col);
#pragma unroll
          for (int a = 0; a < D2; ++a) store_c(cout + (long long)(a * D2 + b) * QE + qe, col[a]);
        }
      }
    }
    __syncthreads();  // the round's points are read before the next overwrites them
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < FT::OWN_NODES; ++j) {
      const int n = slot + SLOTS * j;
      if (n < ND)
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          out[(long long)(c * ND + n) * E + e] = sums[slot][j * DIM + c][lane];
    }
  }
}

// dense_slot_kernel on the material `mat` (the block in CT, deduced from
// cout; v_el == nullptr inviscid)
template <class Store, class S, bool TANGENT, bool VISC, class Mat, typename CT>
int launch_dense_slot(const Mat& mat, const float* u_el, const float* a_el, const float* v_el,
                      const float* dN, const float* N, const float* wq, float* out, CT* cout,
                      float rho, float mu_v, long long E, void* stream) {
  using FT = SlotTile<S>;
  constexpr size_t smem = FT::bytes(TANGENT && dealt_tangent<Mat>::value, VISC);
  const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
  if (const int err =
          allow_dynamic_smem<dense_slot_kernel<Mat, Store, S, TANGENT, VISC, CT>>(smem))
    return err;
  dense_slot_kernel<Mat, Store, S, TANGENT, VISC, CT>
      <<<tiles, FT::THREADS, smem, (cudaStream_t)stream>>>(mat, u_el, a_el, v_el, dN, N, wq, out,
                                                           cout, rho, mu_v, E);
  return (int)cudaGetLastError();
}

// The residual (and, TANGENT, the assemble) of `mat` on dense_ring_kernel
// (one thread per element, the point's rows copied ahead into shared
// memory), the block in CT (deduced from cout); v_el == nullptr inviscid
template <class Mat, class Store, class S, bool TANGENT, bool VISC = false, typename CT>
int launch_dense_ring(const float* u_el, const float* a_el, const float* dN, const float* N,
                      const float* wq, float* out, CT* cout, const Mat& mat, float rho,
                      long long E, void* stream, const float* v_el = nullptr,
                      float mu_v = 0.f) {
  constexpr size_t smem = RingTile<S>::BYTES;
  if (const int err =
          allow_dynamic_smem<dense_ring_kernel<Mat, Store, S, TANGENT, VISC, CT>>(smem))
    return err;
  const unsigned tiles = (unsigned)((E + DTILE_RING - 1) / DTILE_RING);
  dense_ring_kernel<Mat, Store, S, TANGENT, VISC, CT>
      <<<tiles, DTILE_RING, smem, (cudaStream_t)stream>>>(u_el, a_el, v_el, dN, N, wq, out,
                                                          cout, mat, rho, mu_v, E);
  return (int)cudaGetLastError();
}

// The residual (and, TANGENT, the assemble) of `mat`, the block in CT
// (deduced from cout), the tables in float32: the owners and the flux
// warp on the tiled shapes, else the one thread per element of
// dense_residual_kernel (the hyperelastic materials, J2Linear and 3D J2's
// viscous and bfloat16-block instantiations: on point slots the
// hyperelastic ones ran 0.75-0.81x at the golden twin's 512^2 and the 3D
// cell, sweeps_dense_j2.cu j2_kernel says J2's and J2Linear's)
template <class Mat, class Store, class S, bool TANGENT, bool VISC = false, typename CT>
int launch_dense_residual(const float* u_el, const float* a_el, const float* dN,
                          const float* N, const float* wq, float* out, CT* cout,
                          const Mat& mat, float rho, long long E, void* stream,
                          const float* v_el = nullptr, float mu_v = 0.f) {
  if constexpr (S::TILED) {
    constexpr size_t smem = ResidualTile<S, VISC>::BYTES;
    if (const int err = allow_dynamic_smem<
            dense_residual_tile_kernel<Mat, Store, S, TANGENT, VISC, CT>>(smem))
      return err;
    const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
    dense_residual_tile_kernel<Mat, Store, S, TANGENT, VISC, CT>
        <<<tiles, MatvecTile<S>::THREADS, smem, (cudaStream_t)stream>>>(
            mat, u_el, a_el, v_el, dN, N, wq, out, cout, rho, mu_v, E);
    return (int)cudaGetLastError();
  } else {
    constexpr size_t smem = 2 * sizeof(float) * S::NW * BLOCK;
    if (const int err =
            allow_dynamic_smem<dense_residual_kernel<Mat, Store, S, TANGENT, VISC, CT>>(smem))
      return err;
    dense_residual_kernel<Mat, Store, S, TANGENT, VISC, CT>
        <<<grid_for(E), BLOCK, smem, (cudaStream_t)stream>>>(u_el, a_el, v_el, dN, N, wq, out,
                                                              cout, mat, rho, mu_v, E);
    return (int)cudaGetLastError();
  }
}

// the block in CT and the tables in TT (deduced from cs and dN)
template <class Store, class S, bool VISC = false, typename CT, typename TT>
int launch_dense_matvec(const float* w_el, const TT* dN, const TT* N, const float* wq,
                        const CT* cs, float* out, float rho, float fac0, long long E,
                        void* stream, float fac1_mu_v = 0.f) {
  if constexpr (S::TILED) {
    using M = MatvecTile<S>;
    if (const int err = allow_dynamic_smem<dense_matvec_tile_kernel<Store, S, VISC, CT, TT>>(M::SMEM))
      return err;
    const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
    dense_matvec_tile_kernel<Store, S, VISC, CT, TT>
        <<<tiles, M::THREADS, M::SMEM, (cudaStream_t)stream>>>(w_el, dN, N, wq, cs, out, rho,
                                                               fac0, fac1_mu_v, E);
    return (int)cudaGetLastError();
  } else {
    constexpr size_t smem = sizeof(float) * S::NW * BLOCK;
    if (const int err = allow_dynamic_smem<dense_matvec_kernel<Store, S, VISC, CT, TT>>(smem))
      return err;
    dense_matvec_kernel<Store, S, VISC, CT, TT>
        <<<grid_for(E), BLOCK, smem, (cudaStream_t)stream>>>(w_el, dN, N, wq, cs, out, rho, fac0,
                                                              fac1_mu_v, E);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// The shape this translation unit instantiates, defined by the build
// (ops/build.py: -DMIMI_DENSE_DIM, -DMIMI_DENSE_ND, -DMIMI_DENSE_NQ)
#if !defined(MIMI_DENSE_DIM) || !defined(MIMI_DENSE_ND) || !defined(MIMI_DENSE_NQ)
#error "define MIMI_DENSE_DIM, MIMI_DENSE_ND and MIMI_DENSE_NQ: the element's shape (ops/build.py)"
#endif

namespace {

using Dense = DenseShape<MIMI_DENSE_DIM, MIMI_DENSE_ND, MIMI_DENSE_NQ>;

// fn(Dense{}) where (dim, nd, nq) is the shape of the build;
// cudaErrorInvalidValue for any other (ops/sweeps.py loads the library of
// the tables' own shape)
template <class Fn>
int with_dense_shape(int dim, int nd, int nq, Fn fn) {
  if (dim != Dense::DIM || nd != Dense::ND || nq != Dense::NQ) return (int)cudaErrorInvalidValue;
  return fn(Dense{});
}

}  // namespace
