// Shared by the dense-table CUDA sources (sweeps_dense.cu, sweeps_dense_j2.cu,
// sweeps_dense_finite.cu, their bfloat16 twins, fused_neohookean.cu), for
// sm_90a: the element's shape (dimension, dofs and points), staging of an
// element's dof values in shared memory, the per-point interpolation and
// scatter on dense tables dN (ND, DIM, NQ, E), N (ND, NQ, E), and the
// residual / assemble and matvec kernel templates with their launchers.
// The tangent block's element type (CT) and the matvec's tables' (TT) are
// template parameters, float or __nv_bfloat16, widened on load
// (materials.cuh load_c; a float load is the __ldg it always was).  One
// thread per element; each thread owns one column of the shared arrays
// (dynamic shared memory, launch.cuh: 40.5 KB a block for the residual at
// 3D p = 2), so no barrier is needed.  Past 27 dofs in 3D and 16 in 2D
// (DenseShape::TILED) the launchers take the tiled kernels below instead
// (one thread per element and point slot).  Each translation unit
// instantiates its kernels at the one shape its build defines
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
// bit; `w(k)` returns value k of the element's field.  The loop over the
// nodes is unrolled 5 at a time past 27 dofs (the tiled shapes, where the
// sums are no per-node registers): fully unrolled at 125 it made each
// (3, 125, 216) source take 62-129 s of nvcc, at 64 each (3, 64, 125) one
// 25-53 s
template <int DIM, int ND, typename TT, class W>
__device__ __forceinline__ void grad_q_of(const TT* __restrict__ dN, const W& w,
                                          long long qe, long long QE, float G[DIM][DIM]) {
#pragma unroll
  for (int g = 0; g < DIM; ++g)
#pragma unroll
    for (int f = 0; f < DIM; ++f) G[g][f] = 0.f;
  const auto node = [&](int n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = load_c(dN + (long long)(n * DIM + f) * QE + qe);
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

// the gradient of the field staged in this thread's shared column
template <int DIM, int ND, typename TT>
__device__ __forceinline__ void grad_q(const TT* __restrict__ dN, float (*w)[BLOCK],
                                       long long qe, long long QE, float G[DIM][DIM]) {
  grad_q_of<DIM, ND>(dN, [w](int k) { return w[k][threadIdx.x]; }, qe, QE, G);
}

// v[c] = sum_n N[n](q) w[c][n]
template <int DIM, int ND, typename TT>
__device__ __forceinline__ void value_q(const TT* __restrict__ N, float (*w)[BLOCK],
                                        long long qe, long long QE, float v[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) v[c] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float Nn = load_c(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < DIM; ++c) v[c] += Nn * w[c * ND + n][threadIdx.x];
  }
}

// acc[c][n] += wq (sum_d dN[n][d] X[c][d] + N[n] m[c]); without MASS the
// N[n] m[c] term is left out and N, m are not read
template <int DIM, int ND, bool MASS = true, typename TT>
__device__ __forceinline__ void scatter_q(float (&acc)[DIM][ND], const TT* __restrict__ dN,
                                          const typename same_type<TT>::type* __restrict__ N,
                                          long long qe, long long QE, float wq,
                                          const float X[DIM][DIM], const float* m) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[DIM];
#pragma unroll
    for (int f = 0; f < DIM; ++f) d[f] = load_c(dN + (long long)(n * DIM + f) * QE + qe);
    const float Nn = MASS ? load_c(N + (long long)n * QE + qe) : 0.f;
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
// blocks, 4 warps an SM).  The tiled residual, assemble and matvec instead
// map one thread to an (element, point slot), as the sf residual kernel
// does (sf_common.cuh): a block takes a tile of DTILE = 32 consecutive
// elements, one per lane, in S::SLOTS warps, warp s taking the points
// q = s (mod SLOTS) of every element.  The tile's element fields are staged
// once in shared memory as [DIM ND][DTILE]; per point a thread forms F (or
// grad w) from its lane's column and its point's dN row, with the same
// operations as grad_q_of above, runs the material (or the tangent apply)
// and hands the point's flux X[c][d], mass term m[c] and w det J to shared
// memory; after a barrier each thread adds the round's SLOTS points, in q
// order, to the outputs of the nodes n = s + SLOTS j it owns (16 nodes, 48
// sums at 3D p = 3 with 4 slots and at p = 4 with 8), reading those nodes'
// dN and N at the round's points, with the scatter's operations
// (scatter_q).  Every table read of a warp is one 128-byte line; dN is read
// twice, as above.  Shared memory: 55.8 KB a block for the residual, 31.2
// KB for the matvec at (3, 64, 125); 106.8 KB and 59.9 KB at (3, 125, 216).

constexpr int DTILE = 32;

// what one point hands to its nodes' owners: X[c][d], m[c] and w det J
template <int DIM>
struct TileStage {
  static constexpr int M = DIM * DIM, W = DIM * DIM + DIM, N = DIM * DIM + DIM + 1;
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

// The points of dense_tile_kernel: the flux X and mass term m of point q
// of the lane's element, from the staged fields s0 (and s1); MASS: whether
// the scatter adds N[n] m[c] (the fused neo-Hookean kernels have no mass
// term and no N table).

// one point of the residual (and, with TANGENT, the assemble, the block in
// CT): fields u (s0) and a (s1)
template <class Mat, class Store, class S, bool TANGENT, bool VISC, typename CT>
struct ResidualPoint {
  static constexpr bool MASS = true;
  static constexpr int DIM = S::DIM;
  Mat mat;
  CT* cout;
  const float* v_el;
  const float* dN;
  const float* N;
  float rho, mu_v;
  __device__ __forceinline__ void operator()(const float (*s0)[DTILE], const float (*s1)[DTILE],
                                             int lane, long long e, long long E, long long qe,
                                             long long QE, float X[DIM][DIM],
                                             float m[DIM]) const {
    constexpr int ND = S::ND;
    float F[DIM][DIM];
    grad_q_of<DIM, ND>(dN, [=](int k) { return s0[k][lane]; }, qe, QE, F);
#pragma unroll
    for (int i = 0; i < DIM; ++i) F[i][i] = add(F[i][i], 1.f);
    typename Mat::Point pt;
    mat.template eval<TANGENT>(F, qe, QE, X, pt);
    if (TANGENT) Store::store(cout, qe, QE, mat, pt);
    if (VISC) {  // P + mu_v dV, in the plain version's order
      float dV[DIM][DIM];
      grad_q_of<DIM, ND>(dN, [=](int k) { return __ldg(v_el + (long long)k * E + e); }, qe, QE,
                         dV);
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) X[c][d] = add(X[c][d], mul(mu_v, dV[c][d]));
    }
    float av[DIM];
    value_q_of<DIM, ND>(N, [=](int k) { return s1[k][lane]; }, qe, QE, av);
#pragma unroll
    for (int c = 0; c < DIM; ++c) m[c] = rho * av[c];
  }
};

// one point of the matvec: field w (s0), the block in CT, the tables in TT
template <class Store, class S, bool VISC, typename CT, typename TT>
struct MatvecPoint {
  static constexpr bool MASS = true;
  static constexpr int DIM = S::DIM;
  const CT* cs;
  const TT* dN;
  const TT* N;
  float rho, fac0, fac1_mu_v;
  __device__ __forceinline__ void operator()(const float (*s0)[DTILE], const float (*)[DTILE],
                                             int lane, long long, long long, long long qe,
                                             long long QE, float X[DIM][DIM],
                                             float m[DIM]) const {
    constexpr int ND = S::ND;
    const auto w = [=](int k) { return s0[k][lane]; };
    float dF[DIM][DIM], v[DIM];
    grad_q_of<DIM, ND>(dN, w, qe, QE, dF);
    value_q_of<DIM, ND>(N, w, qe, QE, v);
    Store::apply(cs, qe, QE, dF, fac0, X);
    if (VISC) {
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) X[c][d] = add(X[c][d], mul(fac1_mu_v, dF[c][d]));
    }
#pragma unroll
    for (int c = 0; c < DIM; ++c) m[c] = rho * v[c];
  }
};

// y[c][n] = sum_q wq (dN[n][d] X[c][d] + N[n] m[c]) with the point's X and
// m from `point` (ResidualPoint, MatvecPoint or a fused neo-Hookean point)
// on the NF staged fields f0 (and f1); the scatter reads dN, N in TT (the
// point's own tables; N only where Pt::MASS)
template <class S, int NF, typename TT, class Pt>
__global__ void __launch_bounds__(DTILE * S::SLOTS)
    dense_tile_kernel(Pt point, const float* __restrict__ f0, const float* __restrict__ f1,
                      const TT* __restrict__ dN, const TT* __restrict__ N,
                      const float* __restrict__ wq, float* __restrict__ out, long long E) {
  using T = TileStage<S::DIM>;
  constexpr int DIM = S::DIM, ND = S::ND, NW = S::NW, NQ = S::NQ, DSLOTS = S::SLOTS;
  constexpr int OWN_NODES = (ND + DSLOTS - 1) / DSLOTS;
  MIMI_DYNAMIC_SHARED(float, smem);  // s0[NW][DTILE] (, s1[NW][DTILE]), st[DSLOTS][T::N][DTILE]
  float(*s0)[DTILE] = reinterpret_cast<float(*)[DTILE]>(smem);
  float(*s1)[DTILE] = s0 + (NF > 1 ? NW : 0);
  float(*st)[T::N][DTILE] = reinterpret_cast<float(*)[T::N][DTILE]>(s0 + NF * NW);
  const int lane = threadIdx.x % DTILE, slot = threadIdx.x / DTILE;
  const long long e = (long long)blockIdx.x * DTILE + lane;
  const bool live = e < E;  // the last tile is ragged where E % DTILE != 0
  for (int r = slot; r < NW; r += DSLOTS) {
    const long long off = (long long)r * E + e;
    s0[r][lane] = live ? __ldg(f0 + off) : 0.f;
    if (NF > 1) s1[r][lane] = live ? __ldg(f1 + off) : 0.f;
  }
  __syncthreads();
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
      float X[DIM][DIM], m[DIM];
      point(s0, s1, lane, e, E, qe, QE, X, m);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) st[slot][c * DIM + d][lane] = X[c][d];
        st[slot][T::M + c][lane] = m[c];
      }
      st[slot][T::W][lane] = __ldg(wq + qe);
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
          if (n < ND) {  // scatter_q's operations for node n
            float d[DIM];
#pragma unroll
            for (int f = 0; f < DIM; ++f) d[f] = load_c(dN + (long long)(n * DIM + f) * QE + qe);
            const float Nn = Pt::MASS ? load_c(N + (long long)n * QE + qe) : 0.f;
#pragma unroll
            for (int c = 0; c < DIM; ++c) {
              float x = d[0] * p[c * DIM][lane];
#pragma unroll
              for (int f = 1; f < DIM; ++f) x += d[f] * p[c * DIM + f][lane];
              if (Pt::MASS) x += Nn * p[T::M + c][lane];
              acc[j][c] += p[T::W][lane] * x;
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

template <class S, int NF, typename TT, class Pt>
int launch_dense_tile(const Pt& point, const float* f0, const float* f1, const TT* dN,
                      const TT* N, const float* wq, float* out, long long E, void* stream) {
  constexpr size_t smem =
      sizeof(float) * DTILE * (NF * S::NW + S::SLOTS * TileStage<S::DIM>::N);
  if (const int err = allow_dynamic_smem<dense_tile_kernel<S, NF, TT, Pt>>(smem)) return err;
  const unsigned tiles = (unsigned)((E + DTILE - 1) / DTILE);
  dense_tile_kernel<S, NF, TT, Pt><<<tiles, DTILE * S::SLOTS, smem, (cudaStream_t)stream>>>(
      point, f0, f1, dN, N, wq, out, E);
  return (int)cudaGetLastError();
}

// the block in CT (deduced from cout); the tables in float32
template <class Mat, class Store, class S, bool TANGENT, bool VISC = false, typename CT>
int launch_dense_residual(const float* u_el, const float* a_el, const float* dN,
                          const float* N, const float* wq, float* out, CT* cout,
                          const Mat& mat, float rho, long long E, void* stream,
                          const float* v_el = nullptr, float mu_v = 0.f) {
  if constexpr (S::TILED) {
    const ResidualPoint<Mat, Store, S, TANGENT, VISC, CT> point{
        mat, cout, v_el, dN, N, rho, mu_v};
    return launch_dense_tile<S, 2>(point, u_el, a_el, dN, N, wq, out, E, stream);
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
    const MatvecPoint<Store, S, VISC, CT, TT> point{cs, dN, N, rho, fac0, fac1_mu_v};
    return launch_dense_tile<S, 1>(point, w_el, nullptr, dN, N, wq, out, E, stream);
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
