// Dense-table quadrature sweeps of the implicit step, for sm_90a: the
// hyperelastic materials with the symmetric tangent storage.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch (dN (ND, DIM, NQ, E),
// N (ND, NQ, E), w det J (NQ, E) streamed from device memory):
//   mimi_residual_dense  <- make_residual_sweep (dense)            residual only
//   mimi_assemble_dense  <- make_assemble_sweep (dense, "sym"; "full")  residual + symmetric or full planes
//   mimi_matvec_dense    <- make_matvec_sweep ("sym")              y = J w
// each inviscid or with the viscous flux of has_visc (VISC: the residual
// and the assemble add mu_v grad v to P, sweeps.py:404-414, :651-664; the
// matvec adds fac1 mu_v grad w, :816-834).
// J2 with the Cauchy-decomposition storage instantiates the same templates
// in sweeps_dense_j2.cu.  The plain torch versions of the same functions
// are in ops/sweeps.py (residual_dense_plain, assemble_dense_plain,
// matvec_dense_plain).
//
// The kernels (dense_common.cuh) are templated on the material (its first
// Piola stress and closed-form dP/dF as device functions, materials.cuh),
// the tangent storage and the element's shape (DIM, ND dofs, NQ points;
// dense_common.cuh DenseShape).  Instantiated here at the shape of the
// build (ops/build.py compiles this source once per shape the step asks
// for: any degree, quadrature order, degrees that differ per axis): the
// compressible Ogden neo-Hookean and the
// St. Venant-Kirchhoff material with SymStorage<DIM>, plane (a, b), a <= b,
// of tri_index_map(DIM^2) holding (C_ab + C_ba) / 2 with C_ab = dP_a / dF_b,
// a = DIM c + d: 45 planes in 3D, 10 in 2D.  p = 3 in 2D is the golden
// cantilever's (balken elevated by 2), p = 2 in 2D the examples', p = 3 in
// 3D the two-patch cube elevated by 2 (64 dofs, 125 points).
//
// Design: one thread per element, 64 elements per block, looping over the
// element's NQ quadrature points (a rolled loop: `#pragma unroll 1` keeps
// the build short).  The batch-last layout puts neighbouring elements on
// neighbouring addresses, so every table read and tangent write of a warp
// coalesces.  Each thread stages its element's dof values (DIM ND floats
// per field) in its own column of shared memory, which keeps them out of
// the register file; its DIM ND output sums stay in registers, so no
// thread touches another's data (no barrier, no atomics).  The scatter
// reads each point's dN and N rows a second time, from L1.
//
// What bounds them on the H100: bytes.  Per call at E = 109,744 (3D, p = 2)
// the residual streams dN 2.28 GB, N 0.76 GB and w det J 0.03 GB plus the
// element fields, 3.17 GB, about 0.95 ms at 3.35 TB/s; the assemble writes
// the 45 planes as well (1.26 GB, 4.43 GB in all, ~1.32 ms); the matvec
// reads the planes instead (4.40 GB, ~1.31 ms).  At 512^2 (2D, p = 3) dN is
// 0.84 GB, N 0.42 GB, the 10 planes 0.26 GB.  At 3D p = 3 and the same E
// dN is 10.5 GB, N 3.5 GB and the 45 planes 2.5 GB: ~4.3 ms for the
// residual, ~5.0 ms for the assemble and the matvec.  There a thread's 192
// output sums would spill to local memory and the two staged fields take
// 96 KB a block (2 blocks, 4 warps an SM): one thread per element ran the
// residual and the matvec at 50-60x their bound on an H100.  So past 27
// dofs in 3D and 16 in 2D the residual, assemble and matvec are tiled:
// owner warps of 8 nodes (more past 128) hold their nodes' dN and N rows in
// registers from the gradient's partial sums to the scatter, and one flux
// warp a block runs the material (and stores the block) or applies the
// block, so that dN and N cross device memory once (dense_common.cuh
// dense_residual_tile_kernel, dense_matvec_tile_kernel).  Per point they
// do a few hundred flops against a few hundred bytes, under one flop per
// byte.  At path I's 2 x 38^3 the owner design took the `sym` matvec from
// 17.09 to 7.25 ms against a 5.00 ms bound (the point slots it replaced
// read each point's dN and N twice), and the residual and assemble
// likewise (scripts/ab_dense_sweeps.py --part tiled, --part residual;
// PERF.md).
//
// Rounding: the deformation gradient and the stress are formed with
// single-rounding intrinsics (no fused multiply-add), in the order of the
// plain torch version's separate operations, so F and P agree with it to
// the bit (materials.cuh says why that matters near F = I).
//
// bfloat16 (sweeps_dense_bf16.cu, which defines MIMI_DENSE_BF16 and
// includes this source): mimi_assemble_dense_bf16 writes the block rounded
// to nearest even, from the float32 tables; mimi_matvec_dense_bf16 reads
// that block and the bfloat16 copies of dN and N (the reference's dN_mv /
// N_mv, mimi_tpu/parallel/sharding.py:1147-1154), each widened exactly on
// load, all arithmetic in float32.  There the matvec moves half the bytes
// (at 3D p = 2 and E = 110,592: 2.21 GB in place of 4.40), read as 64-byte
// rows a warp instead of 128.  The residual writes no block: it has no
// bfloat16 instantiation.

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "materials.cuh"

namespace {

template <template <int> class H, class Store, class S, bool TANGENT, bool VISC>
int launch_hyper(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                 const float* N, const float* wq, float* out, DenseBlock* cout,
                 const HyperelasticParams& p, float mu_v, long long E, void* stream) {
  constexpr int DIM = S::DIM;
  using Mat = Hyper<H<DIM>>;
  return launch_dense_residual<Mat, Store, S, TANGENT, VISC>(
      u_el, a_el, dN, N, wq, out, cout, Mat{H<DIM>{p.mu, p.lam}}, p.rho, E, stream, v_el,
      mu_v);
}

template <bool TANGENT, bool VISC>
int hyper_entry(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                const float* N, const float* wq, float* out, DenseBlock* cout, int full,
                const HyperelasticParams& p, float mu_v, int material, int dim, int nd, int nq,
                long long E, void* stream) {
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    auto go = [&](auto store) {
      using Store = decltype(store);
      if (material == 0)
        return launch_hyper<NeoHookean, Store, S, TANGENT, VISC>(
            u_el, a_el, v_el, dN, N, wq, out, cout, p, mu_v, E, stream);
      if (material == 1)
        return launch_hyper<StVK, Store, S, TANGENT, VISC>(u_el, a_el, v_el, dN, N, wq,
                                                                out, cout, p, mu_v, E, stream);
      return (int)cudaErrorInvalidValue;
    };
    if constexpr (TANGENT) {  // the residual writes no block
      if (full) return go(FullStorage<DIM>{});
    }
    return go(SymStorage<DIM>{});
  });
}

template <bool TANGENT>
int hyper_visc_entry(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                     const float* N, const float* wq, float* out, DenseBlock* cout, int full,
                     const HyperelasticParams& p, float mu_v, int material, int dim, int nd, int nq,
                     long long E, void* stream) {
  if (E <= 0) return 0;
  if (v_el)
    return hyper_entry<TANGENT, true>(u_el, a_el, v_el, dN, N, wq, out, cout, full, p, mu_v,
                                      material, dim, nd, nq, E, stream);
  return hyper_entry<TANGENT, false>(u_el, a_el, v_el, dN, N, wq, out, cout, full, p, mu_v,
                                     material, dim, nd, nq, E, stream);
}

}  // namespace

// C entry points, symmetric storage.  `material`: 0 the neo-Hookean, 1 the
// St. Venant-Kirchhoff material; (dim, nd, nq) the shape of the build
// (dim, dofs and points per element); v_el == nullptr (visc == 0 for the matvec)
// selects the inviscid instantiation; the assemble's `full` the DIM^4
// planes of dP/dF (FullStorage<DIM>, the matvec mimi_matvec_dense_full of
// sweeps_dense_finite.cu) for the symmetric ones.  The block (and the
// matvec's dN, N) in DenseBlock: float here, __nv_bfloat16 in the _bf16
// entry points of sweeps_dense_bf16.cu.  Each returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a material not
// instantiated or another shape.
extern "C" {

#ifndef MIMI_DENSE_BF16
int mimi_residual_dense(const float* u_el, const float* a_el, const float* v_el,
                        const float* dN, const float* N, const float* wq, float* out,
                        HyperelasticParams p, float mu_v, int material, int dim, int nd, int nq,
                        long long E, void* stream) {
  return hyper_visc_entry<false>(u_el, a_el, v_el, dN, N, wq, out, nullptr, 0, p, mu_v,
                                 material, dim, nd, nq, E, stream);
}
#endif

int MIMI_DENSE_ENTRY(mimi_assemble_dense)(const float* u_el, const float* a_el,
                                          const float* v_el, const float* dN, const float* N,
                                          const float* wq, float* out, DenseBlock* cout,
                                          int full, HyperelasticParams p, float mu_v,
                                          int material, int dim, int nd, int nq, long long E,
                                          void* stream) {
  return hyper_visc_entry<true>(u_el, a_el, v_el, dN, N, wq, out, cout, full, p, mu_v,
                                material, dim, nd, nq, E, stream);
}

int MIMI_DENSE_ENTRY(mimi_matvec_dense)(const float* w_el, const DenseBlock* dN,
                                        const DenseBlock* N, const float* wq,
                                        const DenseBlock* cs, float* out, float rho,
                                        float fac0, int visc, float fac1_mu_v, int dim, int nd, int nq,
                                        long long E, void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    if (visc)
      return launch_dense_matvec<SymStorage<DIM>, S, true>(w_el, dN, N, wq, cs, out, rho,
                                                                fac0, E, stream, fac1_mu_v);
    return launch_dense_matvec<SymStorage<DIM>, S>(w_el, dN, N, wq, cs, out, rho, fac0,
                                                        E, stream);
  });
}

}  // extern "C"
