// Dense-table quadrature sweeps of the implicit step for small-strain J2
// (any of the reference's hardening laws) and J2Linear with the
// Cauchy-decomposition tangent storage, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch with c_storage="cauchy":
//   mimi_residual_dense_j2   <- make_residual_sweep (dense, J2 state)    residual only
//   mimi_assemble_dense_j2   <- make_assemble_sweep (dense, "cauchy"; "full")  residual + Cauchy or full block
//   mimi_matvec_dense_cauchy <- make_matvec_sweep ("cauchy")           y = J w
// each inviscid or viscous (VISC, as sweeps_dense.cu says),
// on the kernel templates of dense_common.cuh (design notes at the head of
// sweeps_dense.cu), at the shape of the build (any (DIM, ND, NQ)).  The
// residual and the assemble of J2 take dense_slot_kernel in 2D and past 27
// dofs in 3D (one thread per element and point slot, J2Simo's and J2Log's
// kernel: at the golden cantilever's 512^2 the return map, up to 40 trips
// a point, runs on four times the threads of one thread per element; the
// closed-form block is stored in the float pass), dense_ring_kernel in 3D
// up to 27 dofs, inviscid, with a float32 block (one thread per element,
// its rows copied ahead into shared memory), J2Linear's
// dense_residual_tile_kernel past 27 / 16
// dofs (owners of 8 nodes and a flux warp), each the one-thread kernel
// below that (j2_kernel says why).
// The plain torch versions are residual_dense_plain,
// assemble_dense_plain and matvec_dense_plain with the J2 or J2Linear
// material (ops/sweeps.py).
//
// The point bodies are j2.cuh's: J2's radial return on the point's state
// (plastic strain (DIM, DIM, NQ, E), eqps and temperature (NQ, E), read
// once per point) or J2Linear's closed-form return (plastic strain, the
// back stress beta (DIM, DIM, NQ, E) and eqps), and the closed-form
// algorithmic tangent, stored as
// CauchyStorage<DIM>: D-hat, sigma, F^-1 and J, 37 planes in 3D and 14 in
// 2D (6 + 3 + 4 + 1).  The matvec rebuilds P = J sigma F^-T and applies the
// geometric terms per point.
//
// What bounds them on the H100: bytes on elastic points.  At 512^2 (2D,
// p = 3, 262,144 elements, 25 points each) the residual streams dN 0.84 GB,
// N 0.42 GB, the state 0.16 GB and w det J, ~1.5 GB (0.46 ms at
// 3.35 TB/s); the assemble writes the 14 planes too (0.37 GB); the matvec
// reads them instead.  A plastic point adds the radial return's iterations
// (up to 40 safeguarded Newton-bisection trips with powf / logf, the
// reference kernels' cap).
//
// Rounding: on point slots F is formed without FMA in the plain version's
// order (dense_common.cuh grad_q_of), on the tiled shapes summed by owner
// slot; P = J sigma F^-T from sigma with the single-rounding 2 x 2 / 3 x 3
// algebra of materials.cuh, as the plain version's _pk1_from_cauchy_soa.
//
// bfloat16 (sweeps_dense_j2_bf16.cu, MIMI_DENSE_BF16):
// mimi_assemble_dense_j2_bf16 stores the Cauchy (or full) block rounded to
// nearest even, mimi_matvec_dense_cauchy_bf16 reads it with the bfloat16
// copies of dN and N, as sweeps_dense.cu says; the driven path J (the main
// path's 48^3 J2 cube with matvec_impl="dense", matvec_dtype="bf16") runs
// the (3, 2) pair.

#include <cuda_runtime.h>

#include <type_traits>

#include "dense_common.cuh"
#include "j2.cuh"
#include "materials.cuh"

namespace {

// J2 (LINEAR false: plastic strain, eqps, temperature) or J2Linear (LINEAR
// true: plastic strain, eqps, beta) with its per-point state on the dense
// kernels' material interface
template <int DIM, bool LINEAR>
struct DenseJ2 {
  J2Params p;
  const float* ps;
  const float* eqps;
  const float* temp;  // J2
  const float* beta;  // J2Linear
  struct Point {  // what CauchyStorage<DIM> stores
    float Mt[Voigt<DIM>::NT], sig[DIM][DIM], fi[DIM][DIM], J;
  };
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[DIM][DIM], long long qe, long long QE,
                                       float P[DIM][DIM], Point& pt) const {
    float pst[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) pst[i][j] = __ldg(ps + (i * DIM + j) * QE + qe);
    if constexpr (LINEAR) {
      float bt[DIM][DIM];
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int j = 0; j < DIM; ++j) bt[i][j] = __ldg(beta + (i * DIM + j) * QE + qe);
      j2_linear_cauchy<DIM, TANGENT>(p, F, pst, bt, __ldg(eqps + qe), pt.sig, pt.Mt);
    } else {
      j2_cauchy<DIM, TANGENT>(p, F, pst, __ldg(eqps + qe), __ldg(temp + qe), pt.sig, pt.Mt);
    }
    pt.J = rn::det(F);
    rn::inv(F, pt.fi);
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int d = 0; d < DIM; ++d) P[c][d] = rn::mul(pt.J, rn::dot_nt<DIM>(pt.sig, pt.fi, c, d));
  }
  // column b of dP/dF for FullStorage<DIM>: the Cauchy tangent on e_b
  __device__ __forceinline__ void column(const Point& pt, long long, long long, int b,
                                         float col[DIM * DIM]) const {
    CauchyStorage<DIM>::column(pt, b, col);
  }
};

// The kernel that runs the residual and assemble of J2 (LINEAR false) or
// J2Linear at a shape of DIM, tiled or not (DenseShape::TILED), viscous or
// not.  J2's return map (up to 40 trips a point) runs on point slots
// (dense_slot_kernel) in 2D and on the tiled shapes: at the golden
// cantilever's 512^2 2.2x the one-thread kernel, and on one flux warp a
// block the tiled shapes' plastic points ran at 0.6x the point slots they
// replaced.  In 3D up to 27 dofs the driven states are elastic and
// inviscid: there the slots' barriers cost more than their threads gained
// (path J, the 3D cell: 0.77-0.82x), the owners and the flux warp ran
// 0.78-1.03x (J2 on one warp in five), and dense_ring_kernel (the
// one-thread kernel with its rows copied ahead into shared memory, equal
// to it to the bit) 1.01-1.09x with a float32 block; with path J's
// bfloat16 block it ran 0.96-1.04x, and its viscous instantiations spill
// 512 B and ran 0.64-0.72x on random plastic input, so those keep the one
// thread per element (dense_residual_kernel, through
// launch_dense_residual).
// J2Linear's return is closed form: one thread per element up to 27 / 16
// dofs (0.72-0.83x on point slots at path D's (2, 16, 25)), the owners
// past that (scripts/ab_dense_sweeps.py --part residual, untiled;
// PERF.md).
enum class J2Kernel { RESIDUAL, SLOTS, RING };
template <int DIM, bool TILED, bool LINEAR, bool VISC, bool F32_BLOCK>
constexpr J2Kernel j2_kernel() {
  if (LINEAR) return J2Kernel::RESIDUAL;
  if (TILED || DIM == 2) return J2Kernel::SLOTS;
  return VISC || !F32_BLOCK ? J2Kernel::RESIDUAL : J2Kernel::RING;
}

// the residual (TANGENT false) or assemble kernel of J2 (material 0) or
// J2Linear (material 1) at (dim, nd, nq), inviscid or viscous, with the Cauchy
// block or (full) the DIM^4 planes of dP/dF
template <bool TANGENT>
int j2_entry(const float* u_el, const float* a_el, const float* v_el, const float* dN,
             const float* N, const float* wq, const float* ps, const float* eqps,
             const float* temp, const float* beta, float* out, DenseBlock* cout, int full,
             const J2Params& p, float mu_v, int material, int dim, int nd, int nq, long long E,
             void* stream) {
  if (E <= 0) return 0;
  if (material != 0 && material != 1) return cudaErrorInvalidValue;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    constexpr bool TILED = S::TILED;
    auto go = [&](auto linear, auto store) {
      constexpr bool LINEAR = decltype(linear)::value;
      using Mat = DenseJ2<DIM, LINEAR>;
      using Store = decltype(store);
      const Mat mat{p, ps, eqps, temp, beta};
      auto launch = [&](auto visc) -> int {
        constexpr bool VISC = decltype(visc)::value;
        constexpr J2Kernel K =
            j2_kernel<DIM, TILED, LINEAR, VISC, std::is_same<DenseBlock, float>::value>();
        if constexpr (K == J2Kernel::SLOTS)
          return launch_dense_slot<Store, S, TANGENT, VISC>(mat, u_el, a_el, v_el, dN, N, wq,
                                                            out, cout, p.rho, mu_v, E, stream);
        else if constexpr (K == J2Kernel::RING)
          return launch_dense_ring<Mat, Store, S, TANGENT, VISC>(
              u_el, a_el, dN, N, wq, out, cout, mat, p.rho, E, stream, v_el, mu_v);
        else
          return launch_dense_residual<Mat, Store, S, TANGENT, VISC>(
              u_el, a_el, dN, N, wq, out, cout, mat, p.rho, E, stream, v_el, mu_v);
      };
      if (v_el) return launch(std::true_type{});
      return launch(std::false_type{});
    };
    auto by_store = [&](auto linear) {
      if constexpr (TANGENT) {  // the residual writes no block
        if (full) return go(linear, FullStorage<DIM>{});
      }
      return go(linear, CauchyStorage<DIM>{});
    };
    if (material == 1) return by_store(std::true_type{});
    return by_store(std::false_type{});
  });
}

}  // namespace

// C entry points, Cauchy-decomposition storage; J2 (material 0; the state
// pointers ps, eqps, temp) or J2Linear (material 1; ps, eqps, beta); (dim,
// nd, nq) the shape of the build; v_el ==
// nullptr (visc == 0 for the matvec) selects the inviscid instantiation; the
// assemble's `full` the DIM^4 planes of dP/dF (FullStorage<DIM>, the matvec
// mimi_matvec_dense_full of sweeps_dense_finite.cu) for the Cauchy block; the
// block (and the matvec's dN, N) in DenseBlock, __nv_bfloat16 in the _bf16
// entry points.  Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a material not instantiated or another shape.
extern "C" {

#ifndef MIMI_DENSE_BF16
int mimi_residual_dense_j2(const float* u_el, const float* a_el, const float* v_el,
                           const float* dN, const float* N, const float* wq, const float* ps,
                           const float* eqps, const float* temp, const float* beta,
                           float* out, J2Params p, float mu_v, int material, int dim, int nd, int nq,
                           long long E, void* stream) {
  return j2_entry<false>(u_el, a_el, v_el, dN, N, wq, ps, eqps, temp, beta, out, nullptr, 0,
                         p, mu_v, material, dim, nd, nq, E, stream);
}
#endif

int MIMI_DENSE_ENTRY(mimi_assemble_dense_j2)(const float* u_el, const float* a_el,
                                             const float* v_el, const float* dN,
                                             const float* N, const float* wq, const float* ps,
                                             const float* eqps, const float* temp,
                                             const float* beta, float* out, DenseBlock* cout,
                                             int full, J2Params p, float mu_v, int material,
                                             int dim, int nd, int nq, long long E, void* stream) {
  return j2_entry<true>(u_el, a_el, v_el, dN, N, wq, ps, eqps, temp, beta, out, cout, full, p,
                        mu_v, material, dim, nd, nq, E, stream);
}

int MIMI_DENSE_ENTRY(mimi_matvec_dense_cauchy)(const float* w_el, const DenseBlock* dN,
                                               const DenseBlock* N, const float* wq,
                                               const DenseBlock* cb, float* out, float rho,
                                               float fac0, int visc, float fac1_mu_v, int dim,
                                               int nd, int nq, long long E, void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    if (visc)
      return launch_dense_matvec<CauchyStorage<DIM>, S, true>(
          w_el, dN, N, wq, cb, out, rho, fac0, E, stream, fac1_mu_v);
    return launch_dense_matvec<CauchyStorage<DIM>, S>(w_el, dN, N, wq, cb, out, rho,
                                                           fac0, E, stream);
  });
}

}  // extern "C"
