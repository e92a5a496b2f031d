// Dense-table quadrature sweeps of the finite-strain plasticity models
// J2Simo and J2Log with the full tangent storage, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch with c_storage="full":
//   mimi_residual_dense_finite <- make_residual_sweep (dense, J2Simo / J2Log state)  residual only
//   mimi_assemble_dense_finite <- make_assemble_sweep (dense, "full")               residual + DIM^4 planes
//   mimi_matvec_dense_full     <- make_matvec_sweep ("full")                       y = J w
// each inviscid or viscous (VISC: the residual and the assemble add
// mu_v grad v to P, the matvec fac1 mu_v grad w, as sweeps_dense.cu says),
// at the shape of the build (any (DIM, ND, NQ)): 2D patches (the golden
// cantilever at p = 3, the examples at p = 2) and multi-patch or
// knot-repeated 3D meshes.  The residual and the assemble are
// dense_common.cuh's dense_slot_kernel (one thread per element and point
// slot, at every shape, the tangent's forward-mode passes dealt over the
// warps, J2 and J2Linear's kernel at the untiled shapes too); the matvec
// is dense_common.cuh's (design notes at the head of sweeps_dense.cu).  A J2Log sweep is two launches: the fast log series
// and, where a point of it left the series' range, the deep one
// (finite.cuh).  `material` 0 is J2Simo, 1 J2Log
// (ops/sweeps.py FULL_KERNELS).  The plain torch versions are
// residual_dense_plain, assemble_dense_plain (full_tangent_planes) and
// matvec_dense_plain (tangent_apply_full) with these materials.  The
// matvec also applies the full block that J2, J2Linear
// (sweeps_dense_j2.cu) and the hyperelastic materials (sweeps_dense.cu)
// write when it is asked for.
//
// The point bodies are finite.cuh's, shared with the sum-factorized
// sweeps: P(F, state) written once for float and for forward-mode dual
// numbers; the assemble runs it once in float and DIM^2 times in Dual
// (4 passes in 2D, 9 in 3D) and stores FullStorage<DIM>,
// C[a DIM^2 + b] = dP_a / dF_b: 16 planes in 2D, 81 in 3D.  The state is
// read at each point: J2Simo be_old, F_old (DIM, DIM, NQ, E), eqps and
// temperature (NQ, E); J2Log Fp_inv, eqps, temperature.
//
// What bounds them on the H100: bytes on elastic points for the residual
// and the matvec.  At 512^2 (2D, p = 3, 262,144 elements, 25 points each)
// the residual streams dN 0.84 GB, N 0.42 GB, J2Simo's state 0.26 GB and
// w det J, ~1.65 GB (0.49 ms at 3.35 TB/s); the matvec reads the 16 planes
// (0.42 GB) in place of the state.  The assemble runs the material
// DIM^2 + 1 times per point (J2Log's square-root iterations: ~8,500
// operations per dual pass in 3D), so it may turn compute bound; a plastic
// point adds the radial return's iterations (up to 40 safeguarded
// Newton-bisection trips with powf / logf, the reference kernels' cap)
// once, in the float pass.
//
// Rounding: the source is built without FMA (ops/build.py NO_FMAD).  F is
// formed in the plain version's order (dense_common.cuh grad_q_of), so it
// agrees with the plain version to the bit; the material body then rounds
// in its own order (cbrtf against torch's x ** (1/3)), so the trial state,
// and at points right at the yield surface the yield decision, may differ
// from the plain version's by float32 rounding.
//
// bfloat16 (sweeps_dense_finite_bf16.cu, MIMI_DENSE_BF16, built with
// -fmad=false as this source): mimi_assemble_dense_finite_bf16 stores the
// full block rounded to nearest even, mimi_matvec_dense_full_bf16 reads it
// with the bfloat16 copies of dN and N, as sweeps_dense.cu says.

#include <cuda_runtime.h>

#include "finite.cuh"
#include "dense_common.cuh"
#include "materials.cuh"

namespace {

template <class S, bool TANGENT, bool VISC>
int launch_finite(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                  const float* N, const float* wq, const float* s0, const float* s1,
                  const float* s2, const float* s3, float* out, DenseBlock* cout,
                  const J2Params& p, float mu_v, int material, long long E, void* stream) {
  return with_finite_material<S::DIM>(
      material, p, s0, s1, s2, s3, stream, [&](const auto& m) {
        return launch_dense_slot<FullStorage<S::DIM>, S, TANGENT, VISC>(
            m, u_el, a_el, v_el, dN, N, wq, out, cout, p.rho, mu_v, E, stream);
      });
}

template <bool TANGENT>
int finite_entry(const float* u_el, const float* a_el, const float* v_el, const float* dN,
                 const float* N, const float* wq, const float* s0, const float* s1,
                 const float* s2, const float* s3, float* out, DenseBlock* cout,
                 const J2Params& p, float mu_v, int material, int dim, int nd, int nq, long long E,
                 void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    if (v_el)
      return launch_finite<S, TANGENT, true>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3,
                                                  out, cout, p, mu_v, material, E, stream);
    return launch_finite<S, TANGENT, false>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3,
                                                 out, cout, p, mu_v, material, E, stream);
  });
}

}  // namespace

// C entry points, full storage; (dim, nd, nq) the shape of the build.  The state leaves s0..s3 in the order
// of ops/sweeps.py FULL_KERNELS (J2Simo be_old, F_old, eqps, temperature;
// J2Log Fp_inv, eqps, temperature, s3 unused); v_el == nullptr (visc == 0
// for the matvec) selects the inviscid instantiation; the block (and the
// matvec's dN, N) in DenseBlock, __nv_bfloat16 in the _bf16 entry points.
// Each returns the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for another shape or an unknown material.
extern "C" {

#ifndef MIMI_DENSE_BF16
int mimi_residual_dense_finite(const float* u_el, const float* a_el, const float* v_el,
                               const float* dN, const float* N, const float* wq,
                               const float* s0, const float* s1, const float* s2,
                               const float* s3, float* out, J2Params p, float mu_v,
                               int material, int dim, int nd, int nq, long long E, void* stream) {
  return finite_entry<false>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3, out, nullptr, p,
                             mu_v, material, dim, nd, nq, E, stream);
}
#endif

int MIMI_DENSE_ENTRY(mimi_assemble_dense_finite)(const float* u_el, const float* a_el,
                                                 const float* v_el, const float* dN,
                                                 const float* N, const float* wq,
                                                 const float* s0, const float* s1,
                                                 const float* s2, const float* s3, float* out,
                                                 DenseBlock* cout, J2Params p, float mu_v,
                                                 int material, int dim, int nd, int nq, long long E,
                                                 void* stream) {
  return finite_entry<true>(u_el, a_el, v_el, dN, N, wq, s0, s1, s2, s3, out, cout, p, mu_v,
                            material, dim, nd, nq, E, stream);
}

// J2Log's sweeps whose deep launch ran (finite.cuh), since the library was
// loaded, into *launches; waits for the device
int MIMI_DENSE_ENTRY(mimi_logm_deep_dense_finite)(long long* launches) {
  return logm_deep_count(launches);
}

int MIMI_DENSE_ENTRY(mimi_matvec_dense_full)(const float* w_el, const DenseBlock* dN,
                                             const DenseBlock* N, const float* wq,
                                             const DenseBlock* cf, float* out, float rho,
                                             float fac0, int visc, float fac1_mu_v, int dim,
                                             int nd, int nq, long long E, void* stream) {
  if (E <= 0) return 0;
  return with_dense_shape(dim, nd, nq, [&](auto shape) {
    using S = decltype(shape);
    constexpr int DIM = S::DIM;
    if (visc)
      return launch_dense_matvec<FullStorage<DIM>, S, true>(w_el, dN, N, wq, cf, out, rho,
                                                                 fac0, E, stream, fac1_mu_v);
    return launch_dense_matvec<FullStorage<DIM>, S>(w_el, dN, N, wq, cf, out, rho, fac0,
                                                         E, stream);
  });
}

}  // extern "C"
