// Sum-factorized sweeps of the finite-strain plasticity models J2Simo and
// J2Log with the 81-plane full tangent, for sm_90a.
//
// Replaces the `full` branch of three Pallas TPU kernels of
// mimi_tpu/ops/sweeps.py on the sum-factorized tables:
//   residual_kernel<J2SimoMat<3> | J2LogMat<3>, FullStorage<3>, false, ..>  <- make_residual_sweep (sf_mode)
//   residual_kernel<J2SimoMat<3> | J2LogMat<3>, FullStorage<3>, true, ..>   <- make_assemble_sweep (sf, full, :620-648)
//   matvec_kernel<FullStorage<3>, false, float>                              <- make_matvec_sweep_sf (full, :820-836)
// C entry points mimi_residual_sf_finite, mimi_assemble_sf_finite
// (`material`: 0 J2Simo, 1 J2Log) and mimi_matvec_sf_full; inviscid, the
// block in float32.  The kernel templates are in sf_common.cuh, the
// materials' point bodies (one `template <class T>` P(F, state), run in
// float and in forward-mode dual numbers for the 9 tangent columns) and
// the radial return's implicit-function-theorem correction in finite.cuh,
// FullStorage<3> in materials.cuh; the plain torch versions of the same
// functions in ops/sweeps.py (full_tangent_planes, tangent_apply_full).
// The dense-table sweeps of the same materials are sweeps_dense_finite.cu.
//
// What bounds them on the H100: the matvec streams the 81-plane block
// (20.7 KB per element, 2.29 GB at 48^3) plus jinv once per GMRES
// iteration, bandwidth bound (~0.8 ms at 3.35 TB/s).  The assemble writes
// the same 2.29 GB and runs the material 10 times per point (float + 9
// dual passes; J2Log's ~50 3 x 3 inverses and products per pass), so it
// may turn compute bound; plastic points add the radial return's capped
// 100 trips once, in the float pass.

#include "finite.cuh"
#include "sf_common.cuh"

namespace {

template <bool TANGENT>
int launch_finite_material(const float* u_el, const float* a_el, const Tables& tb,
                           const float* jinv, const float* wq, const float* s0,
                           const float* s1, const float* s2, const float* s3, float* out,
                           float* cout, const J2Params& p, int material, long long E,
                           void* stream) {
  return with_finite_material<3>(material, p, s0, s1, s2, s3, [&](const auto& m) {
    using Mat = std::decay_t<decltype(m)>;
    return launch_residual<Mat, FullStorage<3>, TANGENT, false, float>(
        u_el, a_el, nullptr, tb, jinv, wq, out, cout, m, p.rho, 0.f, E, stream);
  });
}

}  // namespace

// C entry points; each returns the launch's cudaGetLastError().  The state
// leaves s0..s3 in the order of ops/sweeps.py FULL_KERNELS: J2Simo be_old,
// F_old, eqps, temperature; J2Log Fp_inv, eqps, temperature (s3 unused).
extern "C" {

int mimi_residual_sf_finite(const float* u_el, const float* a_el, const float* b0,
                            const float* d0, const float* b1, const float* d1,
                            const float* b2, const float* d2, const float* jinv,
                            const float* wq, const float* s0, const float* s1,
                            const float* s2, const float* s3, float* out, J2Params p,
                            int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<false>(u_el, a_el, tb, jinv, wq, s0, s1, s2, s3, out, nullptr,
                                       p, material, E, stream);
}

int mimi_assemble_sf_finite(const float* u_el, const float* a_el, const float* b0,
                            const float* d0, const float* b1, const float* d1,
                            const float* b2, const float* d2, const float* jinv,
                            const float* wq, const float* s0, const float* s1,
                            const float* s2, const float* s3, float* out, float* cout,
                            J2Params p, int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<true>(u_el, a_el, tb, jinv, wq, s0, s1, s2, s3, out, cout, p,
                                      material, E, stream);
}

int mimi_matvec_sf_full(const float* w_el, const float* b0, const float* d0,
                        const float* b1, const float* d1, const float* b2,
                        const float* d2, const float* jinv, const float* wq,
                        const float* cf, float* out, float rho, float fac0, long long E,
                        void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_matvec<FullStorage<3>, false, float>(w_el, tb, jinv, wq, cf, out, rho, fac0, 0.f,
                                                  E, stream);
}

}  // extern "C"
