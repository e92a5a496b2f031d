// Sum-factorized sweeps of the finite-strain plasticity models J2Simo and
// J2Log with the 81-plane full tangent, for sm_90a.
//
// Replaces the `full` branch of three Pallas TPU kernels of
// mimi_tpu/ops/sweeps.py on the sum-factorized tables:
//   SfResidualPoint<J2SimoMat<3> | J2LogMat<3>, FullStorage<3>, false, VISC, float>  <- make_residual_sweep (sf_mode)
//   SfResidualPoint<J2SimoMat<3> | J2LogMat<3>, FullStorage<3>, true, VISC, CT>      <- make_assemble_sweep (sf, full, :620-648)
//   SfMatvecPoint<FullStorage<3>, VISC, CT>                                           <- make_matvec_sweep_sf (full, :820-836)
// C entry points mimi_residual_sf_finite, mimi_assemble_sf_finite
// (`material`: 0 J2Simo, 1 J2Log) and mimi_matvec_sf_full (the matvec of
// every material's full block: J2 and J2Linear write one in sweeps_sf.cu,
// the hyperelastic materials in sweeps_sf_hyper.cu).  Each comes inviscid
// or with the viscous flux of has_visc (v_el != nullptr, visc != 0: the
// residual and the assemble add mu_v grad v to P, the matvec fac1 mu_v
// grad w), the block in float32 or bfloat16 (c_bf16: rounded to nearest
// even by the assemble, widened on load by the matvec), as the Cauchy and
// symmetric storages' do.  The kernel templates are in sf_common.cuh, the
// materials' point bodies (one `template <class T>` P(F, state), run in
// float and in forward-mode dual numbers for the 9 tangent columns) and
// the radial return's implicit-function-theorem correction in finite.cuh,
// FullStorage<3> in materials.cuh; the plain torch versions of the same
// functions in ops/sweeps.py (full_tangent_planes, tangent_apply_full).
// The dense-table sweeps of the same materials are sweeps_dense_finite.cu.
//
// What bounds them on the H100: the matvec streams the 81-plane block
// (20.7 KB per element in float32, 10.4 KB in bfloat16: 2.29 / 1.15 GB at
// 48^3) plus jinv once per GMRES iteration, bandwidth bound (~0.8 / ~0.45
// ms at 3.35 TB/s).  The assemble writes the same block and runs the
// material 10 times per point (float + 9 dual passes; J2Log's ~50 3 x 3
// inverses and products per pass), so it may turn compute bound; plastic
// points add the radial return's trips (at most 40) once, in the float
// pass.  The viscous residual stages v in shared memory beside u and a
// (46.5 KB a block).

#include "finite.cuh"
#include "sf_common.cuh"

namespace {

template <bool TANGENT>
int launch_finite_material(const float* u_el, const float* a_el, const float* v_el,
                           const Tables& tb, const float* jinv, const float* wq,
                           const float* s0, const float* s1, const float* s2, const float* s3,
                           float* out, void* cout, int c_bf16, const J2Params& p, float mu_v,
                           int material, long long E, void* stream) {
  return with_finite_material<3>(material, p, s0, s1, s2, s3, [&](const auto& m) {
    using Mat = std::decay_t<decltype(m)>;
#define MIMI_FINITE(VISC, CT)                                                              \
  return launch_residual<Sf, Mat, FullStorage<3>, TANGENT, VISC, CT>(                      \
      u_el, a_el, v_el, tb, jinv, wq, out, cout, m, p.rho, mu_v, E, stream)
    if constexpr (TANGENT) {  // the residual writes no block
      if (c_bf16) {
        if (v_el) MIMI_FINITE(true, __nv_bfloat16);
        MIMI_FINITE(false, __nv_bfloat16);
      }
    }
    if (v_el) MIMI_FINITE(true, float);
    MIMI_FINITE(false, float);
#undef MIMI_FINITE
  });
}

}  // namespace

// C entry points (named *_p3 in the p = 3 twin of this source:
// MIMI_SF_ENTRY); each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown material.  The state leaves s0..s3
// in the order of ops/sweeps.py FULL_KERNELS: J2Simo be_old, F_old, eqps,
// temperature; J2Log Fp_inv, eqps, temperature (s3 unused).  v_el ==
// nullptr (visc == 0 for the matvec) selects the inviscid instantiation,
// c_bf16 the bfloat16 block.
extern "C" {

int MIMI_SF_ENTRY(mimi_residual_sf_finite)(const float* u_el, const float* a_el, const float* v_el,
                            const float* b0, const float* d0, const float* b1,
                            const float* d1, const float* b2, const float* d2,
                            const float* jinv, const float* wq, const float* s0,
                            const float* s1, const float* s2, const float* s3, float* out,
                            J2Params p, float mu_v, int material, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<false>(u_el, a_el, v_el, tb, jinv, wq, s0, s1, s2, s3, out,
                                       nullptr, 0, p, mu_v, material, E, stream);
}

int MIMI_SF_ENTRY(mimi_assemble_sf_finite)(const float* u_el, const float* a_el, const float* v_el,
                            const float* b0, const float* d0, const float* b1,
                            const float* d1, const float* b2, const float* d2,
                            const float* jinv, const float* wq, const float* s0,
                            const float* s1, const float* s2, const float* s3, float* out,
                            void* cout, int c_bf16, J2Params p, float mu_v, int material,
                            long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  return launch_finite_material<true>(u_el, a_el, v_el, tb, jinv, wq, s0, s1, s2, s3, out,
                                      cout, c_bf16, p, mu_v, material, E, stream);
}

int MIMI_SF_ENTRY(mimi_matvec_sf_full)(const float* w_el, const float* b0, const float* d0,
                        const float* b1, const float* d1, const float* b2,
                        const float* d2, const float* jinv, const float* wq,
                        const void* cf, int c_bf16, float* out, float rho, float fac0,
                        int visc, float fac1_mu_v, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
#define MIMI_MV(VISC, CT)                                                                 \
  return launch_matvec<Sf, FullStorage<3>, VISC, CT>(w_el, tb, jinv, wq, cf, out, rho, fac0, \
                                                     fac1_mu_v, E, stream)
  if (visc) {
    if (c_bf16) MIMI_MV(true, __nv_bfloat16);
    MIMI_MV(true, float);
  }
  if (c_bf16) MIMI_MV(false, __nv_bfloat16);
  MIMI_MV(false, float);
#undef MIMI_MV
}

}  // extern "C"
