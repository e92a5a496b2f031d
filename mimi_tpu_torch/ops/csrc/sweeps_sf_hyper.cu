// Sum-factorized sweeps of the hyperelastic materials (neo-Hookean, St.
// Venant-Kirchhoff) with the 45-plane symmetric tangent, for sm_90a.
//
// Replaces the c_storage="sym" branch of three Pallas TPU kernels of
// mimi_tpu/ops/sweeps.py on the sum-factorized tables:
//   SfResidualPoint<Hyper<..>, SymStorage<3>, false, VISC, float>  <- make_residual_sweep (sf_mode)
//   SfResidualPoint<Hyper<..>, SymStorage<3>, true, VISC, CT>      <- make_assemble_sweep (sf, "sym")
//   SfResidualPoint<Hyper<..>, FullStorage<3>, true, VISC, CT>     <- make_assemble_sweep (sf, "full")
//   SfMatvecPoint<SymStorage<3>, VISC, CT>                         <- make_matvec_sweep_sf ("sym")
// C entry points mimi_residual_sf_hyper, mimi_assemble_sf_hyper
// (`material`: 0 the neo-Hookean, 1 the St. Venant-Kirchhoff material) and
// mimi_matvec_sf_sym.  Each comes inviscid or with the viscous flux of
// has_visc (v_el != nullptr, visc != 0: the residual and the assemble add
// mu_v grad v to P, sweeps.py:404-414, :651-664; the matvec adds
// fac1 mu_v grad w, :816-834), the block in float32 or in bfloat16
// (c_bf16: the assemble rounds each plane to nearest even, the matvec
// widens it on load; c_dtype, sweeps.py:474, :595-617).  The kernel
// templates, and the design notes, are in sf_common.cuh and at the head of
// sweeps_sf.cu; the materials and SymStorage<3> in materials.cuh; the plain
// torch versions in ops/sweeps.py (sym_tangent_planes, tangent_apply_sym).
//
// What bounds them on the H100: bytes.  At 48^3 the assemble writes the 45
// planes (1.27 GB in float32, 0.64 GB in bfloat16) besides reading the
// tables, jinv and the element fields (v_el too when viscous); the matvec
// reads them once per GMRES iteration: ~0.50 ms in float32 and ~0.32 ms in
// bfloat16 at 3.35 TB/s.  Per point they do ~1-2 thousand flops against
// ~200-300 bytes, under the float32 ridge.

#include "sf_common.cuh"

namespace {

template <class H, class Store, bool TANGENT, bool VISC, typename CT>
int launch_hyper(const float* u_el, const float* a_el, const float* v_el, const Tables& tb,
                 const float* jinv, const float* wq, float* out, void* cout,
                 const HyperelasticParams& p, float mu_v, long long E, void* stream) {
  return launch_residual<Sf, Hyper<H>, Store, TANGENT, VISC, CT>(
      u_el, a_el, v_el, tb, jinv, wq, out, cout, Hyper<H>{H{p.mu, p.lam}}, p.rho, mu_v, E,
      stream);
}

// the material's instantiation for (v_el given, c_bf16) with the block of
// Store
template <class H, class Store, bool TANGENT>
int hyper_variant(const float* u_el, const float* a_el, const float* v_el, const Tables& tb,
                  const float* jinv, const float* wq, float* out, void* cout, int c_bf16,
                  const HyperelasticParams& p, float mu_v, long long E, void* stream) {
#define MIMI_HYPER(VISC, CT)                                                                   \
  return launch_hyper<H, Store, TANGENT, VISC, CT>(u_el, a_el, v_el, tb, jinv, wq, out, cout, \
                                                   p, mu_v, E, stream)
  if constexpr (TANGENT) {  // the residual writes no block
    if (c_bf16) {
      if (v_el) MIMI_HYPER(true, __nv_bfloat16);
      MIMI_HYPER(false, __nv_bfloat16);
    }
  }
  if (v_el) MIMI_HYPER(true, float);
  MIMI_HYPER(false, float);
#undef MIMI_HYPER
}

// the material's instantiations with the symmetric block or (full) the
// 81 planes of dP/dF
template <class H, bool TANGENT>
int hyper_storage(const float* u_el, const float* a_el, const float* v_el, const Tables& tb,
                  const float* jinv, const float* wq, float* out, void* cout, int c_bf16,
                  int full, const HyperelasticParams& p, float mu_v, long long E,
                  void* stream) {
  if constexpr (TANGENT) {
    if (full)
      return hyper_variant<H, FullStorage<3>, true>(u_el, a_el, v_el, tb, jinv, wq, out, cout,
                                                    c_bf16, p, mu_v, E, stream);
  }
  return hyper_variant<H, SymStorage<3>, TANGENT>(u_el, a_el, v_el, tb, jinv, wq, out, cout,
                                                  c_bf16, p, mu_v, E, stream);
}

template <bool TANGENT>
int hyper_entry(const float* u_el, const float* a_el, const float* v_el, const float* b0,
                const float* d0, const float* b1, const float* d1, const float* b2,
                const float* d2, const float* jinv, const float* wq, float* out, void* cout,
                int c_bf16, int full, const HyperelasticParams& p, float mu_v, int material,
                long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
  if (material == 0)
    return hyper_storage<NeoHookean<3>, TANGENT>(u_el, a_el, v_el, tb, jinv, wq, out, cout,
                                                 c_bf16, full, p, mu_v, E, stream);
  if (material == 1)
    return hyper_storage<StVK<3>, TANGENT>(u_el, a_el, v_el, tb, jinv, wq, out, cout, c_bf16,
                                           full, p, mu_v, E, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points (at the shape of the build: MIMI_SF_P1, MIMI_SF_NG); each
// returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a material not instantiated.  `full` selects
// the 81 planes of dP/dF (FullStorage<3>, the matvec mimi_matvec_sf_full of
// sweeps_sf_finite.cu) for the 45 symmetric ones.
extern "C" {

int mimi_residual_sf_hyper(const float* u_el, const float* a_el, const float* v_el,
                           const float* b0, const float* d0, const float* b1, const float* d1,
                           const float* b2, const float* d2, const float* jinv,
                           const float* wq, float* out, HyperelasticParams p, float mu_v,
                           int material, long long E, void* stream) {
  return hyper_entry<false>(u_el, a_el, v_el, b0, d0, b1, d1, b2, d2, jinv, wq, out, nullptr,
                            0, 0, p, mu_v, material, E, stream);
}

int mimi_assemble_sf_hyper(const float* u_el, const float* a_el, const float* v_el,
                           const float* b0, const float* d0, const float* b1, const float* d1,
                           const float* b2, const float* d2, const float* jinv,
                           const float* wq, float* out, void* cout, int c_bf16, int full,
                           HyperelasticParams p, float mu_v, int material, long long E,
                           void* stream) {
  return hyper_entry<true>(u_el, a_el, v_el, b0, d0, b1, d1, b2, d2, jinv, wq, out, cout,
                           c_bf16, full, p, mu_v, material, E, stream);
}

int mimi_matvec_sf_sym(const float* w_el, const float* b0, const float* d0,
                       const float* b1, const float* d1, const float* b2, const float* d2, const float* jinv,
                       const float* wq, const void* cs, int c_bf16, float* out, float rho,
                       float fac0, int visc, float fac1_mu_v, long long E, void* stream) {
  if (E <= 0) return 0;
  Tables tb{{b0, d0, b1, d1, b2, d2}};
#define MIMI_MV(VISC, CT)                                                                \
  return launch_matvec<Sf, SymStorage<3>, VISC, CT>(w_el, tb, jinv, wq, cs, out, rho, fac0, \
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
