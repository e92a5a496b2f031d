"""The viscous and bfloat16 branches of the symmetric-storage sweeps of the
port (mimi_tpu_torch) against the reference package, and the viscous
neo-Hookean cube press with the frozen contact tangent.

  - the plain sf sweeps with the symmetric storage, viscous, the block
    rounded to bfloat16, against the reference's Pallas kernels
    (`make_residual_sweep`, `make_assemble_sweep` with c_storage="sym",
    c_dtype=bfloat16, `make_matvec_sweep_sf`) in interpret mode (float32,
    8 elements, the bars of tests/test_torch_sweeps.py), and the viscous
    flux in float64 against the same math in JAX (1e-10);
  - the press of tests/test_contact.py:146-196 (cube-nurbs.mesh at p=2,
    the bottom face clamped, the top face pressed by a rigid bilinear
    tool, the viscous neo-Hookean material of the examples) cut to 4^3
    elements, the tool moving 0.01 per step from touching the top face:
    3 engaged steps of the port's plain path with default arguments (the
    frozen contact tangent, a float32-typed block in float64) against the
    reference's `soa` step at 1e-8 of each field's scale;
  - what make_step takes with the bfloat16 block and what still raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu import splines as jspl
from mimi_tpu.ops import sweeps as jsw
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch import splines as tspl
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, material_from_reference
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

MESH = os.path.join(os.path.dirname(__file__), "data", "cube-nurbs.mesh")
DT, RHO, FAC0 = 0.01, 1e3, 1e-5
MU_V, FAC1 = 100.0, 0.3
KAPPA = 5e7


def _material(pkg):
    mat = pkg.CompressibleOgdenNeoHookean()
    mat.density = RHO
    mat.viscosity = MU_V
    mat.set_young_poisson(1e6, 0.3)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


@pytest.fixture(scope="module")
def case():
    """8 elements (p=2, 4^3 Gauss points) and element fields made with
    numpy: u at strains of ~5-10%, a and w of unit size, v of a size that
    makes the viscous flux a real part of the residual."""
    prob = jsh.build_problem(MESH, 1, 1, _material(mimi), [(1, 0), (1, 1), (1, 2)], {},
                             dtype=jnp.float64)
    E = prob.n_el
    rng = np.random.default_rng(14)
    return {
        "n_el": E,
        "u_el": 0.02 * rng.standard_normal((3, 27, E)),
        "a_el": rng.standard_normal((3, 27, E)),
        "v_el": 50.0 * rng.standard_normal((3, 27, E)),
        "w_el": rng.standard_normal((3, 27, E)),
        "tabs": [np.asarray(t) for t in prob.sf["tables"]],
        "jinv": np.asarray(prob.sf["jinv"]),
        "wq": np.ascontiguousarray(np.asarray(prob.w_detJ).T),
        "dN_t": np.transpose(prob.dN_dX, (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(prob.N, (2, 1, 0)).copy(),
    }


def _sf_args(data, dtype):
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (
        t(data["u_el"]), t(data["a_el"]), None,
        [t(x) for x in data["tabs"]], t(data["jinv"]), t(data["wq"]),
    )


@pytest.fixture(scope="module")
def pallas(case):
    """The viscous sf Pallas sweeps in interpret mode, float32, with the
    symmetric storage: residual, assemble with a bfloat16 block, and the
    matvec on that block."""
    j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    E = case["n_el"]
    tabs = [j(x) for x in case["tabs"]]
    args = (j(case["u_el"]), j(case["a_el"]), j(case["v_el"]), None, *tabs, j(case["jinv"]),
            j(case["wq"]))
    kw = dict(
        mat=_material(mimi), dt=DT, dim=3, nd=27, n_q=64, n_el=E, rho=RHO, mu_v=MU_V,
        has_visc=True, state=None, block_e=E, interpret=True, sf_mode=True, n_g=4, pp1=3,
    )
    y_res = jsw.make_residual_sweep(**kw)(*args)
    y_asm, C = jsw.make_assemble_sweep(**kw, c_storage="sym", c_dtype=jnp.bfloat16)(*args)
    assert C.dtype == jnp.bfloat16
    y_mv = jsw.make_matvec_sweep_sf(
        dim=3, nd=27, n_q=64, n_el=E, rho=RHO, fac0=FAC0, fac1_mu_v=FAC1 * MU_V,
        has_visc=True, block_e=E, interpret=True, c_storage="sym", n_g=4, pp1=3,
    )(j(case["w_el"]), *tabs, j(case["jinv"]), j(case["wq"]), C)
    return {"res": np.asarray(y_res), "asm": np.asarray(y_asm), "mv": np.asarray(y_mv),
            # bfloat16 -> float32 is exact, and so is the way back
            "C": np.asarray(C).astype(np.float32)}


def _visc(data, dtype=torch.float32):
    return dict(v_el=torch.tensor(data["v_el"], dtype=dtype), mu_v=MU_V)


def test_visc_sym_residual_matches_pallas(case, pallas):
    mat = _material(mt)
    args = _sf_args(case, torch.float32)
    y = tsw.residual_sf_plain(*args, mat, DT, RHO, **_visc(case))
    assert _rel(y.numpy(), pallas["res"]) < 1e-4
    # the viscous flux is a real part of the residual here
    assert _rel(tsw.residual_sf_plain(*args, mat, DT, RHO).numpy(), pallas["res"]) > 1e-2


def test_visc_bf16_sym_assemble_matches_pallas(case, pallas):
    """Residual at the float32 bar; the 45 bfloat16 planes (one group)
    within one bfloat16 rounding step, 2^-7 of their max; the stored block
    is the float32 block rounded to nearest even."""
    mat = _material(mt)
    args = _sf_args(case, torch.float32)
    y, C = tsw.assemble_sf_plain(*args, mat, DT, RHO, **_visc(case), c_dtype=torch.bfloat16)
    assert C.dtype == torch.bfloat16 and C.shape == (45, 64, case["n_el"])
    assert _rel(y.numpy(), pallas["asm"]) < 1e-4
    assert _rel(C.float().numpy(), pallas["C"]) <= 2.0**-7
    _, C32 = tsw.assemble_sf_plain(*args, mat, DT, RHO, **_visc(case))
    assert torch.equal(C, C32.to(torch.bfloat16))


def test_visc_bf16_sym_matvec_matches_pallas(case, pallas):
    """Both matvecs read the same bfloat16 block, widen it on load and add
    fac1 mu_v grad w."""
    _, _, _, tabs, jinv, wq = _sf_args(case, torch.float32)
    Cb = torch.tensor(pallas["C"]).to(torch.bfloat16)
    w = torch.tensor(case["w_el"], dtype=torch.float32)
    y = tsw.matvec_sf_plain(w, tabs, jinv, wq, Cb, RHO, FAC0, FAC1 * MU_V, storage="sym")
    assert _rel(y.numpy(), pallas["mv"]) < 1e-3
    y0 = tsw.matvec_sf_plain(w, tabs, jinv, wq, Cb, RHO, FAC0, storage="sym")
    assert _rel(y0.numpy(), pallas["mv"]) > 1e-2


def test_visc_sym_sweeps_match_jax_f64(case):
    """The viscous flux in float64 on the dense tables of the same 8
    elements: residual + mu_v grad v integrated against dN, matvec +
    fac1 mu_v grad w, with P and its jvp from the reference material in
    JAX; 1e-10."""
    ref_mat = _material(mimi)
    j = {k: jnp.asarray(v) for k, v in case.items() if k not in ("n_el", "tabs")}
    dN, N, wq = j["dN_t"], j["N_t"], j["wq"]
    grad = lambda x: jnp.einsum("ndqe,cne->cdqe", dN, x)  # noqa: E731
    F = grad(j["u_el"]) + jnp.eye(3)[:, :, None, None]

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wq, dN, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wq, N, vec
        )

    P, jvp_fn = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, None, DT), F)
    value = lambda x: jnp.einsum("nqe,cne->cqe", N, x)  # noqa: E731
    res = integrate(P + MU_V * grad(j["v_el"]), RHO * value(j["a_el"]))
    dW = grad(j["w_el"])
    mv = integrate(FAC0 * jvp_fn(dW) + FAC1 * MU_V * dW, RHO * value(j["w_el"]))
    mat = material_from_reference(ref_mat)
    args = _sf_args(case, torch.float64)
    y = tsw.residual_sf_plain(*args, mat, DT, RHO, **_visc(case, torch.float64))
    assert _rel(y.numpy(), res) < 1e-10
    ya, C = tsw.assemble_sf_plain(*args, mat, DT, RHO, **_visc(case, torch.float64))
    assert torch.equal(ya, y)
    y_mv = tsw.matvec_sf_plain(torch.tensor(case["w_el"]), args[3], args[4], args[5], C, RHO,
                               FAC0, FAC1 * MU_V, storage="sym")
    assert _rel(y_mv.numpy(), mv) < 1e-10


# ---------------------------------------------------------------------------
# the cube press
# ---------------------------------------------------------------------------


BUILD = dict(dirichlet=[(0, 0), (0, 1), (0, 2)], body_force={}, rho_inf=0.5, refine_spans=4)
STEP = dict(dt=DT, newton_iters=12, solver="cg", cg_iters=80, precond="fdm", rel_tol=1e-8,
            lin_rel_tol=1e-8)
PUSH = [0.0, 0.0, -0.01]


def _tool(pkg, spl, z=1.0):
    sc = pkg.NearestDistanceToSplines()
    sc.add_spline(spl.Bezier([1, 1], [[-0.5, -0.5, z], [-0.5, 1.5, z],
                                      [1.5, -0.5, z], [1.5, 1.5, z]]))
    sc.plant_kd_tree(8, 1)
    sc.coefficient = KAPPA
    return sc


@pytest.fixture(scope="module")
def press():
    ref = jsh.build_problem(MESH, 1, 0, _material(mimi), dtype=jnp.float64,
                            contact=[(1, _tool(mimi, jspl))], **BUILD)
    port = mt.build_problem(MESH, 1, 0, _material(mt), dtype=torch.float64, device="cpu",
                            contact=[(1, _tool(mt, tspl))], **BUILD)
    return ref, port


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = None
    out["contact"] = [{k: np.asarray(x) for k, x in b.items()} for b in carry["contact"]]
    return out


OBSERVABLES = ("force", "area", "pressure", "nodal_pressure", "res_el")


def _max_rel_err(ref, got):
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["contact"][0][k], got["contact"][0][k]) for k in OBSERVABLES]
    return max(
        float(np.abs(np.asarray(b) - np.asarray(a)).max())
        / max(float(np.abs(np.asarray(a)).max()), 1e-300)
        for a, b in pairs
    )


def test_three_engaged_cube_press_steps_match_reference(press):
    """The viscous neo-Hookean cube press at 4^3 with default arguments
    (the frozen contact tangent) on the port's plain path, from the
    reference's initial carry: u, v, a and the contact observables agree
    with the reference's `soa` step to 1e-8 of each field's scale after
    every step, with equal Newton counts; every step is engaged and the
    force presses the cube down."""
    ref, port = press
    assert port.sf is not None and tsw.tangent_storage(port.material) == "sym"
    rstep = jsh.make_step(ref, residual_impl="soa", **STEP)
    pstep = mt.make_step(port, **STEP)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    sd_r, sd_p = ref.contact[0]["scene"], port.contact[0]["scene"]
    for i in range(3):
        sd_r = mimi.NearestDistanceToSplines.translate_scene_data(sd_r, jnp.asarray(PUSH))
        sd_p = mt.NearestDistanceToSplines.translate_scene_data(sd_p, PUSH)
        rc = rstep(rc, contact_scenes=[sd_r])
        pc = pstep(pc, contact_scenes=[sd_p])
        assert pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"]), i
        assert int(pc["contact"][0]["n_engaged"]) > 0
        assert float(pc["contact"][0]["force"][2]) < 0.0
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)


def test_bf16_block_with_contact_and_viscosity(press):
    """make_step takes matvec_dtype="bf16" on the viscous sf press: the
    first Newton system's residual is the float32-typed block's, J w
    within one bfloat16 step of it."""
    _, port = press
    carry = mt.initial_carry(port)
    sd = mt.NearestDistanceToSplines.translate_scene_data(port.contact[0]["scene"], PUSH)
    ns = [mt.make_step(port, matvec_dtype=d, **STEP).newton_system(carry, contact_scenes=[sd])
          for d in ("bf16", "f32")]
    w = torch.tensor(np.random.default_rng(15).standard_normal(ns[0]["r"].shape))
    jw = [n["J_apply"](w) for n in ns]
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    err = float((jw[0] - jw[1]).abs().max())
    assert 0.0 < err <= 2.0**-7 * float(jw[1].abs().max())


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_unported_branches_still_raise(press):
    """The bfloat16 block on dense tables, once unported, is taken: make_step
    runs it on the viscous 2D two-patch press (the Newton system's residual
    is the float32 block's, J w within one bfloat16 step of it, the block
    and the bfloat16 copies of dN and N rounded), and the dense wrappers
    take a bfloat16 block in every storage up to the device check (meta
    tensors: no device is asked); the bfloat16 matvec refuses float32
    tables with a ValueError."""
    dense = mt.build_problem(os.path.join(os.path.dirname(MESH), "two-patch-square.mesh"), 1, 1,
                             _material(mt), [(2, 0), (2, 1)], {}, rho_inf=0.5, device="cpu")
    carry = mt.initial_carry(dense)
    carry["v"] = torch.ones_like(carry["v"]) * dense.free
    ns = [mt.make_step(dense, DT, matvec_dtype=d).newton_system(carry) for d in ("bf16", "f32")]
    w = torch.tensor(np.random.default_rng(16).standard_normal(ns[0]["r"].shape))
    jw = [n["J_apply"](w) for n in ns]
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    err = float((jw[0] - jw[1]).abs().max())
    assert 0.0 < err <= 2.0**-7 * float(jw[1].abs().max())
    E, nq = 8, 16
    w, dN, N, wq = _meta(2, 9, E), _meta(9, 2, nq, E), _meta(9, nq, E), _meta(nq, E)
    dNb, Nb = dN.to(torch.bfloat16), N.to(torch.bfloat16)
    mat = _material(mt)
    mat.setup(2)
    for storage, n in (("sym", 10), ("full", 16)):
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.assemble_dense(w, w, None, dN, N, wq, mat, DT, RHO, c_dtype=torch.bfloat16,
                               storage=storage)
        Cb = _meta(n, nq, E).to(torch.bfloat16)
        with pytest.raises(ValueError, match="tables in the block's dtype"):
            tsw.matvec_dense(w, dN, N, wq, Cb, RHO, FAC0, storage=storage)
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.matvec_dense(w, dNb, Nb, wq, Cb, RHO, FAC0, storage=storage)
