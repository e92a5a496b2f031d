"""The port's hyperelastic single-patch path (mimi_tpu_torch) against the
reference package: cube-nurbs.mesh at p=2, CompressibleOgdenNeoHookean and
StVenantKirchhoff (E 2100, nu 0.3), boundary 1 clamped, body force -3,
on the sum-factorized sweeps with the 45-plane symmetric tangent.

  - StVenantKirchhoff: the stress at 1e-12, its closed-form dP/dF (what
    the CUDA assemble kernels write) against forward-mode AD in torch and
    in JAX at 1e-10;
  - the three plain sf sweeps with the symmetric storage, both materials,
    against the Pallas kernels in interpret mode (float32, 8 elements, the
    bars of tests/test_torch_sweeps.py) and the same math in JAX float64
    (1e-10);
  - the plain fused neo-Hookean residual and matrix-free tangent apply
    (ops/fused_neohookean.py) against the Pallas kernels of
    mimi_tpu/ops/pallas_residual.py in interpret mode (float32) and
    against a float64 reference;
  - three steps of each material's cube at 4^3 against the reference's
    `soa` engine (float64, 1e-8);
  - what make_step takes and what it still refuses.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.ops import sweeps as jsw
from mimi_tpu.ops.pallas_residual import (
    neohookean_residual_pallas,
    neohookean_tangent_apply_pallas,
)
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.ops import fused_neohookean as fused
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

MESH = os.path.join(os.path.dirname(__file__), "data", "cube-nurbs.mesh")
DT, RHO, FAC0 = 0.05, 1.0, 0.01
MATERIALS = ["CompressibleOgdenNeoHookean", "StVenantKirchhoff"]
BUILD = dict(
    elevate=1, dirichlet=[(1, 0), (1, 1), (1, 2)], body_force={1: -3.0}, rho_inf=0.5,
)
STEP = dict(dt=0.05, newton_iters=4, cg_iters=40)


def _material(pkg, name):
    mat = getattr(pkg, name)()
    mat.density = RHO
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    mat.setup(3)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


# ---- (a) St. Venant-Kirchhoff -------------------------------------------------


def _random_F(n=64, scale=0.1, seed=3):
    rng = np.random.default_rng(seed)
    return np.eye(3)[:, :, None] + scale * rng.standard_normal((3, 3, n))


def test_stvk_pk1_matches_reference():
    ref, port = _material(mimi, MATERIALS[1]), _material(mt, MATERIALS[1])
    F = _random_F()
    P_ref = np.asarray(ref.pk1_soa(jnp.asarray(F), None, DT))
    P = port.pk1_soa(torch.tensor(F), None, DT).numpy()
    assert _rel(P, P_ref) < 1e-12
    assert type(material_from_reference(ref)) is mt.StVenantKirchhoff
    assert material_from_reference(ref).lambda_ == port.lambda_


def test_stvk_closed_form_tangent():
    """tangent_soa (the formula of the CUDA assemble kernels' struct StVK)
    against torch.func.jacfwd of pk1_soa and against the reference's jvp
    columns, and its major symmetry."""
    ref, mat = _material(mimi, MATERIALS[1]), _material(mt, MATERIALS[1])
    F = _random_F(n=6)
    C = mat.tangent_soa(torch.tensor(F))
    for e in range(F.shape[-1]):
        Fe = torch.tensor(F[:, :, e : e + 1])
        J = torch.func.jacfwd(lambda x: mat.pk1_soa(x, None, DT))(Fe)
        # (c, d, 1, g, f, 1) -> (c, d, g, f)
        assert _rel(C[..., e], J[:, :, 0, :, :, 0]) < 1e-10
    for b in range(9):
        seed = jnp.zeros_like(jnp.asarray(F)).at[b // 3, b % 3].set(1.0)
        _, col = jax.jvp(lambda x: ref.pk1_soa(x, None, DT), (jnp.asarray(F),), (seed,))
        assert _rel(C[:, :, b // 3, b % 3], col) < 1e-10
    C9 = C.reshape(9, 9, -1)
    assert float((C9 - C9.transpose(0, 1)).abs().max()) <= 1e-12 * float(C9.abs().max())


# ---- (b) the sf sweeps with the symmetric storage -------------------------------


@pytest.fixture(scope="module")
def case():
    """8 elements (p=2, 4^3 Gauss points) and element fields made with
    numpy: u at strains of ~5-10%, a and w of unit size."""
    prob = jsh.build_problem(
        MESH, subdivide=1, material=_material(mimi, MATERIALS[0]), dtype=jnp.float64, **BUILD
    )
    E = prob.n_el
    rng = np.random.default_rng(13)
    return {
        "n_el": E,
        "u_el": 0.02 * rng.standard_normal((3, 27, E)),
        "a_el": rng.standard_normal((3, 27, E)),
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


@pytest.fixture(scope="module", params=MATERIALS)
def pallas(request, case):
    """The three sf Pallas sweeps in interpret mode, float32, sym, for one
    material; with the port's material of the same name."""
    ref_mat = _material(mimi, request.param)
    j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    E = case["n_el"]
    tabs = [j(x) for x in case["tabs"]]
    args = (j(case["u_el"]), j(case["a_el"]), None, None, *tabs, j(case["jinv"]), j(case["wq"]))
    kw = dict(
        mat=ref_mat, dt=DT, dim=3, nd=27, n_q=64, n_el=E, rho=RHO, mu_v=0.0,
        has_visc=False, state=None, block_e=E, interpret=True, sf_mode=True, n_g=4, pp1=3,
    )
    y_res = jsw.make_residual_sweep(**kw)(*args)
    y_asm, C = jsw.make_assemble_sweep(**kw, c_storage="sym")(*args)
    y_mv = jsw.make_matvec_sweep_sf(
        dim=3, nd=27, n_q=64, n_el=E, rho=RHO, fac0=FAC0, fac1_mu_v=0.0,
        has_visc=False, block_e=E, interpret=True, c_storage="sym", n_g=4, pp1=3,
    )(j(case["w_el"]), *tabs, j(case["jinv"]), j(case["wq"]), C)
    out = {k: np.asarray(v) for k, v in dict(res=y_res, asm=y_asm, C=C, mv=y_mv).items()}
    out["mat"] = _material(mt, request.param)
    return out


def test_sf_sym_residual_matches_pallas(case, pallas):
    y = tsw.residual_sf_plain(*_sf_args(case, torch.float32), pallas["mat"], DT, RHO)
    assert _rel(y.numpy(), pallas["res"]) < 1e-4


def test_sf_sym_assemble_matches_pallas(case, pallas):
    y, C = tsw.assemble_sf_plain(*_sf_args(case, torch.float32), pallas["mat"], DT, RHO)
    assert C.shape == (45, 64, case["n_el"])
    assert _rel(y.numpy(), pallas["asm"]) < 1e-4
    assert _rel(C.numpy(), pallas["C"]) < 1e-3  # the 45 planes as one group


def test_sf_sym_matvec_matches_pallas(case, pallas):
    _, _, _, tabs, jinv, wq = _sf_args(case, torch.float32)
    w = torch.tensor(case["w_el"], dtype=torch.float32)
    y = tsw.matvec_sf_plain(
        w, tabs, jinv, wq, torch.tensor(pallas["C"]), RHO, FAC0, storage="sym"
    )
    assert _rel(y.numpy(), pallas["mv"]) < 1e-3


@pytest.fixture(scope="module", params=MATERIALS)
def jax_f64(request, case):
    """The same math in JAX float64 on the dense tables: residual, the 45
    symmetric planes of the forward-mode dP/dF, and the matvec as the jvp
    of P; with the port's material of the same name."""
    ref_mat = _material(mimi, request.param)
    j = {k: jnp.asarray(v) for k, v in case.items() if k not in ("n_el", "tabs")}
    dN, N, wq = j["dN_t"], j["N_t"], j["wq"]
    F = jnp.einsum("ndqe,cne->cdqe", dN, j["u_el"]) + jnp.eye(3)[:, :, None, None]

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wq, dN, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wq, N, vec
        )

    P, jvp_fn = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, None, DT), F)
    cols = [jvp_fn(jnp.zeros_like(F).at[b // 3, b % 3].set(1.0)) for b in range(9)]
    planes = [
        cols[a][a // 3, a % 3] if a == b
        else 0.5 * cols[a][b // 3, b % 3] + 0.5 * cols[b][a // 3, a % 3]
        for a in range(9) for b in range(a, 9)
    ]
    dP = FAC0 * jvp_fn(jnp.einsum("ndqe,cne->cdqe", dN, j["w_el"]))
    return {
        "res": np.asarray(integrate(P, RHO * jnp.einsum("nqe,cne->cqe", N, j["a_el"]))),
        "C": np.asarray(jnp.stack(planes)),
        "mv": np.asarray(integrate(dP, RHO * jnp.einsum("nqe,cne->cqe", N, j["w_el"]))),
        "mat": _material(mt, request.param),
    }


def test_sf_sym_residual_matches_jax_f64(case, jax_f64):
    y = tsw.residual_sf_plain(*_sf_args(case, torch.float64), jax_f64["mat"], DT, RHO)
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10


def test_sf_sym_assemble_matches_jax_f64(case, jax_f64):
    mat = jax_f64["mat"]
    args = _sf_args(case, torch.float64)
    y, C = tsw.assemble_sf_plain(*args, mat, DT, RHO)
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10
    assert _rel(C.numpy(), jax_f64["C"]) < 1e-10
    # the planes the CUDA assemble writes from the closed form
    T = mat.tangent_soa(tsoa.add_diag(tsw.sf_grad(args[0], args[3], args[4]), 1.0))
    T = T.reshape(9, 9, 64, -1)
    tri, _ = tsw.tri_index_map(9)
    closed = torch.stack([T[a, b] for (a, b) in sorted(tri, key=tri.get)])
    assert _rel(closed.numpy(), jax_f64["C"]) < 1e-10


def test_sf_sym_matvec_matches_jax_f64(case, jax_f64):
    _, _, _, tabs, jinv, wq = _sf_args(case, torch.float64)
    y = tsw.matvec_sf_plain(
        torch.tensor(case["w_el"]), tabs, jinv, wq, torch.tensor(jax_f64["C"]), RHO, FAC0,
        storage="sym",
    )
    assert _rel(y.numpy(), jax_f64["mv"]) < 1e-10


# ---- (c) the fused neo-Hookean kernels -----------------------------------------


def _reference_residual(u_el, dN_t, wq, lam, mu):
    """The float64 reference of tests/test_pallas.py in jnp (so that its
    jvp is the tangent apply's reference): sigma = mu/J (B - I)
    + lambda (J - 1) I, P = J sigma F^-T, r = sum_q w dN P."""
    F = jnp.eye(3) + jnp.einsum("cne,ndqe->qecd", u_el, dN_t)
    J = jnp.linalg.det(F)
    B = jnp.einsum("qecd,qekd->qeck", F, F)
    eye = jnp.eye(3)
    sig = (mu / J)[..., None, None] * (B - eye) + (lam * (J - 1))[..., None, None] * eye
    P = J[..., None, None] * jnp.einsum(
        "qecd,qedk->qeck", sig, jnp.linalg.inv(F).transpose(0, 1, 3, 2)
    )
    return jnp.einsum("qe,ndqe,qecd->cne", wq, dN_t, P)


def test_fused_plain_matches_f64_reference(case):
    mat = _material(mt, MATERIALS[0])
    u, w = jnp.asarray(case["u_el"]), jnp.asarray(case["w_el"])
    dN, wq = jnp.asarray(case["dN_t"]), jnp.asarray(case["wq"])
    r_ref, y_ref = jax.jvp(
        lambda x: _reference_residual(x, dN, wq, mat.lambda_, mat.mu), (u,), (w,)
    )
    t = lambda k: torch.tensor(case[k])  # noqa: E731
    r = fused.neohookean_residual(t("u_el"), t("dN_t"), t("wq"), mat.lambda_, mat.mu)
    y = fused.neohookean_tangent_apply(
        t("u_el"), t("w_el"), t("dN_t"), t("wq"), mat.lambda_, mat.mu
    )
    assert _rel(r.numpy(), r_ref) < 1e-10
    assert _rel(y.numpy(), y_ref) < 1e-10
    # what the dense sweeps compute with a_el = 0 and with rho = 0, fac0 = 1
    z = torch.zeros_like(t("u_el"))
    args = (t("u_el"), z, None, t("dN_t"), t("N_t"), t("wq"), mat, DT, RHO)
    assert _rel(r.numpy(), tsw.residual_dense_plain(*args).numpy()) < 1e-12
    _, C = tsw.assemble_dense_plain(*args)
    mv = tsw.matvec_dense_plain(t("w_el"), t("dN_t"), t("N_t"), t("wq"), C, 0.0, 1.0)
    assert _rel(y.numpy(), mv.numpy()) < 1e-10


@pytest.mark.parametrize("kernel", ["residual", "tangent_apply"])
def test_fused_plain_matches_pallas(case, kernel):
    """float32 against the TPU kernels in interpret mode, in their
    (dim, nd, n_el, n_q) layout with the element values broadcast over the
    quadrature axis; 1e-5 x scale (both sum 27 x 64 float32 products in
    another order; strains of 5-10% keep the stress's cancellation
    small)."""
    mat = _material(mt, MATERIALS[0])
    E = case["n_el"]
    f32 = lambda k: np.asarray(case[k], np.float32)  # noqa: E731
    dN_p = jnp.asarray(np.transpose(f32("dN_t"), (1, 0, 3, 2)))  # (dim, nd, n_el, n_q)
    w_p = jnp.asarray(f32("wq").T)
    bcast = lambda k: jnp.broadcast_to(jnp.asarray(f32(k))[..., None], (3, 27, E, 64))  # noqa: E731
    t = lambda k: torch.tensor(f32(k))  # noqa: E731
    if kernel == "residual":
        ref = neohookean_residual_pallas(
            bcast("u_el"), dN_p, w_p, mat.lambda_, mat.mu, block_e=8, interpret=True
        )
        got = fused.neohookean_residual(t("u_el"), t("dN_t"), t("wq"), mat.lambda_, mat.mu)
    else:
        ref = neohookean_tangent_apply_pallas(
            bcast("u_el"), bcast("w_el"), dN_p, w_p, mat.lambda_, mat.mu, block_e=8,
            interpret=True,
        )
        got = fused.neohookean_tangent_apply(
            t("u_el"), t("w_el"), t("dN_t"), t("wq"), mat.lambda_, mat.mu
        )
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


# ---- (d) the step ----------------------------------------------------------------


def _ref_np(carry):
    return {k: np.asarray(carry[k]) for k in ("u", "v", "a")}


def _max_rel_err(ref, got):
    return max(
        float(np.abs(got[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
        for k in ("u", "v", "a")
    )


@pytest.mark.parametrize("name", MATERIALS)
def test_three_steps_match_reference(name):
    """Both packages start from the reference's initial carry and take 3
    steps of the 4^3 cube (float64, FDM-GMRES at lin_rel_tol 1e-6); u, v, a
    agree to 1e-8 after every step."""
    kw = dict(BUILD, subdivide=0, refine_spans=4)
    ref = jsh.build_problem(MESH, material=_material(mimi, name), dtype=jnp.float64, **kw)
    port = mt.build_problem(MESH, material=_material(mt, name), device="cpu", **kw)
    assert port.sf is not None and port.state0 is None
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm", lin_rel_tol=1e-6, **STEP
    )
    pstep = mt.make_step(port, lin_rel_tol=1e-6, **STEP)
    for i in range(3):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    assert float(np.abs(carry_to_numpy(pc)["u"]).max()) > 1e-3  # the cube sags


@pytest.fixture(scope="module")
def small():
    return mt.build_problem(
        MESH, material=_material(mt, MATERIALS[0]), device="cpu", subdivide=1, **BUILD
    )


def test_make_step_takes_sf_sym(small):
    assert small.sf is not None
    assert tsw.tangent_storage(small.material) == "sym"
    for option in ({}, {"tangent_storage": "sym"}, {"matvec_impl": "sf"}):
        step = mt.make_step(small, 0.05, **option)
        ns = step.newton_system(mt.initial_carry(small))
        assert torch.isfinite(ns["r"]).all()


@pytest.mark.parametrize(
    "option",
    [{"tangent_storage": "full"}, {"tangent_storage": "cauchy"}, {"matvec_impl": "dense"},
     {"matvec_dtype": "bf16"}],
    ids=["full", "cauchy", "dense_matvec", "bf16"],
)
def test_unported_sf_sym_options_raise(small, option):
    if option == {"matvec_dtype": "bf16"}:
        # ported since the bfloat16 symmetric block: the step takes it, and
        # its J w differs from the float32 block's by the block's rounding
        carry = mt.initial_carry(small)
        ns = [mt.make_step(small, 0.05, matvec_dtype=d).newton_system(carry) for d in ("bf16", "f32")]
        w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(0),
                        dtype=ns[0]["r"].dtype)
        jw = [n["J_apply"](w) for n in ns]
        err = float((jw[0] - jw[1]).abs().max())
        assert torch.equal(ns[0]["r"], ns[1]["r"])
        assert 0.0 < err <= 2.0**-7 * float(jw[1].abs().max())
        return
    if option == {"tangent_storage": "cauchy"}:
        # the hyperelastic sigma is no function of sym(F) alone: a wrong
        # request, as in the reference
        with pytest.raises(ValueError, match="Cauchy-decomposition"):
            mt.make_step(small, 0.05, **option)
        return
    if option == {"tangent_storage": "full"}:
        # ported: the 81 planes of the closed-form dP/dF; the Newton system
        # is the symmetric block's to rounding (dP/dF is major-symmetric)
        carry = mt.initial_carry(small)
        ns = [mt.make_step(small, 0.05, tangent_storage=s).newton_system(carry)
              for s in ("full", "sym")]
        w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(1),
                        dtype=ns[0]["r"].dtype)
        jw = [n["J_apply"](w) for n in ns]
        assert torch.equal(ns[0]["r"], ns[1]["r"])
        assert float((jw[0] - jw[1]).abs().max()) <= 1e-12 * float(jw[1].abs().max())
        return
    # ported: matvec_impl="dense" runs the dense sweeps on the patch's dense
    # tables; the Newton system is the sf one's to rounding
    assert option == {"matvec_impl": "dense"}
    carry = mt.initial_carry(small)
    ns = [mt.make_step(small, 0.05, matvec_impl=impl).newton_system(carry)
          for impl in ("dense", "sf")]
    w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(2),
                    dtype=ns[0]["r"].dtype)
    jw = [n["J_apply"](w) for n in ns]
    assert float((ns[0]["r"] - ns[1]["r"]).abs().max()) <= 1e-12 * float(ns[1]["r"].abs().max())
    assert float((jw[0] - jw[1]).abs().max()) <= 1e-10 * float(jw[1].abs().max())


def test_full_storage_material_raises(small):
    """A material that declares neither compression resolves to the
    81-plane storage, which the port runs for J2Simo and J2Log only."""
    prob = dataclasses.replace(small, material=mt.Material())
    assert tsw.tangent_storage(prob.material) == "full"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        mt.make_step(prob, 0.05)


def test_launch_counters_name_every_variant():
    named = tsw.shape_counters("sf", (3, 4)) + tsw.shape_counters("dense", (3, 27, 64))
    for name in ("residual_sf[nh]", "assemble_sf[nh,sym]", "residual_sf[stvk]",
                 "assemble_sf[stvk,sym]", "matvec_sf[sym]", "residual_dense[stvk]",
                 "assemble_dense[stvk,sym]", "neohookean_residual",
                 "neohookean_tangent_apply"):
        assert name in named
    assert "residual_dense" in named and "assemble_dense[sym]" in named


@pytest.mark.parametrize(
    "storage, error",
    [("cauchy", ValueError), ("full", ValueError), ("packed", ValueError)],
)
def test_matvec_storage_must_match_the_block(case, storage, error):
    """The matvec applies the block in the storage it is told, and refuses
    a block of another plane count rather than guessing from its shape."""
    _, _, _, tabs, jinv, wq = _sf_args(case, torch.float64)
    w = torch.tensor(case["w_el"])
    Cs = torch.zeros((45, *wq.shape), dtype=torch.float64)
    with pytest.raises(error):
        tsw.matvec_sf_plain(w, tabs, jinv, wq, Cs, RHO, FAC0, storage=storage)
