"""Mortar contact on dense tables and the frozen contact tangent of the
port (mimi_tpu_torch) against the reference package, float64 on the CPU,
on numpy-seeded inputs.

The press is the viscous neo-Hookean two-patch press of
examples/multipatch_contact.py and tests/test_multipatch.py:381-414 cut
to 2 x 4^2 elements: two-patch-square.mesh elevated to p=2, the bottom
edge (bid 2) clamped, the top edge (bid 3, spanning both patches) in
mortar penalty contact with a flat Bezier tool pushed down 0.005 per
step, density 1e3, viscosity 100, E 1e6, nu 0.3, penalty 5e7, dt 0.01,
rho_inf 0.5, the reference's default frozen contact tangent, the
two-patch additive-Schwarz FDM with the contact spring.  The tool starts
touching the top edge, so every step is engaged.

  - the contact tables of a multi-patch boundary, the pressure pass and
    the frozen-pressure element blocks (`residual_grad_pass`, 2D and 3D)
    at 1e-10 of scale;
  - the multi-patch FDM with the contact spring on the edge that spans
    both patches at 1e-12;
  - the viscous dense sweeps (sym and cauchy, 2D and 3D) against the
    reference's jitted SoA residual, its jvp and its viscous blocks at
    1e-10;
  - 3 engaged steps of the press against the reference's `soa` step at
    1e-8 of each field's scale, with equal Newton counts, and the 2D
    closest-point query at those states at 1e-10;
  - a converted reference problem with contact on dense tables.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu import splines as jspl
from mimi_tpu.contact.mortar import make_contact_fns as jmake_contact_fns
from mimi_tpu.parallel import sharding as jsh
from mimi_tpu.solvers.fdm import make_fdm_apply_multipatch as ref_fdm_apply_mp

import mimi_tpu_torch as mt
from mimi_tpu_torch import splines as tspl
from mimi_tpu_torch.contact.mortar import make_contact_fns as tmake_contact_fns
from mimi_tpu_torch.contact.mortar import residual_grad_pass
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.parallel import sharding as tsh
from mimi_tpu_torch.solvers.fdm import make_fdm_apply
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, problem_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
TWO_SQUARE = os.path.join(DATA, "two-patch-square.mesh")
TWO_CUBE = os.path.join(DATA, "two-patch-cube.mesh")
CUBE = os.path.join(DATA, "cube-nurbs.mesh")
KAPPA = 5e7
BUILD = dict(dirichlet=[(2, 0), (2, 1)], body_force={}, rho_inf=0.5)
STEP = dict(dt=0.01, newton_iters=12, solver="cg", cg_iters=80, precond="fdm",
            rel_tol=1e-8, lin_rel_tol=1e-8)
PUSH = [0.0, -0.005]


def _material(pkg):
    mat = pkg.CompressibleOgdenNeoHookean()
    mat.density = 1e3
    mat.viscosity = 100.0
    mat.set_young_poisson(1e6, 0.3)
    return mat


def _tool(pkg, spl, y=1.0):
    """The flat tool of the example, its lower face at height y."""
    sc = pkg.NearestDistanceToSplines()
    sc.add_spline(spl.Bezier([1], [[-0.5, y], [2.5, y]]))
    sc.plant_kd_tree(200, 1)
    sc.coefficient = KAPPA
    return sc


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


@pytest.fixture(scope="module")
def press():
    """Reference and port problems of the 2 x 4^2 press (tool touching the
    top edge) and the reference scene."""
    jscene = _tool(mimi, jspl)
    ref = jsh.build_problem(TWO_SQUARE, 1, 2, _material(mimi), dtype=jnp.float64,
                            contact=[(3, jscene)], **BUILD)
    port = mt.build_problem(TWO_SQUARE, 1, 2, _material(mt), dtype=torch.float64,
                            device="cpu", contact=[(3, _tool(mt, tspl))], **BUILD)
    return ref, port, jscene


def test_dense_contact_tables_match_reference(press):
    ref, port, _ = press
    assert port.dense is not None and port.sf is None and "mp" in port.fdm
    assert (port.n_el, port.dim) == (32, 2)
    cd_r, cd_p = ref.contact[0], port.contact[0]
    assert cd_p["conn"].shape == (8, 3)  # 4 edge elements per patch, p = 2
    for k in ("conn", "ldof", "N", "dN", "wq", "nsign", "x_ref_el"):
        np.testing.assert_allclose(cd_p[k].numpy(), np.asarray(cd_r[k]), rtol=0, atol=1e-14,
                                   err_msg=k)
    # 2 x (4 + 2) edge dofs, one shared at x = 1
    assert port.contact_static[0]["n_local"] == ref.contact_static[0]["n_local"] == 11


def _problems(case):
    if case == "2d":
        jscene = _tool(mimi, jspl)
        ref = jsh.build_problem(TWO_SQUARE, 1, 2, _material(mimi), dtype=jnp.float64,
                                contact=[(3, jscene)], **BUILD)
        port = mt.build_problem(TWO_SQUARE, 1, 2, _material(mt), dtype=torch.float64,
                                device="cpu", contact=[(3, _tool(mt, tspl))], **BUILD)
        return ref, port
    scenes = []
    for pkg, spl in ((mimi, jspl), (mt, tspl)):
        sc = pkg.NearestDistanceToSplines()
        sc.add_spline(spl.Bezier([1, 1], [[-0.5, -0.5, 1.0], [-0.5, 1.5, 1.0],
                                          [1.5, -0.5, 1.0], [1.5, 1.5, 1.0]]))
        sc.plant_kd_tree(8, 1)
        sc.coefficient = KAPPA
        scenes.append(sc)
    kw = dict(dirichlet=[(0, 0), (0, 1), (0, 2)], body_force={}, rho_inf=0.5, refine_spans=4)
    ref = jsh.build_problem(CUBE, 1, 0, _material(mimi), dtype=jnp.float64,
                            contact=[(1, scenes[0])], **kw)
    port = mt.build_problem(CUBE, 1, 0, _material(mt), dtype=torch.float64, device="cpu",
                            contact=[(1, scenes[1])], **kw)
    return ref, port


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_pressure_pass_and_frozen_blocks_match_reference(case):
    """At a displacement that pushes the contact face 0.01-0.02 into the
    tool with a random wobble: the nodal pressure, the traction residual,
    force and integrated pressure, and the (n_mb, nd dim, nd dim)
    frozen-pressure element blocks (the reference's `jax.jacfwd` of its
    element residual) at 1e-10 of scale."""
    ref, port = _problems(case)
    dim = port.dim
    rng = np.random.default_rng(8)
    u = 0.002 * rng.standard_normal((ref.n_dof, dim))
    u[:, dim - 1] += 0.015
    cd_r, cs_r = ref.contact[0], ref.contact_static[0]
    pp, _, rgp = jmake_contact_fns(dim, cs_r["n_local"], cs_r["query"])
    p_r, area_r, _ = jax.jit(lambda x: pp(x, cd_r, cd_r["scene"], cd_r["penalty"]))(
        jnp.asarray(u))
    res_r, B_r, force_r, pint_r = jax.jit(lambda x, p: rgp(x, cd_r, p))(jnp.asarray(u), p_r)
    cd, cs = port.contact[0], port.contact_static[0]
    tpp, trp, _ = tmake_contact_fns(dim, cs["n_local"], cs["query"])
    ut = torch.tensor(u)
    p_t, area_t, qd = tpp(ut, cd, cd["scene"], cd["penalty"])
    res_t, B_t, force_t, pint_t = residual_grad_pass(ut, cd, p_t)
    assert int(qd["n_engaged"]) > 0
    assert _rel(p_t.numpy(), p_r) < 1e-10
    np.testing.assert_allclose(float(area_t), float(area_r), rtol=1e-10)
    assert _rel(res_t.numpy(), res_r) < 1e-10
    assert _rel(force_t.numpy(), force_r) < 1e-10
    np.testing.assert_allclose(float(pint_t), float(pint_r), rtol=1e-10)
    n_mb, nd = cd["conn"].shape
    assert B_t.shape == (n_mb, nd * dim, nd * dim)
    assert _rel(B_t.numpy(), B_r) < 1e-10
    # the residual pass of the blocks is the residual pass
    assert torch.equal(res_t, trp(ut, cd, p_t)[0])


def test_multipatch_fdm_contact_spring_matches_reference(press):
    """The two-patch additive-Schwarz FDM with the penalty spring folded
    into the patch that owns each part of the top edge (bid 3 spans both
    patches): the apply against the reference's at 1e-12; the spring
    changes it."""
    ref, port, _ = press
    assert "mp" in port.fdm and len(port.fdm["mp"]) == 2
    v = np.random.default_rng(9).standard_normal(port.n_dof * 2)
    fac0, fac1 = 2.5e-5, 0.0075
    y_ref = ref_fdm_apply_mp(ref.fdm, fac0, fac1, jnp.float64)(jnp.asarray(v))
    y = make_fdm_apply(port.fdm, fac0, fac1, torch.float64, "cpu")(torch.tensor(v))
    assert _rel(y.numpy(), y_ref) < 1e-12
    plain = mt.build_problem(TWO_SQUARE, 1, 2, _material(mt), dtype=torch.float64,
                             device="cpu", **BUILD)
    y0 = make_fdm_apply(plain.fdm, fac0, fac1, torch.float64, "cpu")(torch.tensor(v))
    assert _rel(y0.numpy(), y_ref) > 1e-3


# ---------------------------------------------------------------------------
# the viscous dense sweeps
# ---------------------------------------------------------------------------


VISC_CASES = {
    "2d_p2_sym": (TWO_SQUARE, 1, 1, None, "CompressibleOgdenNeoHookean", [(2, 0), (2, 1)]),
    "2d_p3_cauchy": (TWO_SQUARE, 2, 1, None, "J2", [(2, 0), (2, 1)]),
    "3d_p2_sym": (TWO_CUBE, 1, 0, 2, "StVenantKirchhoff", [(0, 0), (0, 1), (0, 2)]),
    "3d_p2_cauchy": (TWO_CUBE, 1, 0, 2, "J2", [(0, 0), (0, 1), (0, 2)]),
}
MU_V, FAC1 = 100.0, 0.3


def _visc_material(pkg, name):
    mat = getattr(pkg, name)()
    mat.density = 1.0
    mat.viscosity = MU_V
    mat.set_young_poisson(2100.0, 0.3)
    if name == "J2":
        mat.melting_temperature = 1500.0
        mat.initial_temperature = 20.0
        mat.specific_heat = 450.0
        mat.heat_fraction = 0.9
        h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
        h.A, h.B, h.n, h.m = 70.0, 140.0, 0.2835, 1.3558
        h.eps0_dot = 0.004
        h.reference_temperature = 20.0
        mat.hardening = h
    return mat


@pytest.mark.parametrize("key", list(VISC_CASES))
def test_viscous_dense_sweeps_match_reference(key):
    """The plain viscous dense residual (its assemble's residual too) at u
    with the velocity field v: the reference's jitted SoA residual E(u)
    (`_soa_E_residual`) plus its viscous blocks (mu_v int dN . dN) applied
    to v; the viscous matvec at fac0 = 1, rho = 0: its jvp along w plus
    fac1 times the viscous blocks applied to w; both at 1e-10.  J2 with a
    plastic history; the viscous term is a real part of each."""
    mesh, elev, subd, spans, name, clamp = VISC_CASES[key]
    kw = dict(refine_spans=spans) if spans else {}
    ref = jsh.build_problem(mesh, elev, subd, _visc_material(mimi, name), clamp, {},
                            rho_inf=0.5, dtype=jnp.float64, **kw)
    port = mt.build_problem(mesh, elev, subd, _visc_material(mt, name), clamp, {},
                            rho_inf=0.5, device="cpu", **kw)
    assert ref.visc_blocks is not None and port.dense is not None
    dim, E, nq, n_dof = port.dim, port.n_el, port.n_q, port.n_dof
    rng = np.random.default_rng(12)
    u = 0.02 * rng.standard_normal((n_dof, dim))
    v = 10.0 * rng.standard_normal((n_dof, dim))
    w = rng.standard_normal((n_dof, dim))
    st = None
    if name == "J2":
        ps = 0.005 * rng.standard_normal((dim, dim, nq, E))
        st = {"plastic_strain": 0.5 * (ps + ps.transpose(1, 0, 2, 3)),
              "eqps": 0.02 * rng.random((nq, E)),
              "temperature": 20.0 + 100.0 * rng.random((nq, E))}
    dN_r = jnp.transpose(ref.dN_dX, (2, 3, 1, 0))
    st_r = None if st is None else {k: jnp.asarray(x) for k, x in st.items()}
    conn, vb = jnp.asarray(ref.conn), jnp.asarray(ref.visc_blocks)

    def E_res(x):
        return jsh._soa_E_residual(ref.material, 0.5, dim, n_dof, ref.conn, dN_r,
                                   ref.w_detJ.T, x, st_r)

    def visc(x):
        return jnp.zeros((n_dof, dim), x.dtype).at[conn].add(
            jnp.einsum("enm,emc->enc", vb, x[conn]))

    y_r, jw_r = jax.jit(lambda x, t: jax.jvp(E_res, (x,), (t,)))(jnp.asarray(u), jnp.asarray(w))
    y_ref = np.asarray(y_r + visc(jnp.asarray(v)))
    jw_ref = np.asarray(jw_r + FAC1 * visc(jnp.asarray(w)))

    g, scatter = tsh._gather_scatter(port)
    st_t = None if st is None else {k: torch.tensor(x) for k, x in st.items()}
    dN, N, wq, mat = port.dense["dN_t"], port.dense["N_t"], port.wdet_t, port.material
    u_el, v_el = g(torch.tensor(u)), g(torch.tensor(v))
    args = (u_el, torch.zeros_like(u_el), st_t, dN, N, wq, mat, 0.5, 1.0)
    y = tsw.residual_dense_plain(*args, v_el=v_el, mu_v=MU_V)
    ya, C = tsw.assemble_dense_plain(*args, v_el=v_el, mu_v=MU_V)
    assert torch.equal(y, ya)
    assert _rel(scatter(y).numpy(), y_ref) < 1e-10
    assert _rel(scatter(tsw.residual_dense_plain(*args)).numpy(), y_ref) > 1e-2
    storage = tsw.tangent_storage(mat)
    assert storage == key.rsplit("_", 1)[1]
    mv_args = (g(torch.tensor(w)), dN, N, wq, C, 0.0, 1.0)
    jw = tsw.matvec_dense_plain(*mv_args, FAC1 * MU_V, storage=storage)
    assert _rel(scatter(jw).numpy(), jw_ref) < 1e-10
    assert _rel(scatter(tsw.matvec_dense_plain(*mv_args, storage=storage)).numpy(), jw_ref) > 1e-2


# ---------------------------------------------------------------------------
# the press
# ---------------------------------------------------------------------------


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = None
    out["contact"] = [{k: np.asarray(x) for k, x in b.items()} for b in carry["contact"]]
    return out


OBSERVABLES = ("force", "area", "pressure", "nodal_pressure", "res_el")


def _max_rel_err(ref, got):
    """max over u, v, a and the contact observables of max|got - ref| /
    max|ref|."""
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["contact"][0][k], got["contact"][0][k]) for k in OBSERVABLES]
    return max(
        float(np.abs(np.asarray(b) - np.asarray(a)).max())
        / max(float(np.abs(np.asarray(a)).max()), 1e-300)
        for a, b in pairs
    )


@pytest.fixture(scope="module")
def ref_steps(press):
    """Three reference steps of the press (soa engine, the default frozen
    contact tangent) from its initial carry, the tool pushed before each."""
    ref, _, _ = press
    step = jsh.make_step(ref, residual_impl="soa", **STEP)
    carry = jsh.initial_carry(ref)
    sd = ref.contact[0]["scene"]
    out = [_ref_np(carry)]
    for _ in range(3):
        sd = mimi.NearestDistanceToSplines.translate_scene_data(sd, jnp.asarray(PUSH))
        carry = step(carry, contact_scenes=[sd])
        out.append(dict(_ref_np(carry), newton={k: np.asarray(x) for k, x in
                                                carry["newton"].items()}))
    return out


def test_three_engaged_press_steps_match_reference(press, ref_steps):
    """The port's plain path with default arguments (the frozen contact
    tangent) from the reference's initial carry: u, v, a and the contact
    observables agree to 1e-8 of each field's scale after every step, with
    equal Newton counts (GMRES counts may differ by one: its stopping test
    at 1e-8 meets rounding).  The frozen tangent converges linearly
    on engaged contact, so both stop at the 12-iteration cap at the same
    iterate (a drop of ~1e-2, as tests/test_multipatch.py:424-427 says of
    the reference)."""
    _, port, _ = press
    step = mt.make_step(port, **STEP)
    carry = carry_from_numpy(ref_steps[0], device="cpu")
    sd = port.contact[0]["scene"]
    for i in range(1, 4):
        sd = mt.NearestDistanceToSplines.translate_scene_data(sd, PUSH)
        carry = step(carry, contact_scenes=[sd])
        ref = ref_steps[i]
        assert carry["newton"]["finite"]
        assert carry["newton"]["iters"] == int(ref["newton"]["iters"]), i
        assert carry["newton"]["norm"] < 0.05 * carry["newton"]["norm0"]
        assert int(carry["contact"][0]["n_engaged"]) > 0
        # the force presses the body down (the sign tests/test_contact.py:186
        # asserts of the reference's 3D press)
        assert float(carry["contact"][0]["force"][1]) < 0.0
        err = _max_rel_err(ref, carry_to_numpy(carry))
        assert err <= 1e-8, (i, err)
    assert float(carry["u"][:, 1].min()) < -0.01


def test_frozen_and_consistent_tangents_differ_on_engaged_contact(press, ref_steps):
    """The first step's first Newton system (the tool 0.005 into the top
    edge) with either contact tangent: the residual is the same, J w
    differs by the pressure's derivative.  (At the later steps' predictors
    the body has moved below the tool, so their first systems are not
    engaged.)"""
    _, port, _ = press
    carry = carry_from_numpy(ref_steps[0], device="cpu")
    sd = mt.NearestDistanceToSplines.translate_scene_data(port.contact[0]["scene"], PUSH)
    ns = [mt.make_step(port, contact_tangent=t, **{k: x for k, x in STEP.items()})
          .newton_system(carry, contact_scenes=[sd]) for t in ("frozen", "consistent")]
    w = torch.tensor(np.random.default_rng(10).standard_normal(ns[0]["r"].shape))
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    assert _rel(ns[0]["J_apply"](w).numpy(), ns[1]["J_apply"](w).numpy()) > 1e-3


def test_2d_query_matches_reference_at_the_press_states(press, ref_steps):
    """The closest-point query against the para_dim-1 tool at the top
    edge's quadrature points of each reference press state (the tool where
    that step left it; at a step's end the edge may lie below the tool,
    so the same points lifted 0.01 into it too): foot point, normal,
    distance and gap at 1e-10, the same convergence flags."""
    ref, port, jscene = press
    cd_r = ref.contact[0]
    query_r = ref.contact_static[0]["query"]
    query_p = port.contact_static[0]["query"]
    sd_r, sd_p = cd_r["scene"], port.contact[0]["scene"]
    N, conn, x_ref = np.asarray(cd_r["N"]), np.asarray(cd_r["conn"]), np.asarray(cd_r["x_ref_el"])
    for i in range(1, 4):
        sd_r = mimi.NearestDistanceToSplines.translate_scene_data(sd_r, jnp.asarray(PUSH))
        sd_p = mt.NearestDistanceToSplines.translate_scene_data(sd_p, PUSH)
        cur = ref_steps[i]["u"][conn] + x_ref
        q = np.einsum("eqn,end->eqd", N, cur).reshape(-1, 2)
        # the edge at the step's end, and lifted 0.01 into the tool
        for lift in (0.0, 0.01):
            ql = q + np.array([0.0, lift])
            want = query_r(jnp.asarray(ql), sd_r)
            got = query_p(torch.tensor(ql), sd_p)
            for k in ("parametric", "physical", "normal", "distance", "normal_gap"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                           atol=1e-10, err_msg=k)
            np.testing.assert_array_equal(got["converged"].numpy(),
                                          np.asarray(want["converged"]))
        # the mortar pass's gap -(n . (foot - q)) of the lifted points: penetrating
        true_g = -np.sum(np.asarray(want["normal"]) * (np.asarray(want["physical"]) - ql), 1)
        assert float(true_g.max()) < 0.0


def test_converted_dense_contact_problem_steps_as_the_port_build(press, ref_steps):
    """problem_from_numpy of the reference's dense contact problem drives
    the same step as the port's own build_problem."""
    ref, port, jscene = press
    conv = problem_from_numpy(ref, scenes=[jscene], device="cpu")
    assert conv.dense is not None and conv.contact and "mp" in conv.fdm
    carries = []
    for prob in (port, conv):
        sd = mt.NearestDistanceToSplines.translate_scene_data(prob.contact[0]["scene"], PUSH)
        carry = mt.make_step(prob, **STEP)(carry_from_numpy(ref_steps[0], device="cpu"),
                                           contact_scenes=[sd])
        carries.append(carry_to_numpy(carry))
    assert _max_rel_err(carries[0], carries[1]) <= 1e-10
