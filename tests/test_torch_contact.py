"""The port's contact path (mimi_tpu_torch splines, closest-point scene,
mortar passes, FDM springs and the contact press step) against the
reference package, float64 on the CPU, on numpy-seeded inputs.

The press is the reference benchmark's contact configuration
(bench.py:361-504) cut to 4^3 elements: cube-nurbs.mesh at p=2, clamped
bottom face, mortar penalty contact of the top face against a rigid
bilinear Bezier tool, J2 Johnson-Cook with viscosity, consistent contact
tangent, FDM-preconditioned GMRES.  The tool starts touching the top face
and moves down 0.004 per step instead of the benchmark's 0.01: at 4^3
elements a 0.03 indentation by the third step leaves both packages'
Newton unconverged after 12 iterations (residual drop 0.15), and an
unconverged iterate is no parity check."""

import dataclasses
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

import mimi_tpu_torch as mt
from mimi_tpu_torch import splines as tspl
from mimi_tpu_torch.contact.mortar import make_contact_fns as tmake_contact_fns
from mimi_tpu_torch.fem.space import FESpace
from mimi_tpu_torch.nurbs.mesh_io import read_mfem_nurbs_mesh
from mimi_tpu_torch.nurbs.topology import build_patch_from_mesh
from mimi_tpu_torch.solvers import fdm as tfdm
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    problem_from_numpy,
    scene_from_reference,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

MESH = os.path.join(os.path.dirname(__file__), "data", "cube-nurbs.mesh")
KAPPA = 5e7
BUILD = dict(
    elevate=1,
    subdivide=0,
    dirichlet=[(0, 0), (0, 1), (0, 2)],
    body_force={},
    rho_inf=0.5,
    refine_spans=4,
)
STEP = dict(dt=0.01, newton_iters=12, solver="cg", cg_iters=80,
            precond="fdm", contact_tangent="consistent", rel_tol=1e-8,
            lin_rel_tol=1e-8)
PUSH = [0.0, 0.0, -0.004]


# ---------------------------------------------------------------------------
# splines
# ---------------------------------------------------------------------------


def _spline_cases(pkg):
    """The bilinear Bezier tool, a curved p=2 BSpline surface with an
    interior knot, and a rational quarter-circle NURBS arc."""
    tool = pkg.Bezier([1, 1], [[-0.5, -0.5, 1.02], [-0.5, 1.5, 1.02],
                               [1.5, -0.5, 1.02], [1.5, 1.5, 1.02]])
    kv = [0, 0, 0, 0.5, 1, 1, 1]
    X, Y = np.meshgrid(np.linspace(0, 2, 4), np.linspace(0, 2, 4), indexing="ij")
    Z = 0.3 * np.sin(2 * X) + 0.2 * Y
    cps = np.stack([a.reshape(-1, order="F") for a in (X, Y, Z)], -1)
    surface = pkg.BSpline([2, 2], cps, [kv, kv])
    arc = pkg.NURBS(
        [2], [[1, 0], [1, 1], [0, 1], [-1, 1], [-1, 0]],
        [[0, 0, 0, 0.5, 0.5, 1, 1, 1]],
        [1, np.sqrt(0.5), 1, np.sqrt(0.5), 1],
    )
    return {"tool": tool, "surface": surface, "arc": arc}


@pytest.mark.parametrize("name", ["tool", "surface", "arc"])
def test_eval_planes_and_derivatives_match_jax_jvp(name):
    js, ts = _spline_cases(jspl)[name], _spline_cases(tspl)[name]
    lo, hi = js.parametric_bounds()
    rng = np.random.default_rng(3)
    u = lo[:, None] + (hi - lo)[:, None] * rng.random((js.para_dim, 300))
    u[:, :3] = np.stack([lo, hi, 0.5 * (lo + hi)], -1)  # ends and a knot
    cps_j = js.eval_cps().T
    f = lambda uu: js.make_eval_planes()(uu, cps_j)  # noqa: E731
    uj = jnp.asarray(u)
    seeds = [jnp.zeros_like(uj).at[k].set(1.0) for k in range(js.para_dim)]
    d1_ref = [jax.jvp(f, (uj,), (s,))[1] for s in seeds]
    d2_ref = [
        [jax.jvp(lambda x, s=s: jax.jvp(f, (x,), (s,))[1], (uj,), (t,))[1] for t in seeds]
        for s in seeds
    ]
    ut, cps_t = torch.tensor(u), ts.eval_cps(device="cpu").T
    val = ts.make_eval_planes()(ut, cps_t)
    S, d1, d2 = ts.make_eval_planes_ders()(ut, cps_t)
    np.testing.assert_allclose(val.numpy(), np.asarray(f(uj)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(S.numpy(), np.asarray(f(uj)), rtol=0, atol=1e-12)
    for k in range(js.para_dim):
        np.testing.assert_allclose(d1[k].numpy(), np.asarray(d1_ref[k]), rtol=0, atol=1e-12)
        for m in range(js.para_dim):
            np.testing.assert_allclose(
                d2[k][m].numpy(), np.asarray(d2_ref[k][m]), rtol=0, atol=1e-12
            )


# ---------------------------------------------------------------------------
# closest-point projection
# ---------------------------------------------------------------------------


def _scenes(name):
    """(reference scene, port scene, ~500 query points) above, below and
    beyond the edges of the spline."""
    rng = np.random.default_rng(4)
    if name == "tool":
        res = 8
        q = np.stack([rng.uniform(-1.0, 2.0, 500), rng.uniform(-1.0, 2.0, 500),
                      rng.uniform(0.9, 1.15, 500)], -1)
    else:
        res = 41
        q = np.stack([rng.uniform(-0.2, 2.2, 500), rng.uniform(-0.2, 2.2, 500),
                      rng.uniform(-0.6, 1.2, 500)], -1)
    out = []
    for pkg, spl in ((mimi, jspl), (mt, tspl)):
        sc = pkg.NearestDistanceToSplines()
        sc.add_spline(_spline_cases(spl)[name])
        sc.plant_kd_tree(res, 1)
        out.append(sc)
    return out[0], out[1], q


@pytest.mark.parametrize("name", ["tool", "surface"])
def test_batched_query_matches_reference(name):
    jsc, tsc, q = _scenes(name)
    ref = jsc.make_batched_query()(jnp.asarray(q), jsc.scene_data())
    sd = tsc.scene_data(device="cpu")
    np.testing.assert_allclose(
        sd[0]["sample_pts"].numpy(), np.asarray(jsc.scene_data()[0]["sample_pts"]),
        rtol=0, atol=1e-14,
    )
    got = tsc.make_batched_query()(torch.tensor(q), sd)
    # On the curved surface the damped Newton's acceptance test
    # f(u_try) <= f(u) compares objective values that differ below
    # rounding near the minimum, so the two packages may stop up to ~1e-8
    # apart in the foot point (9e-9 on 12 of these 500 points); the
    # distance is stationary there and agrees to rounding.  On the tool
    # (a plane) everything agrees at 1e-10.
    foot_tol = 1e-10 if name == "tool" else 1e-7
    for k, tol in (("parametric", foot_tol), ("physical", foot_tol), ("normal", foot_tol),
                   ("distance", 1e-10), ("normal_gap", 1e-10)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_array_equal(got["converged"].numpy(), np.asarray(ref["converged"]))


def test_multi_spline_query_takes_the_nearest():
    """Two tool planes (z = 1.02 and z = 0.9): every point takes the
    nearer one, as the reference's batched query does."""
    scenes = []
    for pkg, spl in ((mimi, jspl), (mt, tspl)):
        sc = pkg.NearestDistanceToSplines()
        for z in (1.02, 0.9):
            sc.add_spline(spl.Bezier([1, 1], [[-0.5, -0.5, z], [-0.5, 1.5, z],
                                              [1.5, -0.5, z], [1.5, 1.5, z]]))
        sc.plant_kd_tree(8, 1)
        scenes.append(sc)
    q = np.random.default_rng(5).uniform([-0.2, -0.2, 0.85], [1.2, 1.2, 1.1], (200, 3))
    ref = scenes[0].make_batched_query()(jnp.asarray(q), scenes[0].scene_data())
    got = scenes[1].make_batched_query()(torch.tensor(q), scenes[1].scene_data(device="cpu"))
    for k in ("physical", "normal_gap", "distance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-10)


def test_translate_scene_data_matches_reference():
    for name in ("tool", "arc"):
        sc_j = mimi.NearestDistanceToSplines()
        sc_j.add_spline(_spline_cases(jspl)[name])
        sc_j.plant_kd_tree(9, 1)
        sc_t = scene_from_reference(sc_j)
        delta = [0.1, -0.2, 0.3][: sc_j.splines[0].dim]
        ref = mimi.NearestDistanceToSplines.translate_scene_data(sc_j.scene_data(), jnp.asarray(delta))
        got = mt.NearestDistanceToSplines.translate_scene_data(sc_t.scene_data(device="cpu"), delta)
        for k in ("cps", "samples", "sample_pts"):
            np.testing.assert_allclose(got[0][k].numpy(), np.asarray(ref[0][k]), rtol=0,
                                       atol=1e-14)


# ---------------------------------------------------------------------------
# the press: problems, mortar passes, FDM springs, steps
# ---------------------------------------------------------------------------


def _material(pkg):
    mat = pkg.J2()
    mat.density = 1e3
    mat.viscosity = 100.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(1e6, 0.3)
    h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 700.0, 1400.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


def _tool_scene(pkg, spl, z=1.0):
    sc = pkg.NearestDistanceToSplines()
    sc.add_spline(spl.Bezier([1, 1], [[-0.5, -0.5, z], [-0.5, 1.5, z],
                                      [1.5, -0.5, z], [1.5, 1.5, z]]))
    sc.plant_kd_tree(8, 1)
    sc.coefficient = KAPPA
    return sc


@pytest.fixture(scope="module")
def press():
    """Reference and port problems of the press (tool touching the top
    face), and the reference's contact functions."""
    jscene, tscene = _tool_scene(mimi, jspl), _tool_scene(mt, tspl)
    ref = jsh.build_problem(MESH, material=_material(mimi), dtype=jnp.float64,
                            contact=[(1, jscene)], **BUILD)
    port = mt.build_problem(MESH, material=_material(mt), dtype=torch.float64,
                            device="cpu", contact=[(1, tscene)], **BUILD)
    return ref, port, jscene


def test_contact_tables_match_reference(press):
    ref, port, _ = press
    cd_r, cd_p = ref.contact[0], port.contact[0]
    for k in ("conn", "ldof", "N", "dN", "wq", "nsign", "x_ref_el"):
        np.testing.assert_allclose(cd_p[k].numpy(), np.asarray(cd_r[k]), rtol=0, atol=1e-14,
                                   err_msg=k)
    assert port.contact_static[0]["n_local"] == ref.contact_static[0]["n_local"]


def _penetrating_u(n_dof):
    """A displacement that lifts the top face 0.01-0.02 into the tool
    (tool at z = 1), with random in-plane and normal wobble."""
    rng = np.random.default_rng(6)
    u = 0.002 * rng.standard_normal((n_dof, 3))
    u[:, 2] += 0.015
    return u


def _ref_contact_residual(ref):
    cd, cs = ref.contact[0], ref.contact_static[0]
    pp, rp, _ = jmake_contact_fns(3, cs["n_local"], cs["query"])

    def residual(u):
        pressure, _, _ = pp(u, cd, cd["scene"], cd["penalty"])
        res_el, _, _ = rp(u, cd, pressure)
        return jnp.zeros((ref.n_dof, 3), u.dtype).at[cd["conn"]].add(res_el)

    return pp, rp, residual


def test_pressure_and_residual_passes_match_reference(press):
    ref, port, _ = press
    u = _penetrating_u(ref.n_dof)
    pp, rp, _ = _ref_contact_residual(ref)
    cd = ref.contact[0]
    p_r, area_r, _ = jax.jit(lambda x: pp(x, cd, cd["scene"], cd["penalty"]))(jnp.asarray(u))
    res_r, force_r, pint_r = jax.jit(lambda x, p: rp(x, cd, p))(jnp.asarray(u), p_r)
    tcd, cs = port.contact[0], port.contact_static[0]
    tpp, trp, tlin = tmake_contact_fns(3, cs["n_local"], cs["query"])
    ut = torch.tensor(u)
    p_t, area_t, qd = tpp(ut, tcd, tcd["scene"], tcd["penalty"])
    res_t, force_t, pint_t = trp(ut, tcd, p_t)
    assert int(qd["n_engaged"]) > 0 and float(np.abs(np.asarray(p_r)).max()) > 0
    scale = float(np.abs(np.asarray(p_r)).max())
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_r), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(float(area_t), float(area_r), rtol=1e-10)
    fscale = float(np.abs(np.asarray(force_r)).max())
    np.testing.assert_allclose(force_t.numpy(), np.asarray(force_r), rtol=0, atol=1e-10 * fscale)
    np.testing.assert_allclose(float(pint_t), float(pint_r), rtol=1e-10)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_r), rtol=0,
                               atol=1e-10 * float(np.abs(np.asarray(res_r)).max()))
    # the linearized pass evaluates the same two passes
    res_l, aux, _ = tlin(ut, tcd, tcd["scene"], tcd["penalty"])
    assert torch.equal(res_l, res_t) and torch.equal(aux["nodal_pressure"], p_t)


def test_held_query_tangent_matches_jax_linearize(press):
    ref, port, _ = press
    u = _penetrating_u(ref.n_dof)
    w = np.random.default_rng(7).standard_normal((ref.n_dof, 3))
    _, _, residual = _ref_contact_residual(ref)
    _, lin = jax.linearize(residual, jnp.asarray(u))
    jw_ref = np.asarray(jax.jit(lin)(jnp.asarray(w)))
    tcd, cs = port.contact[0], port.contact_static[0]
    _, _, tlin = tmake_contact_fns(3, cs["n_local"], cs["query"])
    _, _, jvp = tlin(torch.tensor(u), tcd, tcd["scene"], tcd["penalty"])
    d = jvp(torch.tensor(w))
    jw = torch.zeros(ref.n_dof, 3, dtype=d.dtype).index_add_(
        0, tcd["conn"].reshape(-1), d.reshape(-1, 3)
    )
    np.testing.assert_allclose(jw.numpy(), jw_ref, rtol=0,
                               atol=1e-9 * float(np.abs(jw_ref).max()))


def test_fdm_contact_springs_match_reference(press):
    ref, port, _ = press
    patch, topo, _ = build_patch_from_mesh(read_mfem_nurbs_mesh(MESH))
    patch.elevate_degrees(1)
    patch.refine_to(4)
    fes = FESpace(patch, topo)
    dirs = BUILD["dirichlet"]
    got = tfdm.build_fdm_data(fes, dirs, _material(mt), contact_springs=[(1, KAPPA)])
    want = ref.fdm
    plain = tfdm.build_fdm_data(fes, dirs, _material(mt))
    assert not np.allclose(plain["lam"][2][2], want["lam"][2][2])  # the spring acts
    for c in range(3):
        for ax in range(3):
            for k in ("Ve", "lam"):
                a, b = np.asarray(got[k][c][ax]), np.asarray(want[k][c][ax])
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = {k: np.asarray(v) for k, v in carry["state"].items()}
    out["contact"] = [{k: np.asarray(v) for k, v in b.items()} for b in carry["contact"]]
    return out


OBSERVABLES = ("force", "area", "pressure", "nodal_pressure", "res_el")


def _max_rel_err(ref, got):
    """max over fields and contact observables of max|got - ref| /
    max|ref| (1 where the field is zero)."""
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["state"][k], got["state"][k]) for k in ref["state"]]
    pairs += [(ref["contact"][0][k], got["contact"][0][k]) for k in OBSERVABLES]
    return max(
        float(np.abs(np.asarray(b) - np.asarray(a)).max())
        / max(float(np.abs(np.asarray(a)).max()), 1e-300)
        for a, b in pairs
    )


@pytest.fixture(scope="module")
def ref_steps(press):
    """Three reference steps of the press (soa engine) from its initial
    carry, the tool pushed 0.004 before each."""
    ref, _, jscene = press
    step = jsh.make_step(ref, residual_impl="soa", **STEP)
    carry = jsh.initial_carry(ref)
    sd = ref.contact[0]["scene"]
    out = [_ref_np(carry)]
    for _ in range(3):
        sd = mimi.NearestDistanceToSplines.translate_scene_data(sd, jnp.asarray(PUSH))
        carry = step(carry, contact_scenes=[sd])
        out.append(dict(_ref_np(carry), newton={k: np.asarray(v) for k, v in
                                                carry["newton"].items()}))
    return out


def test_three_engaged_plastic_steps_match_reference(press, ref_steps):
    """The port's plain path from the reference's initial carry: u, v, a,
    state and the contact observables agree to 1e-8 of each field's
    scale after every step, with equal Newton iteration counts; the
    press is engaged from step 1 and plastic by step 2."""
    _, port, _ = press
    step = mt.make_step(port, **STEP)
    carry = carry_from_numpy(ref_steps[0], device="cpu")
    sd = port.contact[0]["scene"]
    for i in range(1, 4):
        sd = mt.NearestDistanceToSplines.translate_scene_data(sd, PUSH)
        carry = step(carry, contact_scenes=[sd])
        ref = ref_steps[i]
        got = carry_to_numpy(carry)
        assert carry["newton"]["converged"] and carry["newton"]["finite"]
        assert carry["newton"]["iters"] == int(ref["newton"]["iters"]), i
        assert int(carry["contact"][0]["n_engaged"]) > 0
        if i >= 2:
            assert float(ref["state"]["eqps"].max()) > 0.0
        err = _max_rel_err(ref, got)
        assert err <= 1e-8, (i, err)


def test_initial_carry_with_contact_matches_reference(press):
    """a0 = M^-1 (f - E(0) - contact(0)) with the tool pushed 0.004 into
    the top face, so that the contact force drives a0 (touching alone
    gives a0 = 0 up to rounding): both packages stop their CG at rel
    1e-8."""
    ref, port, _ = press
    sd_r = mimi.NearestDistanceToSplines.translate_scene_data(
        ref.contact[0]["scene"], jnp.asarray(PUSH)
    )
    sd_p = mt.NearestDistanceToSplines.translate_scene_data(port.contact[0]["scene"], PUSH)
    a_ref = np.asarray(
        jsh.initial_carry(dataclasses.replace(ref, contact=[dict(ref.contact[0], scene=sd_r)]))["a"]
    )
    a = mt.initial_carry(
        dataclasses.replace(port, contact=[dict(port.contact[0], scene=sd_p)])
    )["a"].numpy()
    assert np.abs(a_ref).max() > 1.0
    assert np.abs(a - a_ref).max() <= 1e-8 * np.abs(a_ref).max()


def test_step_on_converted_contact_problem_matches_port_build(press, ref_steps):
    """problem_from_numpy(reference contact Problem) drives the same step
    as the port's own build_problem."""
    ref, port, jscene = press
    conv = problem_from_numpy(ref, scenes=[jscene], device="cpu")
    carries = []
    for prob in (port, conv):
        sd = mt.NearestDistanceToSplines.translate_scene_data(prob.contact[0]["scene"], PUSH)
        carry = mt.make_step(prob, **STEP)(carry_from_numpy(ref_steps[0], device="cpu"), contact_scenes=[sd])
        carries.append(carry_to_numpy(carry))
    assert _max_rel_err(carries[0], carries[1]) <= 1e-10
