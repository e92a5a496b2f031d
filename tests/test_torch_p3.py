"""The port's cubic (p = 3) 3D paths on the CPU against the reference
package on the sum-factorized tables of cube-nurbs-3.mesh (4 nodes and 5
Gauss points per axis, 64 dofs and 125 points per element) and, for the
plain sweeps, the reference's dense tables of the same cube.

  - the plain sf residual, J w and tangent planes (the material's own
    block through the matvec, and the full 81 planes) against the
    reference's jitted dense-table math in float64 (1e-10), for J2
    Johnson-Cook, the neo-Hookean and J2Simo on a plastic history;
  - the plain sf sweeps against the plain dense sweeps on the same cube;
  - two float64 steps of the J2 body-force cube at 4^3 against the
    reference's `soa` make_step from one carry (1e-8; the two-patch cube's
    steps are in test_torch_p3_dense.py, so that the two reference steps,
    ~140 s of XLA compile each at p = 3, build on two test workers);
  - a converted reference p = 3 Problem drives the same step as the
    port's own build;
  - the p = 3 shapes pass the kernels' shape checks, which name them in
    their counters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.ops import build as kbuild
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)
from torch_shapes import DENSE_SHAPES, SF_SHAPES

DATA = os.path.join(os.path.dirname(__file__), "data")
CUBE3 = os.path.join(DATA, "cube-nurbs-3.mesh")
DT, RHO, FAC0 = 0.05, 1.0, 0.01
STEP = dict(dt=DT, newton_iters=4, cg_iters=40)
CUBE_BUILD = dict(elevate=0, subdivide=0, dirichlet=[(1, 0), (1, 1), (1, 2)],
                  body_force={1: -3.0}, rho_inf=0.5, refine_spans=4)
MATERIALS = ("J2", "CompressibleOgdenNeoHookean", "J2Simo")


def _material(pkg, name, A=1.0):
    """`name` of package `pkg` with E 2100, nu 0.3, density 1; the J2
    family with the Johnson-Cook law of the golden trajectories at yield
    stress A (1: the first step plasticizes at 4^3)."""
    mat = getattr(pkg, name)()
    mat.density = RHO
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    if name.startswith("J2"):
        mat.melting_temperature = 1500.0
        mat.initial_temperature = 20.0
        mat.specific_heat = 450.0
        mat.heat_fraction = 0.9
        h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
        h.A, h.B, h.n, h.m = A, 140.0, 0.2835, 1.3558
        h.eps0_dot = 0.004
        h.reference_temperature = 20.0
        mat.hardening = h
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _ref_np(carry):
    return {k: np.asarray(carry[k]) for k in ("u", "v", "a")} | {
        "state": None if carry["state"] is None
        else {k: np.asarray(v) for k, v in carry["state"].items()}}


def _max_rel_err(ref, got):
    """max over u, v, a and the state leaves of max|got - ref| /
    max(1, max|ref|)."""
    fields = lambda c: {"u": c["u"], "v": c["v"], "a": c["a"], **(c["state"] or {})}  # noqa: E731
    ref, got = fields(ref), fields(got)
    return max(float(np.abs(got[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
               for k in ref)


@pytest.fixture(scope="module")
def cube():
    """The reference's p = 3 cube at 4^3 in float64 (its sf tables and its
    dense dN, N, w det J), and element fields made with numpy."""
    ref = jsh.build_problem(CUBE3, material=_material(mimi, "J2"), dtype=jnp.float64,
                            **CUBE_BUILD)
    E = ref.n_el
    assert (ref.sf["pp1"], ref.sf["n_g"], ref.n_q, E) == (4, 5, 125, 64)
    rng = np.random.default_rng(31)
    data = {
        "u0": 0.02 * rng.standard_normal((3, 64, E)),
        "u_el": 0.02 * rng.standard_normal((3, 64, E)),
        "a_el": rng.standard_normal((3, 64, E)),
        "w_el": rng.standard_normal((3, 64, E)),
        "tabs": [np.asarray(t) for t in ref.sf["tables"]],
        "jinv": np.asarray(ref.sf["jinv"]),
        "wq": np.ascontiguousarray(np.asarray(ref.w_detJ).T),
        "dN_t": np.transpose(np.asarray(ref.dN_dX), (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(np.asarray(ref.N), (2, 1, 0)).copy(),
    }
    return ref, data


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _history(name, data):
    """The port's material and a plastic history for it (its state after
    one accumulate_soa from the initial state at F = I + grad u0), as
    numpy; None for the neo-Hookean."""
    mat = _material(mt, name)
    mat.setup(3)
    if not mat.has_state:
        return mat, None
    tabs, jinv = [_t(x) for x in data["tabs"]], _t(data["jinv"])
    F0 = tsoa.add_diag(tsw.sf_grad(_t(data["u0"]), tabs, jinv), 1.0)
    state0 = tsoa.state_to_soa(mat.init_state((F0.shape[-1], F0.shape[-2]), dtype=torch.float64,
                                              device="cpu"))
    state = mat.accumulate_soa(F0, state0, DT)
    assert float(state["eqps"].max()) > 0.0
    return mat, {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module", params=MATERIALS)
def reference(request, cube):
    """The reference's jitted element residual, the J w of its
    linearization (fac0 dP/dF : grad w, plus the mass term) and the 81
    planes dP_a / dF_b, on the dense tables in float64."""
    name = request.param
    _, data = cube
    mat, state = _history(name, data)
    ref_mat = _material(mimi, name)
    ref_mat.setup(3)
    dN_t, N_t, wq = (jnp.asarray(data[k]) for k in ("dN_t", "N_t", "wq"))
    st = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}

    def integrate(P, vec):
        return (jnp.einsum("qe,ndqe,cdqe->cne", wq, dN_t, P)
                + jnp.einsum("qe,nqe,cqe->cne", wq, N_t, vec))

    @jax.jit
    def run(u_el, a_el, w_el):
        F = jnp.einsum("ndqe,cne->cdqe", dN_t, u_el) + jnp.eye(3)[:, :, None, None]
        P, lin = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
        y = integrate(P, RHO * jnp.einsum("nqe,cne->cqe", N_t, a_el))
        dW = jnp.einsum("ndqe,cne->cdqe", dN_t, w_el)
        jw = integrate(FAC0 * lin(dW), RHO * jnp.einsum("nqe,cne->cqe", N_t, w_el))
        seeds = jnp.eye(9).reshape(9, 3, 3)[:, :, :, None, None] * jnp.ones_like(F)
        cols = jax.vmap(lin)(seeds)  # cols[b] = dP / dF_b
        full = jnp.stack([cols[b][a // 3, a % 3] for a in range(9) for b in range(9)])
        return y, jw, full

    out = run(*(jnp.asarray(data[k]) for k in ("u_el", "a_el", "w_el")))
    return name, mat, state, [np.asarray(x) for x in out]


def _port_args(data, mat, state):
    st = None if state is None else {k: _t(v) for k, v in state.items()}
    return (_t(data["u_el"]), _t(data["a_el"]), st, [_t(x) for x in data["tabs"]],
            _t(data["jinv"]), _t(data["wq"]), mat, DT, RHO)


def test_plain_sf_residual_matches_reference(cube, reference):
    _, data = cube
    name, mat, state, (y_ref, _, _) = reference
    y = tsw.residual_sf_plain(*_port_args(data, mat, state))
    assert y.shape == (3, 64, 64)
    assert _rel(y.numpy(), y_ref) < 1e-10, name


def test_plain_sf_assemble_and_jw_match_reference(cube, reference):
    """The assemble's residual; J w through the material's own block
    (Cauchy, symmetric or full) and the plain matvec; the full 81 planes
    of dP/dF that every material's assemble writes on request."""
    _, data = cube
    name, mat, state, (y_ref, jw_ref, full_ref) = reference
    args = _port_args(data, mat, state)
    y, C = tsw.assemble_sf_plain(*args)
    assert C.shape == (tsw.n_planes(tsw.tangent_storage(mat)), 125, 64)
    assert _rel(y.numpy(), y_ref) < 1e-10, name
    jw = tsw.matvec_sf_plain(_t(data["w_el"]), args[3], args[4], args[5], C, RHO, FAC0,
                             storage=tsw.tangent_storage(mat))
    assert _rel(jw.numpy(), jw_ref) < 1e-10, name
    _, C_full = tsw.assemble_sf_plain(*args, storage="full")
    assert _rel(C_full.numpy(), full_ref) < 1e-10, name


def test_plain_sf_matches_plain_dense(cube):
    """The sum-factorized and the dense plain sweeps on the same p = 3 cube
    (the reference's tables of both kinds): residual, tangent planes and
    matvec at 1e-10; J2 on a plastic history."""
    _, data = cube
    mat, state = _history("J2", data)
    u, a, st, tabs, jinv, wq, *rest = _port_args(data, mat, state)
    dN_t, N_t, w = _t(data["dN_t"]), _t(data["N_t"]), _t(data["w_el"])
    y_sf, C_sf = tsw.assemble_sf_plain(u, a, st, tabs, jinv, wq, *rest)
    y_d, C_d = tsw.assemble_dense_plain(u, a, st, dN_t, N_t, wq, *rest)
    assert _rel(y_sf.numpy(), y_d.numpy()) < 1e-10
    assert _rel(tsw.residual_sf_plain(u, a, st, tabs, jinv, wq, *rest).numpy(),
                tsw.residual_dense_plain(u, a, st, dN_t, N_t, wq, *rest).numpy()) < 1e-10
    assert _rel(C_sf.numpy(), C_d.numpy()) < 1e-10
    mv_sf = tsw.matvec_sf_plain(w, tabs, jinv, wq, C_sf, RHO, FAC0)
    mv_d = tsw.matvec_dense_plain(w, dN_t, N_t, wq, C_d, RHO, FAC0, storage="cauchy")
    assert _rel(mv_sf.numpy(), mv_d.numpy()) < 1e-10


def _two_steps(ref, port, make_ref_step):
    """Two steps of the reference (make_ref_step) and of the port from the
    reference's initial carry, held at 1e-8 after each."""
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = make_ref_step()
    pstep = mt.make_step(port, lin_rel_tol=1e-6, **STEP)
    for i in range(2):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["converged"] and pc["newton"]["finite"], i
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"]), i
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    return carry_to_numpy(pc)


@pytest.fixture(scope="module")
def cube_problems():
    ref = jsh.build_problem(CUBE3, material=_material(mimi, "J2"), dtype=jnp.float64,
                            **CUBE_BUILD)
    port = mt.build_problem(CUBE3, material=_material(mt, "J2"), dtype=torch.float64,
                            device="cpu", **CUBE_BUILD)
    return ref, port


def test_two_j2_cube_steps_match_reference(cube_problems):
    """J2 Johnson-Cook at yield stress 1 on the p = 3 cube at 4^3 (sf
    tables, 64 dofs and 125 points per element, the structured gather at
    pp1 = 4, the FDM on p + 2 points per axis): two float64 steps against
    the reference's `soa` step, plastic from the first."""
    ref, port = cube_problems
    assert port.sf is not None and (port.sf["pp1"], port.sf["n_g"], port.n_q) == (4, 5, 125)
    assert port.grid["pp1"] == [4, 4, 4]
    out = _two_steps(ref, port, lambda: jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm", lin_rel_tol=1e-6, **STEP))
    assert float(out["state"]["eqps"].max()) > 0.0


def test_converted_p3_problem_matches_port_build(cube_problems):
    """problem_from_numpy of the reference's p = 3 Problem carries its sf
    tables (pp1 4, n_g 5) and drives the same step as the port's build."""
    ref, port = cube_problems
    conv = problem_from_numpy(ref, device="cpu")
    assert (conv.sf["pp1"], conv.sf["n_g"], conv.n_q) == (4, 5, 125)
    assert material_from_reference(ref.material).G == port.material.G
    carry0 = mt.initial_carry(port)
    out = [carry_to_numpy(mt.make_step(p, lin_rel_tol=1e-6, **STEP)(carry0))
           for p in (port, conv)]
    assert _max_rel_err(out[0], out[1]) <= 1e-10


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_p3_shapes_pass_the_kernel_checks():
    """Consistent p = 3 tables pass the sf and dense shape checks up to the
    device check (meta tensors: no device is asked), the build's macros set
    the shape, and the counters name it."""
    E = 8
    tabs = [_meta(5, 4, E) for _ in range(6)]
    assert (4, 5) in SF_SHAPES and (3, 3) in DENSE_SHAPES
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw._check_common([("w_el", _meta(3, 64, E))], tabs, _meta(3, 3, 125, E), _meta(125, E))
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw._check_dense([("w_el", _meta(3, 64, E))], _meta(64, 3, 125, E), _meta(64, 125, E),
                         _meta(125, E))
    assert kbuild.defines("sf", (4, 5)) == ["-DMIMI_SF_P1=4", "-DMIMI_SF_NG=5"]
    assert kbuild.defines("dense", tsw.dense_key(3, 3)) == [
        "-DMIMI_DENSE_DIM=3", "-DMIMI_DENSE_ND=64", "-DMIMI_DENSE_NQ=125"]
    assert tsw._shape_suffix(3, (4, 5)) == "@3d_p3" and tsw._shape_suffix(3, (3, 4)) == ""
    mat = _material(mt, "J2")
    mat.setup(3)
    assert tsw.kernel_counters(mat, "sf", 3, 3) == ("residual_sf@3d_p3", "assemble_sf@3d_p3")
    assert tsw.matvec_counter("sf", "cauchy", 3, 3) == "matvec_sf@3d_p3"
    assert tsw.kernel_counters(mat, "dense", 3, 3) == (
        "residual_dense[j2]@3d_p3", "assemble_dense[j2,cauchy]@3d_p3")
    for kind in ("sf", "dense"):
        for name in (*tsw.kernel_counters(mat, kind, 3, 3),
                     tsw.matvec_counter(kind, "cauchy", 3, 3)):
            assert name in tsw.shape_counters(kind, (4, 5) if kind == "sf" else (3, 64, 125)), name
