"""The port's finite-strain J2 plasticity (mimi_tpu_torch J2Simo, J2Log) and
the 81-plane `full` tangent storage against the reference package, float64
on the CPU unless stated:

  - J2Simo and J2Log `pk1_soa` and `accumulate_soa` at 1e-12 on random F
    with elastic and plastic points and with C near I;
  - `logm_sym_soa` and `expm_sym_soa` on the fast, escalated and poisoned
    branches at 1e-12, and J2Log's P on a batch with one point past the
    fast log series' range (every point takes the deep series) at 1e-12;
  - J2, J2Simo and J2Log P and `full` planes in float32 at strains of
    1e-23 (q^2 subnormal) against the reference at 1e-10: finite;
  - the plain sf sweeps with the `full` storage against the reference's
    SoA math at 8 elements, one of them at C near I (both materials,
    1e-10): the residual, the 81 planes of `full_tangent_planes` against
    `jax.linearize` of the reference's `pk1_soa`, and the matvec.  (The
    Pallas kernels in interpret mode take about a minute here for J2Simo
    and longer for J2Log, so the sweeps are held against the SoA math, as
    tests/test_pallas.py:68-78 does);
  - 3 plastic steps of the J2Simo 4^3 cube against JAX `soa` at 1e-8; 3
    plastic steps of the J2Log cube against the reference's Newton
    residual, its derivative and accumulate_soa (its step takes ~200 s to
    compile);
  - what make_step takes and refuses, the conversions, the counters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.materials import logm as jlogm
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.materials import logm as tlogm
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
DT, RHO, FAC0 = 0.05, 1.0, 0.01
MATERIALS = ["J2Simo", "J2Log"]
BUILD = dict(elevate=1, dirichlet=[(1, 0), (1, 1), (1, 2)], body_force={1: -3.0}, rho_inf=0.5)
STEP = dict(dt=0.05, newton_iters=4, cg_iters=40)
A_PLASTIC = 1.0  # the steps' yield stress: the golden's 70 stays elastic at 4^3


def _material(pkg, name, A=70.0, setup=True):
    """The reference golden's Johnson-Cook material
    (tests/test_nonlinear_solid.py:26-42) with yield stress A."""
    mat = getattr(pkg, name)()
    mat.density = RHO
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = A, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    if setup:
        mat.setup(3)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _near_eye(rng, scale, shape):
    return np.eye(3).reshape(3, 3, *([1] * len(shape))) + scale * rng.standard_normal(
        (3, 3, *shape)
    )


def _history(rng, name, shape):
    """A random plastic history in the material's state layout (SoA)."""
    state = {
        "eqps": 0.01 * rng.random(shape),
        "temperature": 20.0 + 300.0 * rng.random(shape),
    }
    state["eqps"][:, ::3] = 0.0
    if name == "J2Simo":
        be = _near_eye(rng, 0.02, shape)
        state["be_old"] = 0.5 * (be + be.transpose(1, 0, 2, 3))
        state["F_old"] = _near_eye(rng, 0.02, shape)
    else:
        state["Fp_inv"] = _near_eye(rng, 0.02, shape)
    return state


# ---- (a) the materials ---------------------------------------------------------


@pytest.fixture(scope="module", params=MATERIALS)
def point_case(request):
    """(name, F, state): strains of ~3% on a (64, 6) batch, one element at F
    = I plus 1e-7 (C near I), a random plastic history."""
    name = request.param
    rng = np.random.default_rng(7)
    B = (64, 6)
    F = _near_eye(rng, 0.03, B)
    F[:, :, :, 0] = _near_eye(rng, 1e-7, (64,))
    return name, F, _history(rng, name, B)


def _both_materials(name):
    return _material(mimi, name), _material(mt, name)


def test_pk1_and_accumulate_match_reference(point_case):
    name, F, state = point_case
    ref, port = _both_materials(name)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    P_ref = ref.pk1_soa(jnp.asarray(F), js, DT)
    assert _rel(port.pk1_soa(torch.tensor(F), ts, DT).numpy(), P_ref) < 1e-12
    new_ref = ref.accumulate_soa(jnp.asarray(F), js, DT)
    new = port.accumulate_soa(torch.tensor(F), ts, DT)
    assert set(new) == set(new_ref)
    for k in new_ref:
        assert _rel(new[k].numpy(), new_ref[k]) < 1e-12, k
    yielded = np.asarray(new_ref["eqps"]) > state["eqps"]
    assert 0.05 < yielded.mean() < 0.95  # elastic and plastic points


def _spd(rng, n, stretch):
    """n SPD matrices F^T F (SoA) with F = diag(stretch, 1, 1) + noise."""
    F = _near_eye(rng, 0.05, (n,))
    F[0, 0] *= stretch
    return np.einsum("kin,kjn->ijn", F, F)


@pytest.mark.parametrize(
    "stretch, expect",
    [(1.0, "fast"), (6.0, "escalated"), (1e5, "poisoned")],
    ids=["fast", "escalated", "poisoned"],
)
def test_logm_matches_reference(stretch, expect):
    """logm_sym_soa on a batch of C near I plus one point stretched by
    `stretch`: in range (fast series), past the fast range (the batch takes
    the deep series) or past the deep range (that point is NaN)."""
    rng = np.random.default_rng(11)
    C = _spd(rng, 16, 1.0)
    C[:, :, 0] = _spd(rng, 1, stretch)[:, :, 0]
    ref = np.asarray(jlogm.logm_sym_soa(jnp.asarray(C)))
    got = tlogm.logm_sym_soa(torch.tensor(C)).numpy()
    bad = np.isnan(ref).any(axis=(0, 1))
    assert (np.isnan(got).any(axis=(0, 1)) == bad).all()
    assert bad[0] == (expect == "poisoned") and not bad[1:].any()
    assert _rel(got[..., ~bad], ref[..., ~bad]) < 1e-12
    # the stretched point is outside the fast series' range unless "fast"
    fast, xn = tlogm._logm_core(torch.tensor(C), *tlogm.LOGM_FAST)
    assert bool(xn[0] > tlogm.LOGM_X_MAX) == (expect != "fast")
    assert bool((xn[1:] <= tlogm.LOGM_X_MAX).all())
    if expect == "fast":
        assert np.array_equal(fast.numpy(), got)


@pytest.mark.parametrize(
    "stretch, expect",
    [(1.0, "fast"), (6.0, "escalated"), (1e5, "poisoned")],
    ids=["fast", "escalated", "poisoned"],
)
def test_j2log_stress_on_a_mixed_batch_matches_reference(stretch, expect):
    """J2Log's P on a batch of 24 points (strains of ~3%, a random plastic
    history) where point 0's Fp^-1 is diag(stretch, 1, 1): in range (the
    fast series everywhere), past the fast range (every point of the batch
    takes the deep series, as the CUDA sweeps do for all the points of a
    launch) or past the deep range (point 0 is NaN), against the
    reference's pk1_soa at 1e-12 on the same numpy input.  In the escalated
    batch the in-range points' P is the deep series', not the fast one's."""
    rng = np.random.default_rng(19)
    F = _near_eye(rng, 0.03, (1, 24))
    state = _history(rng, "J2Log", (1, 24))
    state["Fp_inv"][:, :, 0, 0] = np.diag([stretch, 1.0, 1.0])
    ref, port = _both_materials("J2Log")
    P_ref = np.asarray(ref.pk1_soa(jnp.asarray(F), {k: jnp.asarray(v) for k, v in state.items()},
                                   DT))
    ts = {k: torch.tensor(v) for k, v in state.items()}
    P = port.pk1_soa(torch.tensor(F), ts, DT).numpy()
    bad = np.isnan(P_ref).any(axis=(0, 1))[0]
    assert (np.isnan(P).any(axis=(0, 1))[0] == bad).all()
    assert bad[0] == (expect == "poisoned") and not bad[1:].any()
    assert _rel(P[..., 0, ~bad], P_ref[..., 0, ~bad]) < 1e-12
    # the decision's input: point 0's elastic C = (F Fp^-1)^T F Fp^-1 is
    # out of the fast series' range unless "fast", the others in it
    Fe = torch.einsum("ikqe,kjqe->ijqe", torch.tensor(F), ts["Fp_inv"])
    _, xn = tlogm._logm_core(torch.einsum("kiqe,kjqe->ijqe", Fe, Fe), *tlogm.LOGM_FAST)
    assert bool(xn[0, 0] > tlogm.LOGM_X_MAX) == (expect != "fast")
    assert bool((xn[0, 1:] <= tlogm.LOGM_X_MAX).all())
    # points 1.. alone stay in the fast series: the batch's P there is
    # theirs only where point 0 is in range too
    later = {k: v[..., 1:] for k, v in ts.items()}
    P_fast = port.pk1_soa(torch.tensor(F[..., 1:]), later, DT).numpy()
    assert np.array_equal(P_fast, P[..., 1:]) == (expect == "fast")


@pytest.mark.parametrize("size, expect", [(0.5, "fast"), (10.0, "escalated"), (100.0, "poisoned")],
                         ids=["fast", "escalated", "poisoned"])
def test_expm_matches_reference(size, expect):
    rng = np.random.default_rng(5)
    A = 0.1 * rng.standard_normal((3, 3, 8))
    A = 0.5 * (A + A.transpose(1, 0, 2))
    A[:, :, 0] *= size / np.linalg.norm(A[:, :, 0])
    ref = np.asarray(jlogm.expm_sym_soa(jnp.asarray(A)))
    got = tlogm.expm_sym_soa(torch.tensor(A)).numpy()
    bad = np.isnan(ref).any(axis=(0, 1))
    assert (np.isnan(got).any(axis=(0, 1)) == bad).all()
    assert bad[0] == (expect == "poisoned") and not bad[1:].any()
    assert _rel(got[..., ~bad], ref[..., ~bad]) < 1e-12


def _subnormal_q_case(name):
    """float32 F = I + 1e-23 e_01 at points 0-3 and I plus a seeded numpy
    draw of the same size at points 4-7, on the material's initial state:
    every point elastic, q ~ 1e-20, q^2 subnormal in float32."""
    eye = np.repeat(np.eye(3, dtype=np.float32)[:, :, None, None], 8, axis=3)
    F = eye.copy()
    F[0, 1, :, :4] = 1e-23
    draw = 1e-23 * np.random.default_rng(23).standard_normal((3, 3, 1, 4))
    F[:, :, :, 4:] += draw.astype(np.float32)
    state = {"eqps": np.zeros((1, 8), np.float32), "temperature": np.full((1, 8), 20.0, np.float32)}
    if name == "J2Log":
        state["Fp_inv"] = eye
    elif name == "J2Simo":
        state["be_old"], state["F_old"] = eye, eye.copy()
    else:
        state["plastic_strain"] = np.zeros((3, 3, 1, 8), np.float32)
    return F, state


@pytest.mark.parametrize("name", ["J2", "J2Simo", "J2Log"])
def test_tangent_at_a_subnormal_q_matches_reference(name):
    """P and the 81 `full` planes (ops/sweeps.py full_tangent_planes) in
    float32 at strains of 1e-23, where q^2 is subnormal: finite and equal to
    the reference's pk1_soa and its jvp planes (1e-10, the sweeps' bar
    below).  There the flow direction's derivative 1.5 q' / q^2 overflows
    float32; the elastic point's zero increment must not multiply it (the
    reference's XLA flushes subnormals to zero, so its q is 0).  J2Simo's
    near-zero deviator guard covers it already; J2 and J2Log leave the
    increment's term out on elastic points."""
    F, state = _subnormal_q_case(name)
    ref, port = _both_materials(name)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    seeds = jnp.asarray(np.eye(9, dtype=np.float32).reshape(9, 3, 3, 1, 1) * np.ones_like(F))
    P_ref, cols = jax.vmap(lambda s: jax.jvp(lambda Ft: ref.pk1_soa(Ft, js, DT),
                                             (jnp.asarray(F),), (s,)))(seeds)
    C_ref = np.asarray(jnp.stack([cols[b][a // 3, a % 3] for a in range(9) for b in range(9)]))
    assert P_ref.dtype == jnp.float32 and np.isfinite(C_ref).all()
    P, C = tsw.full_tangent_planes(port, torch.tensor(F), {k: torch.tensor(v) for k, v in
                                                           state.items()}, DT)
    assert P.dtype == torch.float32 and bool(torch.isfinite(C).all())
    assert _rel(P.numpy(), P_ref[0]) < 1e-10
    assert _rel(C.numpy(), C_ref) < 1e-10


# ---- (b) the sf sweeps with the full storage -------------------------------------


@pytest.fixture(scope="module")
def case():
    """8 elements (p=2, 4^3 Gauss points), element fields made with numpy:
    u at strains of a few percent (1e-7 on element 0: C near I), a and w
    of unit size, a random plastic history per material."""
    prob = jsh.build_problem(
        MESH, subdivide=1, material=_material(mimi, "J2Simo"), dtype=jnp.float64, **BUILD
    )
    E = prob.n_el
    rng = np.random.default_rng(13)
    u_el = 0.02 * rng.standard_normal((3, 27, E))
    u_el[:, :, 0] *= 5e-6
    return {
        "n_el": E,
        "u_el": u_el,
        "a_el": rng.standard_normal((3, 27, E)),
        "w_el": rng.standard_normal((3, 27, E)),
        "tabs": [np.asarray(t) for t in prob.sf["tables"]],
        "jinv": np.asarray(prob.sf["jinv"]),
        "wq": np.ascontiguousarray(np.asarray(prob.w_detJ).T),
        "dN_t": np.transpose(prob.dN_dX, (2, 3, 1, 0)).copy(),
        "N_t": np.transpose(prob.N, (2, 1, 0)).copy(),
        "states": {name: _history(np.random.default_rng(17), name, (64, E))
                   for name in MATERIALS},
    }


def _sf_args(data, name, dtype):
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (
        t(data["u_el"]), t(data["a_el"]), {k: t(v) for k, v in data["states"][name].items()},
        [t(x) for x in data["tabs"]], t(data["jinv"]), t(data["wq"]),
    )


@pytest.fixture(scope="module", params=MATERIALS)
def jax_f64(request, case):
    """The reference's SoA math in JAX float64 on the dense tables: the
    residual, the 81 planes by jax.linearize of pk1_soa, and the matvec as
    the jvp of P; with the port's material of the same name."""
    name = request.param
    ref_mat = _material(mimi, name)
    j = {k: jnp.asarray(v) for k, v in case.items() if k not in ("n_el", "tabs", "states")}
    st = {k: jnp.asarray(v) for k, v in case["states"][name].items()}
    dN, N, wq = j["dN_t"], j["N_t"], j["wq"]
    F = jnp.einsum("ndqe,cne->cdqe", dN, j["u_el"]) + jnp.eye(3)[:, :, None, None]

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wq, dN, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wq, N, vec
        )

    P, lin = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
    cols = [lin(jnp.zeros_like(F).at[b // 3, b % 3].set(1.0)) for b in range(9)]
    planes = [cols[b][a // 3, a % 3] for a in range(9) for b in range(9)]
    dP = FAC0 * lin(jnp.einsum("ndqe,cne->cdqe", dN, j["w_el"]))
    return {
        "name": name,
        "res": np.asarray(integrate(P, RHO * jnp.einsum("nqe,cne->cqe", N, j["a_el"]))),
        "C": np.asarray(jnp.stack(planes)),
        "mv": np.asarray(integrate(dP, RHO * jnp.einsum("nqe,cne->cqe", N, j["w_el"]))),
        "mat": _material(mt, name),
    }


def test_sf_full_residual_matches_soa_math(case, jax_f64):
    args = _sf_args(case, jax_f64["name"], torch.float64)
    y = tsw.residual_sf_plain(*args, jax_f64["mat"], DT, RHO)
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10


def test_sf_full_assemble_matches_soa_math(case, jax_f64):
    """Through the wrapper, which on CPU tensors runs the plain version and
    keeps the block in the fields' dtype."""
    args = _sf_args(case, jax_f64["name"], torch.float64)
    assert tsw.tangent_storage(jax_f64["mat"]) == "full"
    y, C = tsw.assemble_sf(*args, jax_f64["mat"], DT, RHO)
    assert C.shape == (81, 64, case["n_el"]) and C.dtype == torch.float64
    assert _rel(y.numpy(), jax_f64["res"]) < 1e-10
    assert _rel(C.numpy(), jax_f64["C"]) < 1e-10


def test_sf_full_matvec_matches_soa_math(case, jax_f64):
    _, _, _, tabs, jinv, wq = _sf_args(case, jax_f64["name"], torch.float64)
    y = tsw.matvec_sf_plain(
        torch.tensor(case["w_el"]), tabs, jinv, wq, torch.tensor(jax_f64["C"]), RHO, FAC0,
        storage="full",
    )
    assert _rel(y.numpy(), jax_f64["mv"]) < 1e-10


# ---- (c) the J2Simo steps ----------------------------------------------------------


def _ref_np(carry):
    return {
        "u": np.asarray(carry["u"]),
        "v": np.asarray(carry["v"]),
        "a": np.asarray(carry["a"]),
        "state": {k: np.asarray(v) for k, v in carry["state"].items()},
    }


def _max_rel_err(ref, got):
    """max over u, v, a and the state leaves of max|got - ref| /
    max(1, max|ref|)."""
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["state"][k], got["state"][k]) for k in ref["state"]]
    return max(
        float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max())) for r, g in pairs
    )


def _cubes(name):
    """The 4^3 cube at yield stress A_PLASTIC in both packages (float64)
    and the port's step at FDM-GMRES lin_rel_tol 1e-6."""
    kw = dict(BUILD, subdivide=0, refine_spans=4)
    ref = jsh.build_problem(
        MESH, material=_material(mimi, name, A_PLASTIC, setup=False), dtype=jnp.float64, **kw
    )
    port = mt.build_problem(
        MESH, material=_material(mt, name, A_PLASTIC, setup=False), device="cpu", **kw
    )
    assert port.sf is not None and set(port.state0) == set(ref.state0)
    return ref, port, mt.make_step(port, lin_rel_tol=1e-6, **STEP)


def test_three_j2simo_steps_match_reference():
    """Both packages start from the reference's initial carry and take 3
    steps: u, v, a and the state agree to 1e-8 after every step and the
    material yields in the first."""
    ref, port, pstep = _cubes("J2Simo")
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm", lin_rel_tol=1e-6, **STEP
    )
    for i in range(3):
        rc, pc = rstep(rc), pstep(pc)
        if i == 0:
            assert float(np.asarray(rc["state"]["eqps"]).max()) > 0.0
            assert float(pc["state"]["eqps"].max()) > 0.0
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)


def _ref_newton_system(ref):
    """The reference's Newton residual in its SoA math, y(aa) = (M aa +
    E(xa + fac0 aa) - f) * free (sharding.py make_forward, with the SoA
    elastic sweep _soa_E_residual), and its derivative applied as the
    port's J_apply is, J w = dy/daa [w * free] + (1 - free) w: one jitted
    (aa, xa, state, w) -> (y, J w)."""
    mat, dim, n_dof = ref.material, ref.dim, ref.n_dof
    fac0 = ref.facs["fac3"] * DT * DT
    d = {"conn": ref.conn, "dN_t": jnp.transpose(ref.dN_dX, (2, 3, 1, 0)),
         "wdet_t": ref.w_detJ.T, "M": ref.mass_blocks, "f": ref.rhs, "free": ref.free}

    def y(aa, xa, state, d):
        E_u = jsh._soa_E_residual(mat, DT, dim, n_dof, d["conn"], d["dN_t"], d["wdet_t"],
                                  xa + fac0 * aa, state)
        ye = jnp.einsum("enm,emc->enc", d["M"], (aa * d["free"])[d["conn"]])
        return (jnp.zeros_like(aa).at[d["conn"]].add(ye) + E_u - d["f"]) * d["free"]

    def y_jw(aa, xa, state, w, d):
        r, dy = jax.jvp(lambda a: y(a, xa, state, d), (aa,), (w * d["free"],))
        return r, dy + (1.0 - d["free"]) * w

    jitted = jax.jit(y_jw)
    return lambda aa, xa, st, w: [np.asarray(x) for x in jitted(aa, xa, st, w, d)]


def test_three_j2log_steps_match_reference():
    """3 steps of the port from the reference's initial carry, each held
    against the reference's equations in its SoA math: the first Newton
    system (residual and J w at the predictor) at 1e-10, the converged
    increment leaves the reference's residual below the Newton goal (rel
    1e-8), and the new state is the reference's accumulate_soa at the new
    u to 1e-10; the material yields in the first step.  (The reference's
    J2Log step is not compiled: its trace, lowering and XLA compile take
    about 200 s on the CPU, against ~20 s for this residual and its jvp.)"""
    ref, port, pstep = _cubes("J2Log")
    y_jw = _ref_newton_system(ref)
    accumulate = jax.jit(lambda F, st: ref.material.accumulate_soa(F, st, DT))
    f, dt = port.facs, STEP["dt"]
    conn = np.asarray(ref.conn)
    dN_t = np.transpose(np.asarray(ref.dN_dX), (2, 3, 1, 0))
    pc = carry_from_numpy(_ref_np(jsh.initial_carry(ref)), device="cpu")
    rng = np.random.default_rng(23)
    for i in range(3):
        c = carry_to_numpy(pc)
        xa = c["u"] + (c["v"] + f["fac0"] * dt * c["a"]) * f["fac1"] * dt
        st = {k: jnp.asarray(v) for k, v in c["state"].items()}
        w = rng.standard_normal(xa.shape)
        r0, Jw = y_jw(np.zeros_like(xa), xa, st, w)
        ns = pstep.newton_system(pc)
        assert _rel(ns["r"].numpy(), r0.reshape(-1)) < 1e-10, i
        assert _rel(ns["J_apply"](torch.tensor(w.reshape(-1))).numpy(), Jw.reshape(-1)) < 1e-10, i
        pc = pstep(pc)
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        n = carry_to_numpy(pc)
        aa = (n["a"] - c["a"] * (1.0 - f["fac1_inv"])) / f["fac5_inv"]
        r = y_jw(aa, xa, st, np.zeros_like(xa))[0]
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(r0), i
        F = np.einsum("ndqe,cne->cdqe", dN_t, np.transpose(n["u"][conn], (2, 1, 0)))
        new_ref = accumulate(jnp.asarray(F + np.eye(3)[:, :, None, None]), st)
        for k, v in new_ref.items():
            assert _rel(n["state"][k], v) < 1e-10, (i, k)
        if i == 0:
            assert float(np.asarray(new_ref["eqps"]).max()) > 0.0
            assert float(n["state"]["eqps"].max()) > 0.0


# ---- (d) make_step, conversions, counters ----------------------------------------


@pytest.fixture(scope="module", params=MATERIALS)
def small(request):
    return mt.build_problem(
        MESH, material=_material(mt, request.param, setup=False), device="cpu", subdivide=1,
        **BUILD,
    )


def test_make_step_takes_sf_full(small):
    assert small.sf is not None
    assert tsw.tangent_storage(small.material) == "full"
    for option in ({}, {"tangent_storage": "full"}, {"matvec_impl": "sf"}):
        step = mt.make_step(small, 0.05, **option)
        ns = step.newton_system(mt.initial_carry(small))
        assert torch.isfinite(ns["r"]).all()
        assert torch.isfinite(ns["J_apply"](torch.ones_like(ns["r"]))).all()


@pytest.mark.parametrize(
    "option, item",
    [({"tangent_storage": "sym"}, 3), ({"matvec_dtype": "bf16"}, 3), ({"matvec_impl": "dense"}, 2)],
    ids=["sym", "bf16", "dense_matvec"],
)
def test_unported_sf_full_options_raise(small, option, item):
    if option == {"tangent_storage": "sym"}:
        # J2Simo has no major-symmetric dP/dF: a wrong request, as in the
        # reference
        with pytest.raises(ValueError, match="major-symmetric"):
            mt.make_step(small, 0.05, **option)
        return
    if option == {"matvec_dtype": "bf16"}:
        # ported: the full block rounded to bfloat16; the step runs, and
        # its J w differs from the float64 block's by the block's rounding
        carry = mt.initial_carry(small)
        steps = [mt.make_step(small, 0.05, matvec_dtype=d) for d in ("bf16", "f32")]
        ns = [s.newton_system(carry) for s in steps]
        w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(2),
                        dtype=ns[0]["r"].dtype)
        jw = [n["J_apply"](w) for n in ns]
        assert torch.equal(ns[0]["r"], ns[1]["r"])
        assert 0.0 < float((jw[0] - jw[1]).abs().max()) <= 2.0**-7 * float(jw[1].abs().max())
        out = steps[0](carry)
        assert out["newton"]["finite"] and out["newton"]["iters"] > 0
        return
    # ported: matvec_impl="dense" runs the dense sweeps on the patch's dense
    # tables; the Newton system is the sf one's to rounding
    assert option == {"matvec_impl": "dense"} and item == 2
    carry = mt.initial_carry(small)
    ns = [mt.make_step(small, 0.05, matvec_impl=impl).newton_system(carry)
          for impl in ("dense", "sf")]
    w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(3),
                    dtype=ns[0]["r"].dtype)
    jw = [n["J_apply"](w) for n in ns]
    assert float((ns[0]["r"] - ns[1]["r"]).abs().max()) <= 1e-12 * float(ns[1]["r"].abs().max())
    assert float((jw[0] - jw[1]).abs().max()) <= 1e-10 * float(jw[1].abs().max())


def test_conversion_round_trips(point_case):
    """material_from_reference copies the material (its hardening too);
    problem_from_numpy carries the reference's initial state;
    carry_from_numpy / carry_to_numpy round-trip the material state."""
    name, _, state = point_case
    ref = _material(mimi, name, A_PLASTIC)
    port = material_from_reference(ref)
    assert type(port) is getattr(mt, name)
    assert port.G == ref.G and port.K == ref.K and port._tolerance == ref._tolerance
    assert port.hardening.A == A_PLASTIC and port.hardening.m == ref.hardening.m
    rprob = jsh.build_problem(MESH, material=_material(mimi, name), dtype=jnp.float64,
                              subdivide=0, **BUILD)
    pprob = problem_from_numpy(rprob, device="cpu")
    assert type(pprob.material) is getattr(mt, name)
    for k, v in rprob.state0.items():
        assert np.array_equal(pprob.state0[k].numpy(), np.asarray(v)), k
    n = 4
    carry = {"u": np.zeros((n, 3)), "v": np.ones((n, 3)), "a": np.zeros((n, 3)),
             "state": state}
    back = carry_to_numpy(carry_from_numpy(carry, device="cpu"))
    assert set(back["state"]) == set(state)
    for k, v in state.items():
        assert np.array_equal(back["state"][k], v), k


def test_launch_counters_name_every_variant():
    for name in ("residual_sf[simo]", "assemble_sf[simo,full]", "residual_sf[log]",
                 "assemble_sf[log,full]", "matvec_sf[full]"):
        assert name in tsw.shape_counters("sf", (3, 4))
    assert tsw.material_counters("sf", "simo", "full") == (
        "residual_sf[simo]", "assemble_sf[simo,full]")
