"""The radial return's 40-trip kernel mode and the viscous and bfloat16
branches of the `full` tangent storage of the port (mimi_tpu_torch) against
the reference package, float64 on the CPU unless stated:

  - `kernel_solver_mode()`: J2, J2Simo and J2Log `pk1_soa` in float32 on
    random plastic input against the reference's `pk1_soa` under its own
    `kernel_solver_mode()` (its fixed 40-trip solve, the one its Pallas
    kernels run) at 1e-5; the trips each lane runs: at most 40 in the mode,
    past 40 on some lanes outside it (the "torch" engine's 100-trip solve);
  - the plain sweeps of J2Simo and J2Log with the full storage, viscous and
    with a bfloat16 block, on 8 sum-factorized elements and on 2D dense
    tables at p = 2 and p = 3, against the reference's SoA math in JAX
    float64 (the viscous flux mu_v grad v as its sweeps add it, the planes
    by `jax.linearize` of its `pk1_soa`) at 1e-10; the bfloat16 planes
    within one bfloat16 step of the reference's planes rounded.  (The
    reference's Pallas kernels in interpret mode take about a minute for
    J2Simo's full sweeps and longer for J2Log, so they are not run here.)
  - the full storage of J2, J2Linear and the neo-Hookean material: the
    plain planes against the reference's full planes (the jvps of its
    `pk1_soa`) at 1e-10, and one body-force step of each with
    tangent_storage="full" against the step with the material's own
    storage;
  - the viscous J2Simo cube press at 4^3 (J2Simo with the press's
    Johnson-Cook law, E 1e6, density 1e3, viscosity 100, kappa 5e7): two
    engaged steps of the port's plain path with the frozen contact tangent,
    each step's first Newton system held against the reference's jitted
    residual and J w in its SoA math at 1e-10 (the reference's step is not
    compiled); the bfloat16 block's J w within one bfloat16 step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu import materials as jmat
from mimi_tpu import splines as jspl
from mimi_tpu.contact.mortar import make_contact_fns as jmake_contact_fns
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch import materials as tmat
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, problem_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
BALKEN = os.path.join(DATA, "balken.mesh")
DT, FAC0, MU_V, FAC1 = 0.05, 0.01, 100.0, 0.3
FINITE = ["J2Simo", "J2Log"]


def _material(pkg, name, A=70.0, B=140.0, young=2100.0, rho=1.0, viscosity=-1.0, dim=3):
    """J2, J2Simo or J2Log with the Johnson-Cook law of the reference's
    golden trajectories (tests/test_nonlinear_solid.py:26-42) at yield stress
    A, or J2Linear / a hyperelastic material with the same elastic data,
    set up for `dim`."""
    mat = getattr(pkg, name)()
    mat.density = rho
    mat.viscosity = viscosity
    mat.set_young_poisson(young, 0.3)
    if name == "J2Linear":
        mat.sigma_y, mat.isotropic_hardening, mat.kinematic_hardening = 5.0, 50.0, 30.0
    elif name.startswith("J2"):
        mat.melting_temperature = 1500.0
        mat.initial_temperature = 20.0
        mat.specific_heat = 450.0
        mat.heat_fraction = 0.9
        h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
        h.A, h.B, h.n, h.m = A, B, 0.2835, 1.3558
        h.eps0_dot = 0.004
        h.reference_temperature = 20.0
        mat.hardening = h
    if dim:
        mat.setup(dim)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _near_eye(rng, scale, dim, shape):
    return np.eye(dim).reshape(dim, dim, *([1] * len(shape))) + scale * rng.standard_normal(
        (dim, dim, *shape))


def _history(rng, name, dim, shape):
    """A random plastic history of the J2-family material `name` (SoA)."""
    state = {"eqps": 0.01 * rng.random(shape), "temperature": 20.0 + 300.0 * rng.random(shape)}
    state["eqps"][:, ::3] = 0.0
    if name == "J2":
        ps = 2e-3 * rng.standard_normal((dim, dim, *shape))
        ps = 0.5 * (ps + ps.transpose(1, 0, *range(2, ps.ndim)))
        state["plastic_strain"] = ps - np.eye(dim).reshape(dim, dim, 1, 1) * (
            np.trace(ps) / dim)
    elif name == "J2Simo":
        be = _near_eye(rng, 0.02, dim, shape)
        state["be_old"] = 0.5 * (be + be.transpose(1, 0, 2, 3))
        state["F_old"] = _near_eye(rng, 0.02, dim, shape)
    else:
        state["Fp_inv"] = _near_eye(rng, 0.02, dim, shape)
    return state


# ---- (a) the 40-trip kernel mode ---------------------------------------------------


@pytest.mark.parametrize("name", ["J2", "J2Simo", "J2Log"])
def test_kernel_solver_mode_matches_reference(name):
    """float32 strains of ~6% on a (64, 64) batch at the body-force law (A 70,
    E 2100) on a random plastic history: inside kernel_solver_mode() the
    port's P is the reference's under its kernel_solver_mode() to 1e-5 and
    no lane runs more than 40 trips; outside, the port's P is the
    reference's 100-trip P to 1e-5 and some lanes run past 40 (float32
    cannot meet the absolute stopping tests, so a lane that has not stopped
    by trip 40 runs on to the cap)."""
    rng = np.random.default_rng(31)
    shape = (64, 64)
    F = _near_eye(rng, 0.06, 3, shape).astype(np.float32)
    state = {k: v.astype(np.float32) for k, v in _history(rng, name, 3, shape).items()}
    ref, port = _material(mimi, name), _material(mt, name)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    with jmat.kernel_solver_mode():
        P_ref40 = jax.jit(lambda F_, s: ref.pk1_soa(F_, s, DT))(jnp.asarray(F), js)
    P_ref100 = jax.jit(lambda F_, s: ref.pk1_soa(F_, s, DT))(jnp.asarray(F), js)
    assert P_ref40.dtype == jnp.float32
    with tmat.kernel_solver_mode(), tmat.record_trips() as log40:
        P40 = port.pk1_soa(torch.tensor(F), ts, DT)
    with tmat.record_trips() as log100:
        P100 = port.pk1_soa(torch.tensor(F), ts, DT)
    assert P40.dtype == torch.float32
    assert _rel(P40.numpy(), P_ref40) < 1e-5
    assert _rel(P100.numpy(), P_ref100) < 1e-5
    (t40,), (t100,) = log40, log100
    plastic = t40 > 0
    assert torch.equal(plastic, t100 > 0) and 0.2 < float(plastic.float().mean()) < 1.0
    assert int(t40.max()) == tmat.KERNEL_SOLVE_TRIPS == 40
    assert int((t100 > 40).sum()) > 0
    assert torch.equal(t40, torch.clamp(t100, max=40))


# ---- (b) viscous and bfloat16 full sweeps ---------------------------------------------


def _dense_t(prob):
    return np.transpose(np.asarray(prob.dN_dX), (2, 3, 1, 0)).copy(), np.transpose(
        np.asarray(prob.N), (2, 1, 0)).copy()


@pytest.fixture(scope="module", params=["sf_J2Simo", "sf_J2Log", "2d_p2_J2Simo", "2d_p3_J2Log"])
def visc_case(request):
    """A few elements of sum-factorized (8 elements of the cube, p = 2) or 2D
    dense tables (balken, 4 elements at p = 2 or 3), element fields made
    with numpy (u at strains of a few percent, a and w of unit size, v of a
    size that makes the viscous flux a real part of the residual), a random
    plastic history; and the reference's SoA math in JAX float64 on the
    dense tables: the viscous residual, the planes by jax.linearize of its
    pk1_soa, and the viscous matvec on those planes rounded to bfloat16
    (sf) or on the planes (dense)."""
    kind, name = request.param.rsplit("_", 1)
    if kind == "sf":
        ref_prob = jsh.build_problem(MESH, 1, 1, _material(mimi, name, dim=0),
                                     [(1, 0), (1, 1), (1, 2)], {1: -3.0}, rho_inf=0.5,
                                     dtype=jnp.float64)
        dim = 3
    else:
        ref_prob = jsh.build_problem(BALKEN, int(kind[-1]) - 1, 1, _material(mimi, name, dim=0),
                                     [(2, 0), (2, 1)], {1: -3.0}, rho_inf=0.5,
                                     dtype=jnp.float64)
        dim = 2
    dN_t, N_t = _dense_t(ref_prob)
    nd, E = dN_t.shape[0], ref_prob.n_el
    nq = dN_t.shape[2]
    rng = np.random.default_rng(41)
    data = {"u_el": 0.02 * rng.standard_normal((dim, nd, E)),
            "a_el": rng.standard_normal((dim, nd, E)),
            "v_el": 50.0 * rng.standard_normal((dim, nd, E)),
            "w_el": rng.standard_normal((dim, nd, E)),
            "state": _history(rng, name, dim, (nq, E))}
    wq = np.ascontiguousarray(np.asarray(ref_prob.w_detJ).T)
    tables = ([np.asarray(t) for t in ref_prob.sf["tables"]], np.asarray(ref_prob.sf["jinv"])) \
        if kind == "sf" else (dN_t, N_t)
    # the reference's math in JAX float64
    ref_mat = _material(mimi, name, dim=dim)
    j = {k: jnp.asarray(v) for k, v in data.items() if k != "state"}
    st = {k: jnp.asarray(v) for k, v in data["state"].items()}
    dN, N, wqj = jnp.asarray(dN_t), jnp.asarray(N_t), jnp.asarray(wq)
    grad = lambda w: jnp.einsum("ndqe,cne->cdqe", dN, w)  # noqa: E731
    F = grad(j["u_el"]) + jnp.eye(dim)[:, :, None, None]

    def integrate(P, vec):
        return jnp.einsum("qe,ndqe,cdqe->cne", wqj, dN, P) + jnp.einsum(
            "qe,nqe,cqe->cne", wqj, N, vec)

    rho = float(ref_mat.density)
    P, lin = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
    d2 = dim * dim
    cols = [lin(jnp.zeros_like(F).at[b // dim, b % dim].set(1.0)) for b in range(d2)]
    C = jnp.stack([cols[b][a // dim, a % dim] for a in range(d2) for b in range(d2)])
    # the matvec on the block the port stores: the sf one in bfloat16
    Cm = C.astype(jnp.bfloat16).astype(jnp.float64) if kind == "sf" else C
    dW = grad(j["w_el"])
    dP = FAC0 * jnp.einsum("abqe,bqe->aqe", Cm.reshape(d2, d2, *Cm.shape[1:]),
                           dW.reshape(d2, *dW.shape[2:])).reshape(dW.shape)
    return {
        "kind": kind, "name": name, "dim": dim, "data": data, "tables": tables, "wq": wq,
        "res": np.asarray(integrate(P + MU_V * grad(j["v_el"]),
                                    rho * jnp.einsum("nqe,cne->cqe", N, j["a_el"]))),
        "C": np.asarray(C), "C_bf16": np.asarray(C.astype(jnp.bfloat16).astype(jnp.float32)),
        "mv": np.asarray(integrate(dP + FAC1 * MU_V * dW,
                                   rho * jnp.einsum("nqe,cne->cqe", N, j["w_el"]))),
    }


def _plain_args(case):
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    d = case["data"]
    tables = ([t(x) for x in case["tables"][0]], t(case["tables"][1])) \
        if case["kind"] == "sf" else tuple(t(x) for x in case["tables"])
    mat = _material(mt, case["name"], dim=case["dim"])
    return ((t(d["u_el"]), t(d["a_el"]), {k: t(v) for k, v in d["state"].items()}, *tables,
             t(case["wq"]), mat, DT, float(mat.density)),
            dict(v_el=t(d["v_el"]), mu_v=MU_V))


def test_viscous_full_residual_matches_soa_math(visc_case):
    args, visc = _plain_args(visc_case)
    res = tsw.residual_sf_plain if visc_case["kind"] == "sf" else tsw.residual_dense_plain
    y = res(*args, **visc)
    assert _rel(y.numpy(), visc_case["res"]) < 1e-10
    # the viscous flux is a real part of the residual here
    assert _rel(res(*args).numpy(), visc_case["res"]) > 1e-2


def test_viscous_full_assemble_and_matvec_match_soa_math(visc_case):
    """The viscous assemble (sf: the block rounded to bfloat16, each plane
    within one bfloat16 step of the reference's plane rounded, 2^-7 of the
    block's max; dense: float64 planes at 1e-10) and the viscous matvec on
    that block at 1e-10."""
    args, visc = _plain_args(visc_case)
    sf = visc_case["kind"] == "sf"
    d2 = visc_case["dim"] ** 2
    asm = tsw.assemble_sf_plain if sf else tsw.assemble_dense_plain
    c_dtype = torch.bfloat16 if sf else None
    y, C = asm(*args, **visc, c_dtype=c_dtype)
    assert C.shape[0] == d2 * d2 and C.dtype == (torch.bfloat16 if sf else torch.float64)
    assert _rel(y.numpy(), visc_case["res"]) < 1e-10
    if sf:
        assert _rel(C.float().numpy(), visc_case["C_bf16"]) <= 2.0**-7
        _, C64 = asm(*args, **visc)
        assert _rel(C64.numpy(), visc_case["C"]) < 1e-10
        assert torch.equal(C, C64.to(torch.bfloat16))
    else:
        assert _rel(C.numpy(), visc_case["C"]) < 1e-10
    mv = tsw.matvec_sf_plain if sf else tsw.matvec_dense_plain
    w = torch.tensor(visc_case["data"]["w_el"])
    y_mv = mv(w, *args[3:-4], args[-4], C, args[-1], FAC0, FAC1 * MU_V, storage="full")
    assert _rel(y_mv.numpy(), visc_case["mv"]) < 1e-10


# ---- (c) the full storage of the other materials ----------------------------------------


FULL_OTHERS = ["J2", "J2Linear", "CompressibleOgdenNeoHookean"]


@pytest.mark.parametrize("name", FULL_OTHERS)
def test_full_planes_of_other_materials_match_reference(name):
    """On 8 sum-factorized elements on a random plastic history (J2,
    J2Linear with a deviatoric back stress): the plain assemble with
    storage="full" writes the jvps of the reference's pk1_soa (its `full`
    storage) at 1e-10, and its residual is the material's own storage's."""
    ref_prob = jsh.build_problem(MESH, 1, 1, _material(mimi, name, dim=0),
                                 [(1, 0), (1, 1), (1, 2)], {1: -3.0}, rho_inf=0.5,
                                 dtype=jnp.float64)
    E = ref_prob.n_el
    rng = np.random.default_rng(43)
    u_el = 0.004 * rng.standard_normal((3, 27, E))
    a_el = rng.standard_normal((3, 27, E))
    state = None
    if name == "J2":
        state = _history(rng, name, 3, (64, E))
    elif name == "J2Linear":
        ps = _history(rng, "J2", 3, (64, E))["plastic_strain"]
        state = {"plastic_strain": ps, "beta": 50.0 * ps, "eqps": 0.01 * rng.random((64, E))}
    ref_mat, port = _material(mimi, name), _material(mt, name)
    dN_t, _ = _dense_t(ref_prob)
    F = jnp.einsum("ndqe,cne->cdqe", jnp.asarray(dN_t), jnp.asarray(u_el)) + jnp.eye(3)[
        :, :, None, None]
    st = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    _, lin = jax.linearize(lambda Ft: ref_mat.pk1_soa(Ft, st, DT), F)
    cols = [lin(jnp.zeros_like(F).at[b // 3, b % 3].set(1.0)) for b in range(9)]
    C_ref = np.stack([np.asarray(cols[b][a // 3, a % 3]) for a in range(9) for b in range(9)])
    t = torch.tensor
    args = (t(u_el), t(a_el), None if state is None else {k: t(v) for k, v in state.items()},
            [t(np.asarray(x)) for x in ref_prob.sf["tables"]], t(np.asarray(ref_prob.sf["jinv"])),
            t(np.ascontiguousarray(np.asarray(ref_prob.w_detJ).T)), port, DT, 1.0)
    y, C = tsw.assemble_sf_plain(*args, storage="full")
    y_own, C_own = tsw.assemble_sf_plain(*args)
    assert C.shape == (81, 64, E) and C_own.shape[0] == tsw.n_planes(tsw.tangent_storage(port))
    assert _rel(C.numpy(), C_ref) < 1e-10
    assert _rel(y.numpy(), y_own.numpy()) < 1e-14
    if state is not None:  # the history yields: the tangent is the plastic one
        assert bool(plastic_mask(port, F, state).any())


def plastic_mask(mat, F, state):
    Ft = torch.tensor(np.asarray(F))
    st = {k: torch.tensor(v) for k, v in state.items()}
    if mat.name() == "J2Linear":
        return mat._common_soa(Ft, st)[3] > 0
    return mat._return_map(Ft, st, DT)[4]


@pytest.mark.parametrize("name", ["J2Linear", "StVenantKirchhoff"])
def test_full_storage_step_matches_own_storage(name):
    """One body-force step of the 2^3 cube (J2Linear at yield stress 5,
    which yields; St. Venant-Kirchhoff) with tangent_storage="full" against
    the step with the material's own storage: the same Newton and GMRES
    counts, u at 1e-10 of its scale, and the first Newton system's J w at
    1e-12."""
    prob = mt.build_problem(MESH, 1, 1, _material(mt, name, dim=0), [(1, 0), (1, 1), (1, 2)],
                            {1: -300.0}, rho_inf=0.5, device="cpu")
    carry = mt.initial_carry(prob)
    kw = dict(newton_iters=6, cg_iters=80, lin_rel_tol=1e-10)
    steps = [mt.make_step(prob, DT, tangent_storage=s, **kw) for s in ("full", "auto")]
    ns = [s.newton_system(carry) for s in steps]
    w = torch.tensor(np.random.default_rng(44).standard_normal(ns[0]["r"].shape))
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    assert _rel(ns[0]["J_apply"](w).numpy(), ns[1]["J_apply"](w).numpy()) < 1e-12
    out = [s(carry) for s in steps]
    assert out[0]["newton"]["iters"] == out[1]["newton"]["iters"] >= 2
    assert out[0]["newton"]["lin_iters"] == out[1]["newton"]["lin_iters"]
    assert _rel(out[0]["u"].numpy(), out[1]["u"].numpy()) < 1e-10
    if name == "J2Linear":
        assert float(out[0]["state"]["eqps"].max()) > 0.0


# ---- (d) the viscous J2Simo cube press ---------------------------------------------------


KAPPA, PRESS_DT = 5e7, 0.01
PUSH = [0.0, 0.0, -0.01]
PRESS = dict(dt=PRESS_DT, newton_iters=12, solver="cg", cg_iters=80, precond="fdm",
             rel_tol=1e-8, lin_rel_tol=1e-8)


def _press_material(pkg):
    """The press's J2Simo: the Johnson-Cook law A 700, B 1400 of the
    reference bench's contact press, E 1e6, density 1e3, viscosity 100."""
    return _material(pkg, "J2Simo", A=700.0, B=1400.0, young=1e6, rho=1e3, viscosity=100.0,
                     dim=0)


def _ref_press_system(ref):
    """The reference's Newton residual of the viscous press in its SoA math,
    y(aa) = (M aa + E(u) + S (va + fac1 aa) + contact(u) - f) * free with
    u = xa + fac0 aa (_soa_E_residual; the viscosity blocks; the mortar
    pressure and traction passes), and J w with the contact pressure frozen
    at aa = 0 (the reference's default frozen contact tangent), as the
    port's J_apply: one jitted (xa, va, state, scene, w) -> (y(0), J w)."""
    mat, dim, n_dof = ref.material, ref.dim, ref.n_dof
    f = ref.facs
    fac0, fac1 = f["fac3"] * PRESS_DT**2, f["fac4"] * PRESS_DT
    cs = ref.contact_static[0]
    pp, rp, _ = jmake_contact_fns(dim, cs["n_local"], cs["query"])
    d = {"conn": ref.conn, "dN_t": jnp.transpose(ref.dN_dX, (2, 3, 1, 0)),
         "wdet_t": ref.w_detJ.T, "M": ref.mass_blocks, "V": ref.visc_blocks, "f": ref.rhs,
         "free": ref.free, "cd": ref.contact[0]}

    def blocks(B, w, conn):
        return jnp.zeros((n_dof, dim), w.dtype).at[conn].add(
            jnp.einsum("enm,emc->enc", B, w[conn]))

    def y(aa, xa, va, state, sd, pressure, d):
        cd, u = d["cd"], xa + fac0 * aa
        E_u = jsh._soa_E_residual(mat, PRESS_DT, dim, n_dof, d["conn"], d["dN_t"], d["wdet_t"],
                                  u, state)
        rc = rp(u, cd, pressure)[0]
        out = (blocks(d["M"], aa * d["free"], d["conn"]) + E_u
               + blocks(d["V"], va + fac1 * aa, d["conn"])
               + jnp.zeros_like(u).at[cd["conn"]].add(rc) - d["f"])
        return out * d["free"]

    def system(xa, va, state, sd, w, d):
        pressure = pp(xa, d["cd"], sd, d["cd"]["penalty"])[0]
        aa = jnp.zeros_like(xa)
        r, dy = jax.jvp(lambda a: y(a, xa, va, state, sd, pressure, d), (aa,),
                        (w * d["free"],))
        return r, dy + (1.0 - d["free"]) * w

    jitted = jax.jit(system)
    return lambda *a: [np.asarray(x) for x in jitted(*a, d)]


def _tool(pkg, spl):
    sc = pkg.NearestDistanceToSplines()
    sc.add_spline(spl.Bezier([1, 1], [[-0.5, -0.5, 1.0], [-0.5, 1.5, 1.0],
                                      [1.5, -0.5, 1.0], [1.5, 1.5, 1.0]]))
    sc.plant_kd_tree(8, 1)
    sc.coefficient = KAPPA
    return sc


def test_viscous_j2simo_press_newton_systems_match_reference():
    """Two engaged steps of the viscous J2Simo press at 4^3 on the port's
    plain path (a float64 block, the frozen contact tangent), converted
    from the reference's problem and started from its initial carry: each
    step's first Newton system (residual and J w at the predictor) against
    the reference's at 1e-10; the material yields and the tool presses the
    cube down.  The step with matvec_dtype="bf16" builds on the same
    problem, and its J w is within one bfloat16 step of the float64
    block's."""
    scene = _tool(mimi, jspl)
    ref = jsh.build_problem(MESH, 1, 0, _press_material(mimi), [(0, 0), (0, 1), (0, 2)], {},
                            rho_inf=0.5, dtype=jnp.float64, refine_spans=4,
                            contact=[(1, scene)])
    port = problem_from_numpy(ref, device="cpu", scenes=[scene])
    assert port.sf is not None and port.material.name() == "J2Simo"
    assert float(port.material.viscosity) == 100.0
    system = _ref_press_system(ref)
    pstep = mt.make_step(port, **PRESS)
    bstep = mt.make_step(port, matvec_dtype="bf16", **PRESS)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy({k: np.asarray(rc[k]) for k in ("u", "v", "a")}
                          | {"state": {k: np.asarray(v) for k, v in rc["state"].items()}},
                          device="cpu")
    f = port.facs
    sd_r, sd_p = ref.contact[0]["scene"], port.contact[0]["scene"]
    rng = np.random.default_rng(45)
    for i in range(2):
        sd_r = mimi.NearestDistanceToSplines.translate_scene_data(sd_r, jnp.asarray(PUSH))
        sd_p = mt.NearestDistanceToSplines.translate_scene_data(sd_p, PUSH)
        c = carry_to_numpy(pc)
        xa = c["u"] + (c["v"] + f["fac0"] * PRESS_DT * c["a"]) * f["fac1"] * PRESS_DT
        va = c["v"] + f["fac2"] * PRESS_DT * c["a"]
        w = rng.standard_normal(xa.shape)
        st = {k: jnp.asarray(v) for k, v in c["state"].items()}
        r0, Jw = system(jnp.asarray(xa), jnp.asarray(va), st, sd_r, jnp.asarray(w))
        ns = pstep.newton_system(pc, contact_scenes=[sd_p])
        assert _rel(ns["r"].numpy(), r0.reshape(-1)) < 1e-10, i
        wt = torch.tensor(w.reshape(-1))
        assert _rel(ns["J_apply"](wt).numpy(), Jw.reshape(-1)) < 1e-10, i
        jw_b = bstep.newton_system(pc, contact_scenes=[sd_p])["J_apply"](wt).numpy()
        assert 0.0 < _rel(jw_b, Jw.reshape(-1)) <= 2.0**-7, i
        pc = pstep(pc, contact_scenes=[sd_p])
        assert pc["newton"]["finite"] and int(pc["contact"][0]["n_engaged"]) > 0
        assert float(pc["contact"][0]["force"][2]) < 0.0
    assert float(pc["state"]["eqps"].max()) > 0.0
