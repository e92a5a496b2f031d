"""The finite-strain plasticity models J2Simo and J2Log on the port's
dense-table path (mimi_tpu_torch, the full tangent storage: 16 planes in
2D, 81 in 3D) against the reference package, float64 on the CPU unless
stated:

  - 2D stress (`pk1_soa`) and state update (`accumulate_soa`) on a loaded
    2 x 2 state at 1e-12;
  - the plain dense sweeps with the full storage on the golden cantilever's
    tables (balken.mesh, 2D p=3 and p=2) and on two-patch-cube.mesh (3D
    p=2): the residual against the reference's jitted SoA residual, the
    assemble's planes against forward-mode derivatives of the reference's
    `pk1_soa` (jax.jvp along the one-hot seeds), and the matvec against the
    residual's jvp, at 1e-10;
  - one 3D two-patch J2Simo step against the reference's `soa` step at
    1e-8 (the 2D golden steps are tests/test_torch_dense_finite_steps.py);
  - the plane count, the launch counters, the conversion of a 2D J2Simo
    reference problem, a two-patch problem's step, and the branches that
    stay unported raising with their ROADMAP items (meta tensors).
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
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.parallel import sharding as tsh
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)
from torch_shapes import DENSE_SHAPES

DATA = os.path.join(os.path.dirname(__file__), "data")
BALKEN = os.path.join(DATA, "balken.mesh")
TWO_CUBE = os.path.join(DATA, "two-patch-cube.mesh")
CLAMP = [(2, 0), (2, 1)]
CLAMP_3D = [(0, 0), (0, 1), (0, 2)]
MATERIALS = ["J2Simo", "J2Log"]
# the golden's body force and time step (tests/test_nonlinear_solid.py)
FORCE, DT = -3.0, 0.5
RHO, FAC0 = 1.0, 0.01


def _material(pkg, name, A=70.0):
    """The golden's Johnson-Cook material `name` of package `pkg`
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
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _near_eye(rng, scale, shape):
    d = shape[0]
    return np.eye(d).reshape(d, d, *([1] * (len(shape) - 2))) + scale * rng.standard_normal(shape)


def _history(rng, name, dim, batch):
    """A loaded history in the material's state layout (dim, dim, *batch) /
    (*batch): eqps up to 0.01 (zero on every third column), temperature
    20-120, be_old and F_old (J2Simo) or Fp_inv (J2Log) within 2% of I."""
    shape = (dim, dim, *batch)
    state = {"eqps": 0.01 * rng.random(batch), "temperature": 20.0 + 100.0 * rng.random(batch)}
    state["eqps"][..., ::3] = 0.0
    if name == "J2Simo":
        be = _near_eye(rng, 0.02, shape)
        state["be_old"] = 0.5 * (be + np.swapaxes(be, 0, 1))
        state["F_old"] = _near_eye(rng, 0.02, shape)
    else:
        state["Fp_inv"] = _near_eye(rng, 0.02, shape)
    return state


def _jnp(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _torch(state):
    return {k: torch.tensor(v) for k, v in state.items()}


# ---- (a) the materials in 2D -------------------------------------------------------


def _point_case(name):
    """Both packages' material set up in 2D, F at strains of ~3% over 80
    points and a loaded 2 x 2 history."""
    ref, port = _material(mimi, name), _material(mt, name)
    ref.setup(2)
    port.setup(2)
    rng = np.random.default_rng(2)
    return ref, port, _near_eye(rng, 0.03, (2, 2, 80)), _history(rng, name, 2, (80,))


@pytest.mark.parametrize("name", MATERIALS)
def test_2d_stress_matches_reference(name):
    """P of a true 2 x 2 finite-strain tensor (the deviator over trace / 2,
    J2Simo's cube root of the 2 x 2 det, J2Log's 2 x 2 log series) at
    1e-12, where most points yield."""
    ref, port, F, st = _point_case(name)
    P_ref = ref.pk1_soa(jnp.asarray(F), _jnp(st), DT)
    assert _rel(port.pk1_soa(torch.tensor(F), _torch(st), DT).numpy(), P_ref) < 1e-12
    active = port._return_map_soa(torch.tensor(F), _torch(st), DT)[4]
    assert float(active.double().mean()) > 0.5


def test_cbrt_is_the_real_cube_root():
    """J2Simo's f_bar = inv(f_inv) cbrt(det): the reference's jnp.cbrt takes
    the real cube root of a negative determinant (an inverted trial
    state), as the CUDA kernels' cbrtf does; the plain version too, and
    x ** (1/3) to the bit for x > 0."""
    x = np.array([-8.0, -0.3, 1e-30, 0.7, 1.0, 27.0, 3.3e5])
    got = tsoa.cbrt(torch.tensor(x))
    assert _rel(got.numpy(), np.asarray(jnp.cbrt(jnp.asarray(x)))) < 1e-15
    pos = torch.tensor(x[x > 0])
    assert torch.equal(tsoa.cbrt(pos), pos ** (1.0 / 3.0))


@pytest.mark.parametrize("name", MATERIALS)
def test_2d_state_update_matches_reference(name):
    ref, port, F, st = _point_case(name)
    new_ref = ref.accumulate_soa(jnp.asarray(F), _jnp(st), DT)
    new = port.accumulate_soa(torch.tensor(F), _torch(st), DT)
    assert set(new) == set(new_ref)
    for k, v in new_ref.items():
        assert new[k].shape == v.shape
        assert _rel(new[k].numpy(), v) < 1e-12, k
    assert float(new["eqps"].max()) > float(st["eqps"].max())


# ---- (b) the plain dense sweeps with the full storage ---------------------------------


SWEEP_SHAPES = {  # mesh, elevate, subdivide, refine_spans, dirichlet
    "2d_p3": (BALKEN, 2, 1, None, CLAMP),
    "2d_p2": (BALKEN, 1, 2, None, CLAMP),
    "3d_p2": (TWO_CUBE, 1, 0, 2, CLAMP_3D),
}


@pytest.fixture(scope="module",
                params=[(s, m) for s in SWEEP_SHAPES for m in MATERIALS],
                ids=[f"{s}-{m}" for s in SWEEP_SHAPES for m in MATERIALS])
def sweep_case(request):
    """Both packages' problems (float64), inputs made with numpy (u at
    strains of a few percent, a and w of unit size, a loaded history), and
    the reference's results: its jitted SoA residual E(u)
    (sharding._soa_E_residual), E's jvp along w, and the planes
    C[a D2 + b] = dP_a / dF_b of its `pk1_soa` by forward-mode derivatives
    at the port's F."""
    shape, name = request.param
    mesh, elev, subd, spans, clamp = SWEEP_SHAPES[shape]
    kw = dict(refine_spans=spans) if spans else {}
    ref = jsh.build_problem(mesh, elev, subd, _material(mimi, name), clamp, {1: FORCE},
                            rho_inf=0.5, dtype=jnp.float64, **kw)
    port = mt.build_problem(mesh, elev, subd, _material(mt, name), clamp, {1: FORCE},
                            rho_inf=0.5, device="cpu", **kw)
    assert port.dense is not None and port.sf is None
    assert tsw.tangent_storage(port.material) == "full"
    dim, E, nq = port.dim, port.n_el, port.n_q
    nd = port.dense["dN_t"].shape[0]
    rng = np.random.default_rng(11)
    data = {"u": 0.02 * rng.standard_normal((port.n_dof, dim)),
            "w": rng.standard_normal((port.n_dof, dim)),
            "a_el": rng.standard_normal((dim, nd, E)),
            "state": _history(rng, name, dim, (nq, E))}
    g, _ = tsh._gather_scatter(port)
    F = tsoa.add_diag(tsw.dense_grad(g(torch.tensor(data["u"])), port.dense["dN_t"]), 1.0)
    dN_t = jnp.transpose(ref.dN_dX, (2, 3, 1, 0))
    st = _jnp(data["state"])

    def E_res(u):
        return jsh._soa_E_residual(ref.material, DT, ref.dim, ref.n_dof, ref.conn, dN_t,
                                   ref.w_detJ.T, u, st)

    def planes(Fj):  # jvp along the dim^2 one-hot seeds e_b, batched
        seeds = jnp.eye(dim * dim).reshape(-1, dim, dim, 1, 1) * jnp.ones_like(Fj)[None]
        cols = jax.vmap(lambda s: jax.jvp(lambda x: ref.material.pk1_soa(x, st, DT),
                                          (Fj,), (s,))[1])(seeds)
        return jnp.stack([cols[b, a // dim, a % dim]
                          for a in range(dim * dim) for b in range(dim * dim)])

    y, jw, C = jax.jit(lambda u, w, Fj: (*jax.jvp(E_res, (u,), (w,)), planes(Fj)))(
        jnp.asarray(data["u"]), jnp.asarray(data["w"]), jnp.asarray(F.numpy()))
    data.update(y=np.asarray(y), jw=np.asarray(jw), C=np.asarray(C))
    return port, data


def _sweep_args(port, data):
    g, scatter = tsh._gather_scatter(port)
    u_el = g(torch.tensor(data["u"]))
    return (g, scatter, u_el, torch.tensor(data["a_el"]), _torch(data["state"]),
            port.dense["dN_t"], port.dense["N_t"], port.wdet_t, port.material)


def test_dense_full_residual_matches_reference_soa(sweep_case):
    port, data = sweep_case
    _, scatter, u_el, _, st, dN, N, wq, mat = _sweep_args(port, data)
    y = tsw.residual_dense(u_el, torch.zeros_like(u_el), st, dN, N, wq, mat, DT, RHO)
    assert _rel(scatter(y).numpy(), data["y"]) < 1e-10


def test_dense_full_assemble_matches_reference_planes(sweep_case):
    """Through the wrapper (the plain version on CPU tensors): the
    assemble's residual equals the residual sweep's, and its dim^4 planes
    are the reference's dP/dF."""
    port, data = sweep_case
    _, _, u_el, a_el, st, dN, N, wq, mat = _sweep_args(port, data)
    y, C = tsw.assemble_dense(u_el, a_el, st, dN, N, wq, mat, DT, RHO)
    assert C.shape == (tsw.n_planes("full", port.dim), port.n_q, port.n_el)
    assert C.dtype == torch.float64
    assert torch.equal(y, tsw.residual_dense_plain(u_el, a_el, st, dN, N, wq, mat, DT, RHO))
    assert _rel(C.numpy(), data["C"]) < 1e-10


def test_dense_full_matvec_matches_reference_jvp(sweep_case):
    """The planes applied by the matvec (fac0 = 1, rho = 0) give the
    reference's J w."""
    port, data = sweep_case
    g, scatter, u_el, a_el, st, dN, N, wq, mat = _sweep_args(port, data)
    _, C = tsw.assemble_dense_plain(u_el, a_el, st, dN, N, wq, mat, DT, RHO)
    jw = tsw.matvec_dense(g(torch.tensor(data["w"])), dN, N, wq, C, 0.0, 1.0, storage="full")
    assert _rel(scatter(jw).numpy(), data["jw"]) < 1e-10


# ---- (c) a 3D step ----------------------------------------------------------------------


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = {k: np.asarray(v) for k, v in carry["state"].items()}
    return out


def _max_rel_err(ref, got):
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["state"][k], got["state"][k]) for k in ref["state"]]
    return max(
        float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max())) for r, g in pairs
    )


def _golden_problems(name, f32=False):
    """The golden cantilever (balken, p=3, 4 elements) in both packages."""
    ref = jsh.build_problem(BALKEN, 2, 1, _material(mimi, name), CLAMP, {1: FORCE},
                            rho_inf=0.5, dtype=jnp.float32 if f32 else jnp.float64)
    port = mt.build_problem(BALKEN, 2, 1, _material(mt, name), CLAMP, {1: FORCE},
                            rho_inf=0.5, device="cpu", dtype=torch.float32 if f32 else None)
    return ref, port


def test_3d_two_patch_j2simo_step_matches_reference_soa():
    """J2Simo on dense 3D tables (two patches, 2 x 2^3 elements, yield
    stress 1): the 81 planes and the state through the dense sweeps, one
    step against the reference's `soa` step at 1e-8 (float64)."""
    kw = dict(refine_spans=2)
    ref = jsh.build_problem(TWO_CUBE, 1, 0, _material(mimi, "J2Simo", A=1.0), CLAMP_3D,
                            {1: -5.0}, rho_inf=0.5, dtype=jnp.float64, **kw)
    port = mt.build_problem(TWO_CUBE, 1, 0, _material(mt, "J2Simo", A=1.0), CLAMP_3D,
                            {1: -5.0}, rho_inf=0.5, device="cpu", **kw)
    assert port.dense is not None and port.n_el == 16
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    step_kw = dict(newton_iters=6, solver="cg", lin_rel_tol=1e-10)
    rc = jsh.make_step(ref, 0.05, residual_impl="soa", precond="fdm", **step_kw)(rc)
    pc = mt.make_step(port, 0.05, **step_kw)(pc)
    assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
    assert _max_rel_err(_ref_np(rc), carry_to_numpy(pc)) <= 1e-8
    assert float(pc["state"]["eqps"].max()) > 0.0


# ---- (d) planes, counters, conversion, builds and the unported branches ------------------


def test_full_plane_count_and_counters():
    assert (tsw.n_planes("full", 2), tsw.n_planes("full", 3)) == (16, 81)
    for dim, p in DENSE_SHAPES:
        sfx = "" if (dim, p) == (3, 2) else f"@{dim}d_p{p}"
        named = tsw.shape_counters("dense", tsw.dense_key(dim, p))
        for tag in ("simo", "log"):
            assert f"residual_dense[{tag}]{sfx}" in named
            assert f"assemble_dense[{tag},full]{sfx}" in named
        assert f"matvec_dense[full]{sfx}" in named
    assert tsw.material_counters("dense", "simo", "full", 2, 3) == (
        "residual_dense[simo]@2d_p3", "assemble_dense[simo,full]@2d_p3")
    assert tsw.material_counters("dense", "log", "full", 2, 2)[1] == "assemble_dense[log,full]@2d_p2"
    assert tsw.matvec_counter("dense", "full", 3, 2) == "matvec_dense[full]"


def test_2d_j2simo_problem_conversion():
    """problem_from_numpy of the reference's 2D J2Simo problem (conn gather
    on its dense tables) drives the same step as the port's own build
    (structured gather); carry_from_numpy carries the 2 x 2 state leaves."""
    ref, port = _golden_problems("J2Simo")
    conv = problem_from_numpy(ref, device="cpu")
    assert conv.dim == 2 and conv.dense is not None and conv.grid is None
    assert type(conv.material) is mt.J2Simo and conv.material.dim == 2
    for k in ("be_old", "F_old"):
        assert conv.state0[k].shape == (2, 2, 25, 4)
    assert material_from_reference(ref.material)._tolerance == port.material._tolerance
    carry0 = carry_from_numpy(_ref_np(jsh.initial_carry(ref)), device="cpu")
    assert carry0["state"]["be_old"].shape == (2, 2, 25, 4)
    out = [carry_to_numpy(mt.make_step(p, DT, lin_rel_tol=1e-10)(carry0)) for p in (port, conv)]
    assert _max_rel_err(out[0], out[1]) <= 1e-10
    back = carry_from_numpy(out[0], device="cpu")
    for k, v in out[0]["state"].items():
        assert np.array_equal(back["state"][k].numpy(), v), k


@pytest.mark.parametrize("name", MATERIALS)
def test_two_patch_finite_strain_problem_builds_its_step(name):
    """A finite-strain material on a two-patch 3D problem (dense tables)
    takes the full storage and builds its step, whose first Newton system
    is finite."""
    prob = mt.build_problem(TWO_CUBE, 1, 0, _material(mt, name), CLAMP_3D, {1: -5.0},
                            rho_inf=0.5, device="cpu", refine_spans=2)
    assert prob.dense is not None and tsw.tangent_storage(prob.material) == "full"
    step = mt.make_step(prob, 0.05, matvec_impl="dense", tangent_storage="full")
    ns = step.newton_system(mt.initial_carry(prob))
    w = torch.ones_like(ns["r"])
    assert torch.isfinite(ns["r"]).all() and torch.isfinite(ns["J_apply"](w)).all()


def test_initial_carry_takes_residual_impl():
    """initial_carry runs the residual sweep that `residual_impl` names, as
    make_step does: "torch" gives the default's carry on the CPU, "cuda"
    needs a problem on a CUDA device."""
    _, port = _golden_problems("J2Simo")
    a = mt.initial_carry(port)["a"]
    assert torch.equal(mt.initial_carry(port, residual_impl="torch")["a"], a)
    with pytest.raises(ValueError, match="needs a problem on a CUDA device"):
        mt.initial_carry(port, residual_impl="cuda")


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _meta_args(name, dim=2, p=3, n_q=25):
    """Consistent meta tensors of a dense problem and the material set up."""
    nd, E = (p + 1) ** dim, 8
    mat = _material(mt, name)
    mat.setup(dim)
    state = {k: _meta(dim, dim, n_q, E) if k in ("be_old", "F_old", "Fp_inv") else _meta(n_q, E)
             for k in tsw.FULL_KERNELS[name][2]}
    return _meta(dim, nd, E), state, _meta(nd, dim, n_q, E), _meta(nd, n_q, E), _meta(n_q, E), mat


@pytest.mark.parametrize("what", ["viscous", "bf16", "shape"])
def test_dense_full_unported_raise(what):
    """Nothing of dense + full stays unported: tables of any degree (here
    3D p = 4 with 216 points), the viscous sweeps and the bfloat16 block
    reach the wrappers' device check (ValueError on the meta tensors; the
    kernels of a shape are built at its first launch); a viscous J2Simo step on the golden cantilever's dense tables
    runs on the CPU, its first Newton residual changed by the viscous
    flux, and so does the bfloat16 block's Newton system."""
    if what == "shape":
        w, st, dN, N, wq, mat = _meta_args("J2Log", dim=3, p=4, n_q=216)
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.residual_dense(w, w, st, dN, N, wq, mat, DT, RHO)
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.matvec_dense(w, dN, N, wq, _meta(81, 216, 8), RHO, FAC0, storage="full")
        return
    w, st, dN, N, wq, mat = _meta_args("J2Simo")
    if what == "viscous":
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.residual_dense(w, w, st, dN, N, wq, mat, DT, RHO, v_el=w, mu_v=1.0)
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.matvec_dense(w, dN, N, wq, _meta(16, 25, 8), RHO, FAC0, fac1_mu_v=0.1,
                             storage="full")
        mats = [_material(mt, "J2Simo") for _ in range(2)]
        mats[0].viscosity = 1.0
        probs = [mt.build_problem(BALKEN, 2, 1, m, [(2, 0), (2, 1)], {1: -3.0}, rho_inf=0.5,
                                  device="cpu") for m in mats]
        assert probs[0].dense is not None
        carry = mt.initial_carry(probs[0])
        carry["v"] = torch.ones_like(carry["v"]) * probs[0].free
        steps = [mt.make_step(p, 0.05) for p in probs]
        r = [s.newton_system(carry)["r"] for s in steps]
        assert float((r[0] - r[1]).abs().max()) > 1e-6 * float(r[1].abs().max())
        out = steps[0](carry)
        assert out["newton"]["finite"] and out["newton"]["iters"] > 0
    else:
        # ported: the bfloat16 full block and the bfloat16 copies of dN and
        # N; the wrappers take them up to the device check, and a J2Simo
        # step's Newton system on the golden cantilever's dense tables runs
        # on the CPU, J w within one bfloat16 step of the float64 block's
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.assemble_dense(w, w, st, dN, N, wq, mat, DT, RHO, c_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
            tsw.matvec_dense(w, dN.to(torch.bfloat16), N.to(torch.bfloat16), wq,
                             _meta(16, 25, 8).to(torch.bfloat16), RHO, FAC0, storage="full")
        prob = mt.build_problem(BALKEN, 2, 1, _material(mt, "J2Simo"), [(2, 0), (2, 1)],
                                {1: -3.0}, rho_inf=0.5, device="cpu")
        carry = mt.initial_carry(prob)
        ns = [mt.make_step(prob, 0.05, matvec_dtype=d).newton_system(carry)
              for d in ("bf16", "f32")]
        w = torch.randn(ns[0]["r"].shape, generator=torch.Generator().manual_seed(5),
                        dtype=ns[0]["r"].dtype)
        jw = [n["J_apply"](w) for n in ns]
        assert torch.equal(ns[0]["r"], ns[1]["r"])
        assert 0.0 < float((jw[0] - jw[1]).abs().max()) <= 2.0**-7 * float(jw[1].abs().max())
