"""The port's 2D dense-table path (mimi_tpu_torch) against the reference
package on the golden cantilever of tests/test_nonlinear_solid.py:
balken.mesh (the unit square, one patch) elevated by 2 to p=3 and
subdivided once (4 elements, 16 dofs and 25 points each), the golden's
J2 Johnson-Cook and neo-Hookean materials, boundary 2 clamped; and the 3D
dense tables with J2 (two-patch-cube.mesh), which take the same
Cauchy-decomposition storage.

  - soa.det / soa.inv on 2 x 2 tensors and the three materials' 2D stress,
    state update and tangent planes at 1e-12 (float64); the closed-form 2D
    J2 tangent (the CUDA point body's formula) against forward-mode planes
    at 1e-9;
  - the plain dense sweeps (the symmetric storage, 10 planes in 2D, and
    the Cauchy storage, 14 planes in 2D and 37 in 3D; p = 2 and 3 in 2D)
    against the reference's jitted SoA residual and its J w at 1e-10;
  - the 2D FDM apply on one patch and on two-patch-square.mesh at 1e-12;
  - 3 golden steps of each material against the reference's `soa` step at
    1e-8 (float64, both from one carry), 2 float32 J2 steps against its
    interpret-mode Pallas step at 1e-5 of max|u|, one 3D two-patch J2 step
    against `soa` at 1e-8, and all 10 steps of the golden neo-Hookean and
    J2 trajectories (tests/data/ref, from the original C++ code) at the
    golden test's own tolerance;
  - the conversion of a 2D reference problem, and the options and shapes
    that stay unported raising with their ROADMAP items.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.fem import soa as jsoa
from mimi_tpu.fem.space import FESpace as RefFESpace
from mimi_tpu.nurbs.mesh_io import read_mfem_nurbs_mesh as ref_read
from mimi_tpu.nurbs.topology import build_patch_from_mesh as ref_patch
from mimi_tpu.parallel import sharding as jsh
from mimi_tpu.solvers.fdm import make_fdm_apply as ref_fdm_apply
from mimi_tpu.solvers.fdm import make_fdm_apply_multipatch as ref_fdm_apply_mp

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.parallel import sharding as tsh
from mimi_tpu_torch.solvers.fdm import make_fdm_apply
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
TWO_SQUARE = os.path.join(DATA, "two-patch-square.mesh")
TWO_CUBE = os.path.join(DATA, "two-patch-cube.mesh")
CLAMP = [(2, 0), (2, 1)]
# the golden configurations (tests/test_nonlinear_solid.py): material,
# body force in y, time step
GOLDEN = {"j2": ("J2", -3.0, 0.5), "neohook": ("CompressibleOgdenNeoHookean", -5.0, 0.05)}
RHO, FAC0 = 1.0, 0.01


def _material(pkg, name):
    """The golden's material `name` of package `pkg`: E 2100, nu 0.3,
    density 1; for the J2 family the Johnson-Cook data of
    tests/test_nonlinear_solid.py:26-42."""
    mat = getattr(pkg, name)()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    if name in ("J2", "J2Simo", "J2Log"):
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


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _near_eye(rng, scale, shape):
    d = shape[0]
    return np.eye(d).reshape(d, d, *([1] * (len(shape) - 2))) + scale * rng.standard_normal(shape)


def _j2_state(rng, n):
    """A J2 state over n points: plastic strain, eqps and temperature of a
    loaded history (so the trial stress of _near_eye(0.05) yields at most
    points)."""
    ps = 0.01 * rng.standard_normal((2, 2, n))
    ps = 0.5 * (ps + ps.transpose(1, 0, 2))
    ps -= 0.5 * np.trace(ps)[None, None] * np.eye(2)[:, :, None]
    return {"plastic_strain": ps, "eqps": 0.02 * rng.random(n),
            "temperature": 20.0 + 100.0 * rng.random(n)}


# ---- (a) small-tensor algebra and the materials in 2D ----------------------------


def test_soa_det_inv_2x2_match_reference():
    A = _near_eye(np.random.default_rng(1), 0.3, (2, 2, 50))
    d_ref, i_ref = np.asarray(jsoa.det(jnp.asarray(A))), np.asarray(jsoa.inv(jnp.asarray(A)))
    At = torch.tensor(A)
    assert _rel(tsoa.det(At).numpy(), d_ref) < 1e-12
    assert _rel(tsoa.inv(At).numpy(), i_ref) < 1e-12
    with pytest.raises(NotImplementedError):
        tsoa.det(torch.zeros(4, 4, 2))


def _both(name):
    ref, port = _material(mimi, name), _material(mt, name)
    ref.setup(2)
    port.setup(2)
    return ref, port


@pytest.mark.parametrize("name", ["CompressibleOgdenNeoHookean", "StVenantKirchhoff", "J2"])
def test_2d_stress_matches_reference(name):
    """P in 2D (a true 2 x 2 tensor, the deviator over trace / 2) at 1e-12;
    for J2 on a plastic state, where most points yield."""
    ref, port = _both(name)
    rng = np.random.default_rng(2)
    F = _near_eye(rng, 0.05, (2, 2, 80))
    st = _j2_state(rng, 80) if name == "J2" else None
    P_ref = ref.pk1_soa(jnp.asarray(F), None if st is None else
                        {k: jnp.asarray(v) for k, v in st.items()}, 0.5)
    P = port.pk1_soa(torch.tensor(F), None if st is None else
                     {k: torch.tensor(v) for k, v in st.items()}, 0.5)
    assert _rel(P.numpy(), P_ref) < 1e-12
    if name == "J2":
        active = port._return_map(torch.tensor(F), {k: torch.tensor(v) for k, v in st.items()},
                                  0.5)[4]
        assert float(active.double().mean()) > 0.5


def test_2d_j2_state_update_matches_reference():
    ref, port = _both("J2")
    rng = np.random.default_rng(3)
    F = _near_eye(rng, 0.05, (2, 2, 80))
    st = _j2_state(rng, 80)
    new_ref = ref.accumulate_soa(jnp.asarray(F), {k: jnp.asarray(v) for k, v in st.items()}, 0.5)
    new = port.accumulate_soa(torch.tensor(F), {k: torch.tensor(v) for k, v in st.items()}, 0.5)
    for k, v in new_ref.items():
        assert new[k].shape == v.shape
        assert _rel(new[k].numpy(), v) < 1e-12, k
    assert float(new["eqps"].max()) > float(st["eqps"].max())


@pytest.mark.parametrize("name", ["CompressibleOgdenNeoHookean", "StVenantKirchhoff", "J2"])
def test_2d_tangent_planes_match_reference(name):
    """The plain assemble's planes (the 10 symmetric ones of dP/dF for the
    hyperelastic materials, the 14 Cauchy-decomposition ones for J2) at
    1e-12 against the same planes from the reference material's
    jax.linearize; for the hyperelastic materials also the closed-form
    tangent_soa that the CUDA kernels evaluate."""
    ref, port = _both(name)
    rng = np.random.default_rng(4)
    F = _near_eye(rng, 0.05, (2, 2, 40))
    st = _j2_state(rng, 40) if name == "J2" else None
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: torch.tensor(v) for k, v in st.items()}
    storage = tsw.tangent_storage(port)
    assert tsw.n_planes(storage, 2) == (14 if name == "J2" else 10)
    P, C = tsw.tangent_planes(storage)(port, torch.tensor(F), tst, 0.5)
    assert C.shape == (tsw.n_planes(storage, 2), 40)
    Fj = jnp.asarray(F)
    if storage == "cauchy":
        lay = tsw.cauchy_plane_layout(2)
        sig, lin = jax.linearize(lambda x: ref.cauchy_soa(x, jst, 0.5), Fj)
        M = np.zeros((3, 3, 40))
        for m, (i, j) in enumerate(lay["sym"]):
            col = np.asarray(lin(jnp.zeros_like(Fj).at[i, j].set(1.0).at[j, i].set(1.0)))
            for a, (ii, jj) in enumerate(lay["sym"]):
                M[a, m] = col[ii, jj] * (1.0 if i == j else 0.5)
        want = [0.5 * (M[a, b] + M[b, a]) for a in range(3) for b in range(a, 3)]
        want += [np.asarray(sig)[i, j] for i, j in lay["sym"]]
        want += [np.asarray(jsoa.inv(Fj))[r, c] for r in range(2) for c in range(2)]
        want += [np.asarray(jsoa.det(Fj))]
        assert _rel(C.numpy(), np.stack(want)) < 1e-12
    else:
        _, lin = jax.linearize(lambda x: ref.pk1_soa(x, None, 0.5), Fj)
        cols = [np.asarray(lin(jnp.zeros_like(Fj).at[b // 2, b % 2].set(1.0))) for b in range(4)]
        full = np.stack([np.stack([cols[b][a // 2, a % 2] for b in range(4)]) for a in range(4)])
        want = np.stack([0.5 * (full[a, b] + full[b, a]) for a in range(4) for b in range(a, 4)])
        assert _rel(C.numpy(), want) < 1e-12
        T = port.tangent_soa(torch.tensor(F)).reshape(4, 4, -1).numpy()
        assert _rel(T, full) < 1e-12
    assert _rel(P.numpy(), ref.pk1_soa(Fj, jst, 0.5)) < 1e-12


def test_2d_closed_form_j2_tangent_matches_jvp_planes():
    """The CUDA J2 point body (j2.cuh j2_cauchy<2>) writes D-hat from
    K 1(x)1 + 2G(1 - 3G d/q) I_dev + 6G^2 (d/q - 1/(3G + h')) n(x)n with
    I_dev = I_sym - 1(x)1 / 2; that formula in float64 against the plain
    version's forward-mode planes."""
    _, mat = _both("J2")
    rng = np.random.default_rng(5)
    F = torch.tensor(_near_eye(rng, 0.05, (2, 2, 60)))
    st = {k: torch.tensor(v) for k, v in _j2_state(rng, 60).items()}
    _, C = tsw.cauchy_tangent_planes(mat, F, st, 0.5)
    p, s, q, delta, active, _ = mat._return_map(F, st, 0.5)
    assert float(active.double().mean()) > 0.5
    G, K = mat.G, mat.K
    thermo = mat.hardening.thermo_contribution(st["temperature"])
    _, fprime = mat._residual_grad(delta, q, st["eqps"], thermo, 0.5, 3 * G)
    h = -fprime - 3 * G
    c1 = torch.where(active, 2 * G * (1 - 3 * G * delta / q), 2 * G)
    c2 = torch.where(active, 6 * G * G * (delta / q - 1 / (3 * G + h)), 0.0)
    n = s / tsoa.fro_norm(s)
    lay = tsw.cauchy_plane_layout(2)
    sym = lay["sym"]
    for a, (i, j) in enumerate(sym):
        for b in range(a, 3):
            k, l = sym[b]
            dij, dkl = float(i == j), float(k == l)
            isym = 0.5 * (float(i == k and j == l) + float(i == l and j == k))
            M = K * dij * dkl + c1 * (isym - dij * dkl / 2) + c2 * n[i, j] * n[k, l]
            got = C[lay["tri"][(a, b)]]
            assert float((M - got).abs().max()) <= 1e-9 * float(C[:6].abs().max())


# ---- (b) the plain dense sweeps against the reference's SoA residual ---------------


SWEEP_CASES = {  # mesh, elevate, subdivide, refine_spans, material, dirichlet
    "2d_p3_j2": (BALKEN, 2, 1, None, "J2", CLAMP),
    "2d_p3_nh": (BALKEN, 2, 1, None, "CompressibleOgdenNeoHookean", CLAMP),
    "2d_p3_stvk": (BALKEN, 2, 1, None, "StVenantKirchhoff", CLAMP),
    "2d_p2_j2": (BALKEN, 1, 2, None, "J2", CLAMP),
    "2d_p2_nh": (BALKEN, 1, 2, None, "CompressibleOgdenNeoHookean", CLAMP),
    "3d_p2_j2": (TWO_CUBE, 1, 0, 2, "J2", [(0, 0), (0, 1), (0, 2)]),
}


@pytest.fixture(scope="module", params=list(SWEEP_CASES))
def sweep_case(request):
    """Both packages' problems (float64) and element inputs made with
    numpy: u at strains of up to 8% (past yield), a and w of unit size, a
    plastic J2 history."""
    mesh, elev, subd, spans, name, clamp = SWEEP_CASES[request.param]
    kw = dict(refine_spans=spans) if spans else {}
    ref = jsh.build_problem(mesh, elev, subd, _material(mimi, name), clamp, {1: -3.0},
                            rho_inf=0.5, dtype=jnp.float64, **kw)
    port = mt.build_problem(mesh, elev, subd, _material(mt, name), clamp, {1: -3.0},
                            rho_inf=0.5, device="cpu", **kw)
    assert port.dense is not None and port.sf is None
    dim, E, nq = port.dim, port.n_el, port.n_q
    nd = port.dense["dN_t"].shape[0]
    rng = np.random.default_rng(11)
    u = 0.02 * rng.standard_normal((port.n_dof, dim))
    st = None
    if name == "J2":
        ps = 0.005 * rng.standard_normal((dim, dim, nq, E))
        st = {"plastic_strain": 0.5 * (ps + ps.transpose(1, 0, 2, 3)),
              "eqps": 0.02 * rng.random((nq, E)),
              "temperature": 20.0 + 100.0 * rng.random((nq, E))}
    data = {"u": u, "w": rng.standard_normal((port.n_dof, dim)),
            "a_el": rng.standard_normal((dim, nd, E)), "state": st}
    return request.param, ref, port, data


def _port_args(port, data):
    g, scatter = tsh._gather_scatter(port)
    st = None if data["state"] is None else {k: torch.tensor(v) for k, v in data["state"].items()}
    return g, scatter, st


@pytest.fixture(scope="module")
def ref_soa(sweep_case):
    """The reference's jitted SoA residual E(u) (sharding._soa_E_residual)
    and its jvp along w."""
    _, ref, _, data = sweep_case
    dN_t = jnp.transpose(ref.dN_dX, (2, 3, 1, 0))
    st = None if data["state"] is None else {k: jnp.asarray(v) for k, v in data["state"].items()}

    def E(u):
        return jsh._soa_E_residual(ref.material, 0.5, ref.dim, ref.n_dof, ref.conn, dN_t,
                                   ref.w_detJ.T, u, st)

    y, jw = jax.jit(lambda u, w: jax.jvp(E, (u,), (w,)))(jnp.asarray(data["u"]),
                                                        jnp.asarray(data["w"]))
    return np.asarray(y), np.asarray(jw)


def test_dense_residual_matches_reference_soa(sweep_case, ref_soa):
    _, _, port, data = sweep_case
    g, scatter, st = _port_args(port, data)
    u_el = g(torch.tensor(data["u"]))
    y = tsw.residual_dense_plain(u_el, torch.zeros_like(u_el), st, port.dense["dN_t"],
                                 port.dense["N_t"], port.wdet_t, port.material, 0.5, RHO)
    assert _rel(scatter(y).numpy(), ref_soa[0]) < 1e-10


def test_dense_assemble_and_matvec_match_reference_soa(sweep_case, ref_soa):
    """The assemble's residual equals the residual sweep's; its planes
    (storage and count of the material and dimension), applied by the
    matvec with fac0 = 1 and rho = 0, give the reference's J w."""
    key, _, port, data = sweep_case
    g, scatter, st = _port_args(port, data)
    dN, N, wq, mat = port.dense["dN_t"], port.dense["N_t"], port.wdet_t, port.material
    u_el = g(torch.tensor(data["u"]))
    a_el = torch.tensor(data["a_el"])
    y, C = tsw.assemble_dense_plain(u_el, a_el, st, dN, N, wq, mat, 0.5, RHO)
    y_res = tsw.residual_dense_plain(u_el, a_el, st, dN, N, wq, mat, 0.5, RHO)
    assert torch.equal(y, y_res)
    storage = tsw.tangent_storage(mat)
    assert storage == ("cauchy" if key.endswith("j2") else "sym")
    assert C.shape == (tsw.n_planes(storage, port.dim), port.n_q, port.n_el)
    jw = tsw.matvec_dense_plain(g(torch.tensor(data["w"])), dN, N, wq, C, 0.0, 1.0,
                                storage=storage)
    assert _rel(scatter(jw).numpy(), ref_soa[1]) < 1e-10


def test_dense_matvec_mass_term(sweep_case):
    """The matvec's rho N w term is the plain mass apply: matvec at fac0 =
    0 equals dense_scatter of rho N w."""
    _, _, port, data = sweep_case
    g, _, st = _port_args(port, data)
    dN, N, wq, mat = port.dense["dN_t"], port.dense["N_t"], port.wdet_t, port.material
    u_el = g(torch.tensor(data["u"]))
    _, C = tsw.assemble_dense_plain(u_el, u_el, st, dN, N, wq, mat, 0.5, RHO)
    w_el = g(torch.tensor(data["w"]))
    y = tsw.matvec_dense_plain(w_el, dN, N, wq, C, RHO, 0.0,
                               storage=tsw.tangent_storage(mat))
    m = tsw.dense_scatter(None, RHO * tsw.dense_value(w_el, N), dN, N, wq)
    assert _rel(y.numpy(), m.numpy()) < 1e-12


# ---- (c) the 2D FDM preconditioner -----------------------------------------------


def test_2d_fdm_apply_matches_reference():
    ref = jsh.build_problem(BALKEN, 2, 1, _material(mimi, "J2"), CLAMP, {1: -3.0},
                            rho_inf=0.5, dtype=jnp.float64)
    port = mt.build_problem(BALKEN, 2, 1, _material(mt, "J2"), CLAMP, {1: -3.0},
                            rho_inf=0.5, device="cpu")
    assert len(port.fdm["nc"]) == 2
    for c in range(2):
        for ax in range(2):
            assert _rel(port.fdm["Ve"][c][ax], ref.fdm["Ve"][c][ax]) < 1e-12
    v = np.random.default_rng(6).standard_normal(port.n_dof * 2)
    fac0, fac1 = 0.0625, 0.5
    y_ref = ref_fdm_apply(ref.fdm, fac0, fac1, jnp.float64)(jnp.asarray(v))
    y = make_fdm_apply(port.fdm, fac0, fac1, torch.float64, "cpu")(torch.tensor(v))
    assert _rel(y.numpy(), y_ref) < 1e-12


def test_2d_multipatch_fdm_apply_matches_reference():
    mat = lambda pkg: _material(pkg, "CompressibleOgdenNeoHookean")  # noqa: E731
    ref = jsh.build_problem(TWO_SQUARE, 1, 1, mat(mimi), [(0, 0), (0, 1)], {1: -5.0},
                            rho_inf=0.5, dtype=jnp.float64)
    port = mt.build_problem(TWO_SQUARE, 1, 1, mat(mt), [(0, 0), (0, 1)], {1: -5.0},
                            rho_inf=0.5, device="cpu")
    assert "mp" in port.fdm and len(port.fdm["mp"]) == 2 and port.dim == 2
    assert port.dense is not None and port.grid is None
    v = np.random.default_rng(7).standard_normal(port.n_dof * 2)
    y_ref = ref_fdm_apply_mp(ref.fdm, 1e-3, 0.02, jnp.float64)(jnp.asarray(v))
    y = make_fdm_apply(port.fdm, 1e-3, 0.02, torch.float64, "cpu")(torch.tensor(v))
    assert _rel(y.numpy(), y_ref) < 1e-12


# ---- (d) steps -------------------------------------------------------------------


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = (None if carry["state"] is None
                    else {k: np.asarray(v) for k, v in carry["state"].items()})
    return out


def _max_rel_err(ref, got):
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    if ref["state"] is not None:
        pairs += [(ref["state"][k], got["state"][k]) for k in ref["state"]]
    return max(
        float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max())) for r, g in pairs
    )


def _golden_problems(key, dtype=None):
    name, force, _ = GOLDEN[key]
    ref = jsh.build_problem(BALKEN, 2, 1, _material(mimi, name), CLAMP, {1: force},
                            rho_inf=0.5, dtype=jnp.float64 if dtype is None else dtype)
    port = mt.build_problem(BALKEN, 2, 1, _material(mt, name), CLAMP, {1: force},
                            rho_inf=0.5, device="cpu",
                            dtype=None if dtype is None else torch.float32)
    return ref, port


@pytest.mark.parametrize("key", list(GOLDEN))
def test_three_golden_steps_match_reference_soa(key):
    """Both packages from the reference's initial carry, 3 steps of the
    golden cantilever (float64, FDM-GMRES): u, v, a and the J2 state agree
    to 1e-8 after every step; J2 yields by the second."""
    ref, port = _golden_problems(key)
    dt = GOLDEN[key][2]
    assert (port.n_el, port.n_q, port.dense["dN_t"].shape[0]) == (4, 25, 16)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    kw = dict(newton_iters=10, solver="cg", lin_rel_tol=1e-10)
    rstep = jsh.make_step(ref, dt, residual_impl="soa", precond="fdm", **kw)
    pstep = mt.make_step(port, dt, **kw)
    for i in range(3):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    if key == "j2":
        assert float(pc["state"]["eqps"].max()) > 0.01
    assert float(pc["u"].abs().max()) > 0.05  # the beam sags


def test_two_float32_golden_steps_match_reference_pallas():
    """2 float32 steps of the golden J2 cantilever against the reference's
    Pallas engine (its dense-table kernels in interpret mode), both from
    the reference's initial carry, at 1e-5 of max|u|."""
    ref, port = _golden_problems("j2", jnp.float32)
    dt = GOLDEN["j2"][2]
    kw = dict(newton_iters=10, solver="cg", lin_rel_tol=1e-5)
    rstep = jsh.make_step(ref, dt, residual_impl="pallas", precond="fdm", **kw)
    pstep = mt.make_step(port, dt, **kw)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu", dtype=torch.float32)
    for i in range(2):
        rc, pc = rstep(rc), pstep(pc)
        u_ref, u = np.asarray(rc["u"]), pc["u"].numpy()
        scale = float(np.abs(u_ref).max())
        assert float(np.abs(u - u_ref).max()) <= 1e-5 * scale, (i, np.abs(u - u_ref).max())
    assert float(pc["state"]["eqps"].max()) > 0.0


def test_3d_two_patch_j2_step_matches_reference_soa():
    """J2 on dense 3D tables (two patches, 2 x 2^3 elements): the Cauchy
    storage and the plastic state through the dense sweeps, one step
    against the reference's `soa` step at 1e-8 (float64)."""
    kw = dict(refine_spans=2)
    clamp = [(0, 0), (0, 1), (0, 2)]
    mats = []
    for pkg in (mimi, mt):
        mats.append(_material(pkg, "J2"))
        mats[-1].hardening.A = 1.0  # yields in the first step
    ref = jsh.build_problem(TWO_CUBE, 1, 0, mats[0], clamp, {1: -5.0}, rho_inf=0.5,
                            dtype=jnp.float64, **kw)
    port = mt.build_problem(TWO_CUBE, 1, 0, mats[1], clamp, {1: -5.0}, rho_inf=0.5,
                            device="cpu", **kw)
    assert port.dense is not None and port.n_el == 16
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    step_kw = dict(newton_iters=6, solver="cg", lin_rel_tol=1e-10)
    rc = jsh.make_step(ref, 0.05, residual_impl="soa", precond="fdm", **step_kw)(rc)
    pc = mt.make_step(port, 0.05, **step_kw)(pc)
    assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
    assert _max_rel_err(_ref_np(rc), carry_to_numpy(pc)) <= 1e-8
    assert float(pc["state"]["eqps"].max()) > 0.0


@pytest.mark.parametrize("key", list(GOLDEN))
def test_golden_trajectory(key):
    """The port's plain float64 step through all 10 steps of the golden
    trajectory tests/data/ref/{key}_h1_p2 (the original C++ code's), with
    the golden's Newton settings (rel 1e-12, abs 1e-8, 10 iterations), at
    the golden test's tolerance.  The compiled core's u is lexicographic;
    the golden is in the session's MFEM order: u[inv_perm], with the
    reference FESpace's own permutation."""
    name, force, dt = GOLDEN[key]
    prob = mt.build_problem(BALKEN, 2, 1, _material(mt, name), CLAMP, {1: force},
                            rho_inf=0.5, device="cpu")
    patch, topo, _ = ref_patch(ref_read(BALKEN))
    patch.elevate_degrees(2)
    patch.uniform_refine()
    perm = RefFESpace(patch, topo).inv_perm
    step = mt.make_step(prob, dt, newton_iters=10, rel_tol=1e-12, abs_tol=1e-8,
                        lin_rel_tol=1e-12)
    carry = mt.initial_carry(prob)
    for i in range(10):
        carry = step(carry)
        x = carry["u"].numpy()[perm].ravel()
        golden = np.genfromtxt(os.path.join(DATA, "ref", f"{key}_h1_p2", f"x_{i}.txt"))
        assert np.allclose(x, golden), f"step {i}: max err {np.abs(x - golden).max()}"


# ---- (e) conversion, launch counters, unported branches -----------------------------


def test_2d_problem_conversion():
    """problem_from_numpy of the reference's 2D J2 problem (conn gather on
    its dense tables) drives the same step as the port's own build
    (structured gather); carry_from_numpy carries the 2 x 2 state leaves."""
    ref, port = _golden_problems("j2")
    conv = problem_from_numpy(ref, device="cpu")
    assert conv.dim == 2 and conv.dense is not None and conv.grid is None
    assert conv.dense["dN_t"].shape == (16, 2, 25, 4)
    assert conv.state0["plastic_strain"].shape == (2, 2, 25, 4)
    assert type(conv.material) is mt.J2 and conv.material.dim == 2
    assert material_from_reference(ref.material).G == port.material.G
    carry0 = carry_from_numpy(_ref_np(jsh.initial_carry(ref)), device="cpu")
    assert carry0["state"]["plastic_strain"].shape == (2, 2, 25, 4)
    out = [carry_to_numpy(mt.make_step(p, 0.5, lin_rel_tol=1e-10)(carry0)) for p in (port, conv)]
    assert _max_rel_err(out[0], out[1]) <= 1e-10
    back = carry_from_numpy(out[0], device="cpu")
    for k, v in out[0]["state"].items():
        assert np.array_equal(back["state"][k].numpy(), v), k


def test_2d_launch_counters():
    for dim, p in DENSE_SHAPES:
        sfx = "" if (dim, p) == (3, 2) else f"@{dim}d_p{p}"
        named = tsw.shape_counters("dense", tsw.dense_key(dim, p))
        for name in (f"residual_dense[j2]{sfx}", f"assemble_dense[j2,cauchy]{sfx}",
                     f"matvec_dense[cauchy]{sfx}", f"residual_dense{sfx}",
                     f"assemble_dense[sym]{sfx}", f"matvec_dense[sym]{sfx}",
                     f"residual_dense[stvk]{sfx}", f"assemble_dense[stvk,sym]{sfx}"):
            assert name in named
    assert tsw.material_counters("dense", "j2", "cauchy", 2, 3) == (
        "residual_dense[j2]@2d_p3", "assemble_dense[j2,cauchy]@2d_p3")
    assert tsw.matvec_counter("dense", "sym", 2, 2) == "matvec_dense[sym]@2d_p2"


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize(
    "dim, p, n_q",
    [(2, 4, 36), (3, 3, 216), (2, 3, 16), (3, 4, 216)],
    ids=["2d_p4", "3d_p3", "2d_p3_4pts", "3d_p4"],
)
def test_uninstantiated_dense_shape_raises(dim, p, n_q):
    """Consistent dense tables of a (dim, p) or point count outside the
    default shapes no longer raise NotImplementedError: the kernels of a
    shape are built at its first launch (ops/build.py), so the wrappers
    take them up to the device check, which raises ValueError on the meta
    tensors (no device is asked)."""
    nd, E = (p + 1) ** dim, 8
    dN, N, wq = _meta(nd, dim, n_q, E), _meta(nd, n_q, E), _meta(n_q, E)
    w = _meta(dim, nd, E)
    mat = _material(mt, "CompressibleOgdenNeoHookean")
    mat.setup(dim)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw.residual_dense(w, w, None, dN, N, wq, mat, 0.5, RHO)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw.matvec_dense(w, dN, N, wq, _meta(tsw.n_planes("sym", dim), n_q, E), RHO, FAC0)


def test_inconsistent_dense_shape_is_a_value_error():
    """Shapes that do not fit together stay ValueError; an instantiated
    shape on a tensor that is not on a CUDA device too."""
    E = 8
    dN, N, wq = _meta(16, 2, 25, E), _meta(16, 25, E), _meta(25, E)
    mat = _material(mt, "CompressibleOgdenNeoHookean")
    mat.setup(2)
    for w, dN_ in ((_meta(2, 9, E), dN), (_meta(2, 15, E), _meta(15, 2, 25, E)),
                   (_meta(2, 16, E), dN)):
        with pytest.raises(ValueError):
            tsw.residual_dense(w, w, None, dN_, N, wq, mat, 0.5, RHO)


@pytest.mark.parametrize("n_g, p1", [(3, 3), (6, 4), (6, 5)], ids=["p2_3pts", "p3", "p4"])
def test_uninstantiated_sf_shape_raises(n_g, p1):
    """The sf sweeps' _check_common: consistent tables of any degree or
    Gauss count (here p = 2 at 3 points per axis, p = 3 at 6, p = 4) pass
    up to the device check (ValueError on the meta tensors: the kernels of
    a shape are built at its first launch); inconsistent ones raise
    ValueError before it."""
    E = 8
    tabs = [_meta(n_g, p1, E) for _ in range(6)]
    jinv, wq = _meta(3, 3, n_g**3, E), _meta(n_g**3, E)
    w = _meta(3, p1**3, E)
    with pytest.raises(ValueError, match="CUDA sweep called on a meta tensor"):
        tsw._check_common([("w_el", w)], tabs, jinv, wq)
    with pytest.raises(ValueError, match="required"):
        tsw._check_common([("w_el", _meta(3, p1**3 + 1, E))], tabs, jinv, wq)
    with pytest.raises(ValueError, match="required"):
        tsw._check_common([("w_el", w)], tabs, _meta(3, 3, n_g**3 + 1, E), wq)
