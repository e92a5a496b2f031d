"""The port's J2Linear (small-strain J2 with linear isotropic and kinematic
hardening, mimi_tpu_torch.J2Linear) against the reference package's, float64
on the CPU:

  - `cauchy_soa`, `pk1_soa` and `accumulate_soa` at 1e-12 on random F and a
    random plastic history (back stress included) in 2D and 3D, with
    elastic and plastic points;
  - the plain sweeps' 14 / 37 Cauchy-decomposition planes against the same
    planes from the reference's `jax.linearize` of `cauchy_soa` at 1e-12,
    and the closed-form D-hat of the CUDA point body (csrc/j2.cuh
    j2_linear_cauchy) against them at 1e-9, a back stress with a trace
    included;
  - 3 plastic steps of the 4^3 cube (sum-factorized tables) against the
    reference's `make_step(residual_impl="soa")` at 1e-8, from one carry,
    the back stress carried across (the dense 8^2 p = 3 cantilever's steps
    are in test_torch_j2linear_dense.py: one reference step compile per
    module);
  - the conversion, the counters, and the storage requests make_step
    refuses as the reference does (tests/test_pallas.py:537-554).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.fem import soa as jsoa
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    material_from_reference,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)
from torch_shapes import DENSE_SHAPES

DATA = os.path.join(os.path.dirname(__file__), "data")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
DT = 0.05
# the moduli of tests/test_materials.py:256-260 (test_j2_linear_radial_return)
SIGMA_Y, H_ISO, H_KIN = 10.0, 50.0, 30.0
A_PLASTIC = 1.0  # the steps' yield stress: 10 stays elastic on the 4^3 cube


def _material(pkg, dim=None, sigma_y=SIGMA_Y):
    mat = pkg.J2Linear()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    mat.sigma_y, mat.isotropic_hardening, mat.kinematic_hardening = sigma_y, H_ISO, H_KIN
    if dim is not None:
        mat.setup(dim)
    return mat


def _rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _near_eye(rng, dim, scale, n):
    return np.eye(dim)[:, :, None] + scale * rng.standard_normal((dim, dim, n))


def _sym(A):
    return 0.5 * (A + A.transpose(1, 0, 2))


def _dev(A):
    d = A.shape[0]
    return A - np.trace(A)[None, None] / d * np.eye(d)[:, :, None]


def _history(rng, dim, n, deviatoric=True):
    """A random plastic history: plastic strain and back stress symmetric
    (the back stress deviatoric, as accumulate_soa keeps it, unless asked
    otherwise), eqps up to 0.01 with every third point at 0."""
    beta = _sym(rng.standard_normal((dim, dim, n)))
    eqps = 0.01 * rng.random(n)
    eqps[::3] = 0.0
    return {
        "plastic_strain": _sym(_dev(2e-3 * rng.standard_normal((dim, dim, n)))),
        "beta": _dev(beta) if deviatoric else beta,
        "eqps": eqps,
    }


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def point_case(request):
    """(dim, F, state) on 120 points at strains of ~0.3%: elastic and
    plastic points."""
    dim = request.param
    rng = np.random.default_rng(21 + dim)
    return dim, _near_eye(rng, dim, 3e-3, 120), _history(rng, dim, 120)


def test_stress_and_state_match_reference(point_case):
    dim, F, state = point_case
    ref, port = _material(mimi, dim), _material(mt, dim)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    Fj, Ft = jnp.asarray(F), torch.tensor(F)
    assert _rel(port.cauchy_soa(Ft, ts, DT).numpy(), ref.cauchy_soa(Fj, js, DT)) < 1e-12
    assert _rel(port.pk1_soa(Ft, ts, DT).numpy(), ref.pk1_soa(Fj, js, DT)) < 1e-12
    new_ref = ref.accumulate_soa(Fj, js, DT)
    new = port.accumulate_soa(Ft, ts, DT)
    assert set(new) == set(new_ref) == {"plastic_strain", "beta", "eqps"}
    for k in new_ref:
        assert _rel(new[k].numpy(), new_ref[k]) < 1e-12, k
    yielded = np.asarray(new_ref["eqps"]) > state["eqps"]
    assert 0.1 < yielded.mean() < 0.9  # elastic and plastic points


def test_init_state_leaves():
    mat = _material(mt, 3)
    st = mat.init_state((5, 8), device="cpu")
    ref = _material(mimi, 3).init_state((5, 8))
    assert set(st) == set(ref)
    for k, v in st.items():
        assert tuple(v.shape) == tuple(ref[k].shape) and float(v.abs().max()) == 0.0


def _ref_planes(ref, F, state, dim):
    """The Cauchy-decomposition planes (cauchy_plane_layout) from the
    reference's jax.linearize of cauchy_soa, symmetrized as the plain
    version stores them."""
    lay = tsw.cauchy_plane_layout(dim)
    Fj = jnp.asarray(F)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    sig, lin = jax.linearize(lambda x: ref.cauchy_soa(x, js, DT), Fj)
    ns = len(lay["sym"])
    M = np.zeros((ns, ns, F.shape[-1]))
    for m, (i, j) in enumerate(lay["sym"]):
        col = np.asarray(lin(jnp.zeros_like(Fj).at[i, j].set(1.0).at[j, i].set(1.0)))
        for a, (ii, jj) in enumerate(lay["sym"]):
            M[a, m] = col[ii, jj] * (1.0 if i == j else 0.5)
    want = [0.5 * (M[a, b] + M[b, a]) for a in range(ns) for b in range(a, ns)]
    want += [np.asarray(sig)[i, j] for i, j in lay["sym"]]
    want += [np.asarray(jsoa.inv(Fj))[r, c] for r in range(dim) for c in range(dim)]
    want += [np.asarray(jsoa.det(Fj))]
    return np.stack(want)


def test_cauchy_planes_match_reference_linearize(point_case):
    dim, F, state = point_case
    ref, port = _material(mimi, dim), _material(mt, dim)
    assert tsw.tangent_storage(port) == "cauchy"
    ts = {k: torch.tensor(v) for k, v in state.items()}
    P, C = tsw.cauchy_tangent_planes(port, torch.tensor(F), ts, DT)
    assert C.shape == (tsw.n_planes("cauchy", dim), F.shape[-1])
    assert _rel(C.numpy(), _ref_planes(ref, F, state, dim)) < 1e-12
    js = {k: jnp.asarray(v) for k, v in state.items()}
    assert _rel(P.numpy(), ref.pk1_soa(jnp.asarray(F), js, DT)) < 1e-12


@pytest.mark.parametrize("deviatoric", [True, False], ids=["deviatoric", "with_trace"])
@pytest.mark.parametrize("dim", [2, 3])
def test_closed_form_tangent_matches_jvp_planes(dim, deviatoric):
    """The CUDA point body's D-hat,
      K 1(x)1 + 2G (1 - 3G dps/q) I_dev
        + 6G^2 (dps/q - 1/(3G + H_kin + H_iso)) sym(n (x) dev(n)),
    n = eta / |eta|, in float64 against the plain version's forward-mode
    planes: with a deviatoric back stress (dev(n) = n) and with one whose
    trace is not zero."""
    mat = _material(mt, dim)
    rng = np.random.default_rng(30 + dim)
    n_pt = 90
    F = torch.tensor(_near_eye(rng, dim, 3e-3, n_pt))
    st = {k: torch.tensor(v) for k, v in _history(rng, dim, n_pt, deviatoric).items()}
    _, C = tsw.cauchy_tangent_planes(mat, F, st, DT)
    eps = tsoa.add_diag(tsoa.sym(F) - st["plastic_strain"], -1.0)
    G, K = mat.G, mat.K
    eta = tsoa.dev(eps, 2.0 * G) - st["beta"]
    q = np.sqrt(1.5) * tsoa.fro_norm(eta)
    phi = q - (mat.sigma_y + mat.isotropic_hardening * st["eqps"])
    denom = 3.0 * G + mat.kinematic_hardening + mat.isotropic_hardening
    active = phi > 0
    assert 0.2 < float(active.double().mean()) < 0.9
    dps = torch.where(active, phi / denom, 0.0)
    c1 = torch.where(active, 2 * G * (1 - 3 * G * dps / q), 2 * G)
    c2 = torch.where(active, 6 * G * G * (dps / q - 1 / denom), 0.0)
    n = eta / tsoa.fro_norm(eta)
    dn = tsoa.dev(n)
    lay = tsw.cauchy_plane_layout(dim)
    sym = lay["sym"]
    scale = float(C[:lay["n_tri"]].abs().max())
    for a, (i, j) in enumerate(sym):
        for b in range(a, len(sym)):
            k, l = sym[b]
            dij, dkl = float(i == j), float(k == l)
            isym = 0.5 * (float(i == k and j == l) + float(i == l and j == k))
            M = (K * dij * dkl + c1 * (isym - dij * dkl / dim)
                 + c2 * 0.5 * (n[i, j] * dn[k, l] + dn[i, j] * n[k, l]))
            got = C[lay["tri"][(a, b)]]
            assert float((M - got).abs().max()) <= 1e-9 * scale, (a, b)


# ---- the steps ---------------------------------------------------------------------


def _ref_np(carry):
    out = {k: np.asarray(carry[k]) for k in ("u", "v", "a")}
    out["state"] = {k: np.asarray(v) for k, v in carry["state"].items()}
    return out


def _max_rel_err(ref, got):
    """max over u, v, a and the state leaves of max|got - ref| /
    max(1, max|ref|)."""
    pairs = [(ref[k], got[k]) for k in ("u", "v", "a")]
    pairs += [(ref["state"][k], got["state"][k]) for k in ref["state"]]
    return max(
        float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max())) for r, g in pairs
    )


@pytest.fixture(scope="module")
def cube():
    """The 4^3 cube (p = 2, face 1 clamped, body force -3) with J2Linear at
    yield stress A_PLASTIC in both packages, float64; the port's problem converted from the
    reference's (material_from_reference, problem_from_numpy)."""
    ref = jsh.build_problem(MESH, 1, 0, _material(mimi, sigma_y=A_PLASTIC),
                            [(1, 0), (1, 1), (1, 2)], {1: -3.0}, rho_inf=0.5,
                            dtype=jnp.float64, refine_spans=4)
    port = problem_from_numpy(ref, device="cpu")
    return ref, port


def test_conversion(cube):
    ref, port = cube
    mat = port.material
    assert type(mat) is mt.J2Linear and mat.dim == 3
    for k in ("sigma_y", "isotropic_hardening", "kinematic_hardening", "K", "G", "density"):
        assert getattr(mat, k) == float(getattr(ref.material, k)), k
    assert set(port.state0) == {"plastic_strain", "beta", "eqps"} == set(ref.state0)
    assert port.sf is not None
    back = carry_to_numpy(carry_from_numpy(_ref_np(jsh.initial_carry(ref)), device="cpu"))
    assert set(back["state"]) == set(ref.state0)


def test_three_cube_steps_match_reference_soa(cube):
    """Both packages from the reference's initial carry, 3 steps (FDM-GMRES
    at 1e-10): u, v, a and the state (plastic strain, back stress, eqps)
    agree to 1e-8 after every step; the material yields in the first step
    and the back stress moves."""
    ref, port = cube
    kw = dict(newton_iters=4, solver="cg", cg_iters=40, lin_rel_tol=1e-10)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = jsh.make_step(ref, DT, residual_impl="soa", precond="fdm", **kw)
    pstep = mt.make_step(port, DT, **kw)
    for i in range(3):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
        if i == 0:
            assert float(pc["state"]["eqps"].max()) > 0.0
    assert float(pc["state"]["beta"].abs().max()) > 0.0


def test_sym_storage_is_a_wrong_request(cube):
    """As the reference (tests/test_pallas.py:537-554): the symmetric
    storage on J2Linear, whose dP/dF is not major-symmetric, is a
    ValueError; the full storage, exact but weaker than the Cauchy one,
    runs, its Newton system the Cauchy storage's to rounding."""
    _, port = cube
    with pytest.raises(ValueError, match="major-symmetric"):
        mt.make_step(port, DT, solver="cg", tangent_storage="sym")
    carry = mt.initial_carry(port)
    ns = [mt.make_step(port, DT, tangent_storage=s).newton_system(carry)
          for s in ("full", "cauchy")]
    w = torch.tensor(np.random.default_rng(5).standard_normal(ns[0]["r"].shape))
    jw = [n["J_apply"](w) for n in ns]
    assert torch.equal(ns[0]["r"], ns[1]["r"])
    assert float((jw[0] - jw[1]).abs().max()) <= 1e-12 * float(jw[1].abs().max())


def test_counters_name_j2linear_instantiations():
    mat = _material(mt, 3)
    assert tsw.kernel_tag(mat) == "j2lin"
    for visc in (False, True):
        for bf16 in (False, True):
            for name in tsw.kernel_counters(mat, "sf", visc=visc, bf16=bf16):
                assert name in tsw.shape_counters("sf", (3, 4)), name
        for dim, p in DENSE_SHAPES:
            for name in tsw.kernel_counters(mat, "dense", dim, p, visc):
                assert name in tsw.shape_counters("dense", tsw.dense_key(dim, p)), name
    assert tsw.kernel_counters(mat, "sf") == ("residual_sf[j2lin]", "assemble_sf[j2lin,cauchy]")
    assert tsw.kernel_counters(mat, "dense", 2, 3, True) == (
        "residual_dense[j2lin,visc]@2d_p3", "assemble_dense[j2lin,cauchy,visc]@2d_p3")


def test_conversion_of_an_unknown_material_raises():
    class Other(mimi.J2Linear):
        pass

    with pytest.raises(NotImplementedError, match="Other is not ported"):
        material_from_reference(Other())
