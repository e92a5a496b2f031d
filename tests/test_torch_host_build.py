"""The port's host build (mimi_tpu_torch build_problem and its numpy/native
tables) against the reference package's on cube-nurbs.mesh (p=2, 4^3
elements), the port's import hygiene, and the options it refuses."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import native
from mimi_tpu_torch.fem.space import FESpace, _tensor_basis_numpy, domain_dim_tables
from mimi_tpu_torch.nurbs.mesh_io import read_mfem_nurbs_mesh
from mimi_tpu_torch.nurbs.topology import build_patch_from_mesh
from mimi_tpu_torch.utils.convert import problem_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "tests", "data", "cube-nurbs.mesh")
BUILD = dict(
    elevate=1,
    subdivide=0,
    dirichlet=[(1, 0), (1, 1), (1, 2)],
    body_force={1: -3.0},
    rho_inf=0.5,
    refine_spans=4,
)


def _material(pkg):
    mat = pkg.J2()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.set_young_poisson(2100.0, 0.3)
    h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 70.0, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


@pytest.fixture(scope="module")
def problems():
    ref = jsh.build_problem(MESH, material=_material(mimi), dtype=jnp.float64, **BUILD)
    port = mt.build_problem(MESH, material=_material(mt), dtype=torch.float64, device="cpu", **BUILD)
    return ref, port


def _port_patch():
    patch, topo, _ = build_patch_from_mesh(read_mfem_nurbs_mesh(MESH))
    patch.elevate_degrees(1)
    patch.refine_to(4)
    return patch, topo


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_exact_fields_match(problems):
    ref, port = problems
    assert (port.n_dof, port.dim, port.n_el, port.n_q) == (
        ref.n_dof, ref.dim, ref.n_el, ref.n_q,
    )
    assert np.array_equal(port.conn, ref.conn)
    assert np.array_equal(port.free.numpy(), ref.free)
    assert port.facs == ref.facs
    assert port.grid == ref.grid


@pytest.mark.parametrize(
    "field", ["w_detJ", "rhs", "jinv", "B0", "D0", "B1", "D1", "B2", "D2"]
)
def test_float_fields_match(problems, field):
    ref, port = problems
    names = ["B0", "D0", "B1", "D1", "B2", "D2"]
    if field == "w_detJ":
        _close(port.wdet_t.numpy().T, ref.w_detJ)
    elif field == "rhs":
        _close(port.rhs.numpy(), ref.rhs)
    elif field == "jinv":
        _close(port.sf["jinv"].numpy(), ref.sf["jinv"])
    else:
        i = names.index(field)
        _close(port.sf["tables"][i].numpy(), ref.sf["tables"][i])


def test_fdm_eigenbases_match(problems):
    ref, port = problems
    for c in range(3):
        for ax in range(3):
            _close(port.fdm["Ve"][c][ax], ref.fdm["Ve"][c][ax])
            _close(port.fdm["lam"][c][ax], ref.fdm["lam"][c][ax])
    assert np.array_equal(port.fdm["alpha"], ref.fdm["alpha"])


def test_state0_matches(problems):
    ref, port = problems
    for k, v in ref.state0.items():
        assert np.array_equal(port.state0[k].numpy(), np.asarray(v))


def test_dense_domain_tables_match(problems):
    """The dense tables the sum-factorized path does not read (basis N,
    w det J) still match the reference package's."""
    ref, _ = problems
    patch, topo = _port_patch()
    tabs = FESpace(patch, topo).domain_tables()
    assert np.array_equal(tabs.conn, ref.conn)
    _close(tabs.N, ref.N)
    _close(tabs.dN_dX, ref.dN_dX)
    _close(tabs.w_detJ, ref.w_detJ)


@pytest.mark.parametrize("order", [-1, 3], ids=["default_order", "order3"])
def test_boundary_tables_match(order):
    """The side tables contact reads, field by field, against the
    reference package's FESpace.boundary_tables."""
    from mimi_tpu.fem.space import FESpace as RefFESpace
    from mimi_tpu.nurbs.mesh_io import read_mfem_nurbs_mesh as ref_read
    from mimi_tpu.nurbs.topology import build_patch_from_mesh as ref_patch

    rpatch, rtopo, _ = ref_patch(ref_read(MESH))
    rpatch.elevate_degrees(1)
    rpatch.refine_to(4)
    ref = RefFESpace(rpatch, rtopo).boundary_tables(order)
    patch, topo = _port_patch()
    got = FESpace(patch, topo).boundary_tables(order)
    for k in ("conn", "attr", "normal_sign"):
        assert np.array_equal(getattr(got, k), getattr(ref, k)), k
    for k in ("N", "dN_dxi", "wq", "detJ_ref"):
        _close(getattr(got, k), getattr(ref, k))


def test_native_tables_match_numpy():
    """The native C++ engine, built into the port's own build directory,
    agrees with the vectorized numpy tables."""
    if native.load_library() is None:
        pytest.skip("no C++ toolchain for the native setup engine")
    assert native.load_library()._name.startswith(
        os.path.join(ROOT, "mimi_tpu_torch", "fem", "_build")
    )
    patch, topo = _port_patch()
    fes = FESpace(patch, topo)
    tabs = domain_dim_tables(patch)
    w_flat = fes.weights_grid.transpose(2, 1, 0).reshape(-1)
    nat = native.tensor_tables_native(tabs, w_flat, fes.weights_grid.shape)
    ref = _tensor_basis_numpy(tabs, fes.weights_grid)
    assert np.array_equal(nat[0], ref[0])
    for a, b in zip(nat[1:], ref[1:]):
        _close(a, b)


def test_problem_from_numpy_matches_build(problems):
    ref, port = problems
    conv = problem_from_numpy(ref, device="cpu")
    _close(conv.wdet_t.numpy(), port.wdet_t.numpy())
    _close(conv.rhs.numpy(), port.rhs.numpy())
    for a, b in zip(conv.sf["tables"], port.sf["tables"]):
        _close(a.numpy(), b.numpy())
    _close(conv.sf["jinv"].numpy(), port.sf["jinv"].numpy())
    assert conv.material.hardening.A == port.material.hardening.A
    assert conv.material._tolerance == port.material._tolerance


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import mimi_tpu_torch\n"
        "import mimi_tpu_torch.ops.build, mimi_tpu_torch.ops.sweeps\n"
        "import mimi_tpu_torch.utils.convert, mimi_tpu_torch.config\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mimi_tpu.')) or m == 'mimi_tpu')\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize(
    "option",
    [
        {"traction": {1: {2: 1.0}}},
        {"constant_velocity": {1: {0: 1.0}}},
        {"contact": "frozen tangent"},
        {"periodic": {0: 1}},
    ],
    ids=["traction", "constant_velocity", "contact", "periodic"],
)
def test_unported_build_options_raise(option):
    if "contact" in option:
        # contact is ported with both tangents, the reference's default
        # frozen-pressure one too: the default step builds; the Schur
        # contact preconditioner stays unported
        scene = mt.NearestDistanceToSplines()
        scene.add_spline(mt.Bezier([1, 1], [[0, 0, 1.02], [0, 1, 1.02], [1, 0, 1.02], [1, 1, 1.02]]))
        scene.plant_kd_tree(8)
        prob = mt.build_problem(MESH, material=_material(mt), device="cpu", **BUILD, contact=[(2, scene)])
        assert callable(mt.make_step(prob, 0.05))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mt.make_step(prob, 0.05, precond="schur")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.build_problem(MESH, material=_material(mt), device="cpu", **BUILD, **option)


@pytest.mark.parametrize(
    "option",
    [
        {"solver": "dense"},
        {"precond": "bj"},
        {"precond": "schur"},
        {"tangent_storage": "full"},
        {"tangent_storage": "sym"},
        {"matvec_impl": "dense"},
    ],
    ids=["dense", "bj", "schur", "full", "sym", "dense_matvec"],
)
def test_unported_step_options_raise(problems, option):
    _, port = problems
    if option == {"tangent_storage": "sym"}:
        # J2 has no major-symmetric dP/dF: a wrong request, as in the reference
        with pytest.raises(ValueError, match="major-symmetric"):
            mt.make_step(port, 0.05, **option)
        return
    if option == {"tangent_storage": "full"}:
        # ported: the full dP/dF of J2's closed-form tangent, as the
        # reference takes it; the step's Newton system is the Cauchy
        # storage's to rounding
        carry = mt.initial_carry(port)
        ns = [mt.make_step(port, 0.05, tangent_storage=s).newton_system(carry)
              for s in ("full", "cauchy")]
        w = torch.tensor(np.random.default_rng(3).standard_normal(ns[0]["r"].shape))
        jw = [n["J_apply"](w) for n in ns]
        assert torch.equal(ns[0]["r"], ns[1]["r"])
        assert float((jw[0] - jw[1]).abs().max()) <= 1e-12 * float(jw[1].abs().max())
        out = mt.make_step(port, 0.05, tangent_storage="full")(carry)
        assert out["newton"]["finite"] and out["newton"]["iters"] > 0
        return
    if option == {"matvec_impl": "dense"}:
        # ported: the dense sweeps on the patch's dense tables, as the
        # reference takes it; the Newton system is the sf one's to rounding
        carry = mt.initial_carry(port)
        ns = [mt.make_step(port, 0.05, matvec_impl=m).newton_system(carry)
              for m in ("dense", "sf")]
        w = torch.tensor(np.random.default_rng(4).standard_normal(ns[0]["r"].shape))
        jw = [n["J_apply"](w) for n in ns]
        r_err = float((ns[0]["r"] - ns[1]["r"]).abs().max())
        assert r_err <= 1e-12 * float(ns[1]["r"].abs().max())
        assert float((jw[0] - jw[1]).abs().max()) <= 1e-10 * float(jw[1].abs().max())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.make_step(port, 0.05, **option)


def test_viscosity_raises():
    """A viscous problem: the CUDA engine raises on CPU tensors; the plain
    engine takes it, and the viscous flux changes its first Newton
    residual (the predictor's velocity is not zero)."""
    mat = _material(mt)
    mat.viscosity = 1.0
    prob = mt.build_problem(MESH, material=mat, device="cpu", **BUILD)
    with pytest.raises(ValueError, match="CUDA"):
        mt.make_step(prob, 0.05, residual_impl="cuda")
    carry = mt.initial_carry(prob)
    r_visc = mt.make_step(prob, 0.05).newton_system(carry)["r"]
    plain = mt.build_problem(MESH, material=_material(mt), device="cpu", **BUILD)
    r = mt.make_step(plain, 0.05).newton_system(carry)["r"]
    assert torch.isfinite(r_visc).all()
    assert float((r_visc - r).abs().max()) > 1e-6 * float(r.abs().max())
