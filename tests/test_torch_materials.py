"""The port's J2 material, hardening laws and SoA tensor helpers against the
reference package's, float64, on inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp as torch_jvp

import mimi_tpu as mimi
from mimi_tpu.fem import soa as jsoa

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa as tsoa
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DT = 0.05
B = (64, 24)  # (n_q, n_el) batch


def _material(pkg):
    mat = pkg.J2()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = pkg.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 70.0, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    mat.setup(3)
    return mat


@pytest.fixture(scope="module")
def inputs():
    """F near I with strains of either side of yield; a state with zero
    and nonzero eqps and temperatures across the thermal range."""
    rng = np.random.default_rng(3)
    F = np.eye(3)[:, :, None, None] + 0.02 * rng.standard_normal((3, 3, *B))
    ps = 0.002 * rng.standard_normal((3, 3, *B))
    eqps = 0.01 * rng.random(B)
    eqps[:, ::3] = 0.0
    state = {
        "plastic_strain": 0.5 * (ps + ps.transpose(1, 0, 2, 3)),
        "eqps": eqps,
        "temperature": 20.0 + 600.0 * rng.random(B),
    }
    dF = rng.standard_normal((3, 3, *B))
    return F, state, dF


def _both(inputs):
    F, state, dF = inputs
    j = ({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(F), jnp.asarray(dF))
    t = ({k: torch.tensor(v) for k, v in state.items()}, torch.tensor(F), torch.tensor(dF))
    return j, t


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def test_inputs_cover_both_branches(inputs):
    mat = _material(mt)
    _, (st, F, _) = _both(inputs)
    *_, active, _ = mat._return_map(F, st, DT)
    assert 0.2 < float(active.double().mean()) < 0.8


@pytest.mark.parametrize("fn", ["cauchy_soa", "pk1_soa"])
def test_stress_matches(inputs, fn):
    (jst, jF, _), (tst, tF, _) = _both(inputs)
    ref = getattr(_material(mimi), fn)(jF, jst, DT)
    got = getattr(_material(mt), fn)(tF, tst, DT)
    assert _rel(got, ref) <= 1e-12


def test_accumulate_matches(inputs):
    (jst, jF, _), (tst, tF, _) = _both(inputs)
    ref = _material(mimi).accumulate_soa(jF, jst, DT)
    got = _material(mt).accumulate_soa(tF, tst, DT)
    assert set(ref) == set(got)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-12, k
    assert float(got["eqps"].max()) > float(tst["eqps"].max())


@pytest.mark.parametrize("fn", ["cauchy_soa", "pk1_soa"])
def test_tangent_matches(inputs, fn):
    """Forward-mode derivative through the radial return (with its
    implicit-function-theorem re-injection) in both packages."""
    (jst, jF, jdF), (tst, tF, tdF) = _both(inputs)
    jm, tm = _material(mimi), _material(mt)
    _, ref = jax.jvp(lambda x: getattr(jm, fn)(x, jst, DT), (jF,), (jdF,))
    _, got = torch_jvp(lambda x: getattr(tm, fn)(x, tst, DT), (tF,), (tdF,))
    assert _rel(got, ref) <= 1e-10


@pytest.mark.parametrize(
    "name", ["evaluate", "rate_contribution", "thermo_contribution"]
)
def test_hardening_laws_match(name):
    rng = np.random.default_rng(5)
    x = {
        "evaluate": np.concatenate([[0.0, 1e-14], rng.random(30)]),
        "rate_contribution": np.concatenate([[0.0, 0.004], 0.1 * rng.random(30)]),
        "thermo_contribution": np.concatenate([[10.0, 20.0, 1600.0], 1500 * rng.random(30)]),
    }[name]
    ref = getattr(_material(mimi).hardening, name)(jnp.asarray(x))
    got = getattr(_material(mt).hardening, name)(torch.tensor(x))
    assert _rel(got, ref) <= 1e-14


@pytest.mark.parametrize("name", ["evaluate", "rate_contribution"])
def test_hardening_derivatives_match_autodiff(name):
    """The analytic derivatives the port's radial return uses equal the
    reference package's forward-mode derivatives."""
    rng = np.random.default_rng(6)
    x = (0.1 * rng.random(40)) if name == "rate_contribution" else rng.random(40)
    x[0] = 0.0
    h = _material(mimi).hardening
    _, ref = jax.jvp(getattr(h, name), (jnp.asarray(x),), (jnp.ones(40),))
    got = getattr(_material(mt).hardening, f"{name}_grad")(torch.tensor(x))
    assert _rel(got, ref) <= 1e-13


@pytest.mark.parametrize(
    "fn", ["trace", "sym", "dev", "fro_norm", "det", "inv", "matmul_nt", "add_diag"]
)
def test_soa_helpers_match(fn):
    rng = np.random.default_rng(9)
    A = np.eye(3)[:, :, None] + 0.3 * rng.standard_normal((3, 3, 17))
    Bm = rng.standard_normal((3, 3, 17))
    args = {"matmul_nt": (A, Bm), "add_diag": (A, 0.7), "dev": (A, 2.5)}.get(fn, (A,))
    ref = getattr(jsoa, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = getattr(tsoa, fn)(*[torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    assert _rel(got, ref) <= 1e-14


def test_state_to_soa_matches():
    rng = np.random.default_rng(2)
    st = {"plastic_strain": rng.random((5, 7, 3, 3)), "eqps": rng.random((5, 7))}
    ref = jsoa.state_to_soa({k: jnp.asarray(v) for k, v in st.items()})
    got = tsoa.state_to_soa({k: torch.tensor(v) for k, v in st.items()})
    for k in st:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
