"""The port's hardening laws and the J2 family with the PowerLaw and Voce
laws against the reference package, float64 on the CPU:

  - each law's `evaluate`, `evaluate_grad` (against jax.grad of the
    reference's `evaluate`), rate and thermal factors and `sigma_y` on
    Python numbers and on tensors, and the reference's own checks of
    tests/test_materials.py:209-246 on Python numbers;
  - J2, J2Simo and J2Log with each of the two laws: `pk1_soa` and
    `accumulate_soa` at 1e-10 on random F and a random plastic history;
  - the reference's J2 + PowerLaw kernel check (tests/test_pallas.py:
    397-440: sigma_y 10, n 2, eps0 1e-3, 8 elements, body force -5): 2
    steps against its `make_step(residual_impl="soa")` at 1e-8, yielding;
  - the kernel parameters and counter names of each law.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.ops import sweeps as tsw
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, problem_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)
from torch_shapes import DENSE_SHAPES

DATA = os.path.join(os.path.dirname(__file__), "data")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
DT = 0.05

LAWS = {  # class name: parameters
    "PowerLawHardening": dict(sigma_y=100.0, n=2.0, eps0=0.1),
    "VoceHardening": dict(sigma_y=100.0, sigma_sat=200.0, strain_constant=0.1),
    "JohnsonCookHardening": dict(A=70.0, B=140.0, n=0.3),
    "JohnsonCookRateDependentHardening": dict(A=70.0, B=140.0, n=0.3, C=0.05,
                                              eps0_dot=0.004),
    "JohnsonCookTemperatureAndRateDependentHardening": dict(
        A=70.0, B=140.0, n=0.3, C=0.05, eps0_dot=0.004, m=1.0, reference_temperature=20.0,
        melting_temperature=1020.0),
}


def _law(pkg, name, **over):
    h = getattr(pkg, name)()
    for k, v in {**LAWS[name], **over}.items():
        setattr(h, k, v)
    return h


@pytest.mark.parametrize("name", list(LAWS))
def test_law_matches_reference_on_numbers_and_tensors(name):
    ref, port = _law(mimi, name), _law(mt, name)
    eqps = [0.0, 1e-14, 0.05, 0.2, 1.3]
    for e in eqps:
        want = float(ref.evaluate(jnp.asarray(e)))
        assert math.isclose(float(port.evaluate(e)), want, rel_tol=1e-14), e
        grad = float(jax.grad(lambda x: ref.evaluate(x))(jnp.asarray(e)))
        assert math.isclose(float(port.evaluate_grad(e)), grad, rel_tol=1e-12, abs_tol=1e-12), e
    t = torch.tensor(eqps, dtype=torch.float64)
    assert np.allclose(port.evaluate(t).numpy(), np.asarray(ref.evaluate(jnp.asarray(eqps))),
                       rtol=1e-14, atol=0.0)
    for r in (0.001, 0.04, 2.0):
        assert math.isclose(float(port.rate_contribution(r)),
                            float(ref.rate_contribution(jnp.asarray(r))), rel_tol=1e-14)
    for temp in (10.0, 520.0, 2000.0):
        assert math.isclose(float(port.thermo_contribution(temp)),
                            float(ref.thermo_contribution(jnp.asarray(temp))), rel_tol=1e-14)
    assert port.sigma_y_value() == ref.sigma_y_value()


def test_hardening_laws_take_python_numbers():
    """tests/test_materials.py:209-246 (test_hardening_laws) on the port's
    laws, every input a Python number."""
    h = mt.PowerLawHardening()
    h.sigma_y, h.n, h.eps0 = 100.0, 2.0, 0.1
    assert np.isclose(float(h.evaluate(0.05)), 100 * 1.5**0.5)
    v = mt.VoceHardening()
    v.sigma_y, v.sigma_sat, v.strain_constant = 100.0, 200.0, 0.1
    assert np.isclose(float(v.evaluate(0.1)), 200 - 100 * np.exp(-1.0))
    jc = mt.JohnsonCookHardening()
    jc.A, jc.B, jc.n = 70.0, 140.0, 0.3
    assert float(jc.evaluate(0.0)) == 70.0
    assert np.isclose(float(jc.evaluate(0.2)), 70 + 140 * 0.2**0.3)
    assert np.isfinite(float(jc.evaluate_grad(0.0)))  # guarded at zero
    jr = mt.JohnsonCookRateDependentHardening()
    jr.A, jr.B, jr.n, jr.C, jr.eps0_dot = 70.0, 140.0, 0.3, 0.05, 0.004
    assert float(jr.rate_contribution(0.001)) == 1.0
    assert np.isclose(float(jr.rate_contribution(0.04)), 1 + 0.05 * np.log(10.0))
    jt = mt.JohnsonCookTemperatureAndRateDependentHardening()
    jt.A, jt.B, jt.n, jt.m = 70.0, 140.0, 0.3, 1.0
    jt.reference_temperature, jt.melting_temperature = 20.0, 1020.0
    assert float(jt.thermo_contribution(10.0)) == 1.0
    assert float(jt.thermo_contribution(2000.0)) == 0.0
    assert np.isclose(float(jt.thermo_contribution(520.0)), 0.5)


def _j2_family(pkg, name, law, sigma_y=10.0):
    """`name` with E 2100, nu 0.3 and a PowerLaw (n 2, eps0 1e-3) or Voce
    (sigma_sat 3 sigma_y, c 0.02) law of initial yield `sigma_y`."""
    mat = getattr(pkg, name)()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    if law == "PowerLawHardening":
        h = _law(pkg, law, sigma_y=sigma_y, n=2.0, eps0=1e-3)
    else:
        h = _law(pkg, law, sigma_y=sigma_y, sigma_sat=3 * sigma_y, strain_constant=0.02)
    mat.hardening = h
    return mat


def _near_eye(rng, scale, n):
    return np.eye(3)[:, :, None] + scale * rng.standard_normal((3, 3, n))


def _history(rng, name, n):
    state = {"eqps": 0.01 * rng.random(n), "temperature": 20.0 + 300.0 * rng.random(n)}
    state["eqps"][::3] = 0.0
    if name == "J2":
        ps = 2e-3 * rng.standard_normal((3, 3, n))
        state["plastic_strain"] = 0.5 * (ps + ps.transpose(1, 0, 2))
    elif name == "J2Simo":
        be = _near_eye(rng, 0.002, n)
        state["be_old"] = 0.5 * (be + be.transpose(1, 0, 2))
        state["F_old"] = _near_eye(rng, 0.002, n)
    else:
        state["Fp_inv"] = _near_eye(rng, 0.002, n)
    return state


@pytest.mark.parametrize("law", ["PowerLawHardening", "VoceHardening"], ids=["pow", "voce"])
@pytest.mark.parametrize("name", ["J2", "J2Simo", "J2Log"])
def test_j2_family_with_law_matches_reference(name, law):
    ref, port = _j2_family(mimi, name, law), _j2_family(mt, name, law)
    ref.setup(3)
    port.setup(3)
    rng = np.random.default_rng(41)
    F, state = _near_eye(rng, 0.003, 120), _history(rng, name, 120)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    P_ref = np.asarray(ref.pk1_soa(jnp.asarray(F), js, DT))
    P = port.pk1_soa(torch.tensor(F), ts, DT).numpy()
    assert np.abs(P - P_ref).max() <= 1e-10 * np.abs(P_ref).max()
    new_ref = ref.accumulate_soa(jnp.asarray(F), js, DT)
    new = port.accumulate_soa(torch.tensor(F), ts, DT)
    assert set(new) == set(new_ref)
    for k in new_ref:
        r = np.asarray(new_ref[k])
        assert np.abs(new[k].numpy() - r).max() <= 1e-10 * max(1.0, np.abs(r).max()), k
    yielded = np.asarray(new_ref["eqps"]) > state["eqps"]
    assert 0.1 < yielded.mean() < 0.9  # elastic and plastic points


def test_reference_powerlaw_kernel_config_steps():
    """tests/test_pallas.py:397-440 in float64: J2 with PowerLaw (sigma_y 10,
    n 2, eps0 1e-3) on the 8-element cube, body force -5, 3 Newton
    iterations, 2 steps; the port against the reference's `soa` step from
    one carry at 1e-8, the cube yielding."""
    ref = jsh.build_problem(MESH, 1, 1, _j2_family(mimi, "J2", "PowerLawHardening"),
                            [(1, 0), (1, 1), (1, 2)], {1: -5.0}, rho_inf=0.5,
                            dtype=jnp.float64)
    port = problem_from_numpy(ref, device="cpu")
    assert port.n_el == 8 and type(port.material.hardening) is mt.PowerLawHardening
    kw = dict(newton_iters=3, solver="cg", cg_iters=40, lin_rel_tol=1e-10)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy({k: np.asarray(v) for k, v in rc.items() if k in ("u", "v", "a")}
                          | {"state": {k: np.asarray(v) for k, v in rc["state"].items()}},
                          device="cpu")
    rstep = jsh.make_step(ref, DT, residual_impl="soa", precond="fdm", **kw)
    pstep = mt.make_step(port, DT, **kw)
    for _ in range(2):
        rc, pc = rstep(rc), pstep(pc)
        got = carry_to_numpy(pc)
        for k in ("u", "v", "a"):
            r = np.asarray(rc[k])
            assert np.abs(got[k] - r).max() <= 1e-8 * max(1.0, np.abs(r).max()), k
        for k, v in rc["state"].items():
            r = np.asarray(v)
            assert np.abs(got["state"][k] - r).max() <= 1e-8 * max(1.0, np.abs(r).max()), k
    assert float(pc["state"]["eqps"].max()) > 1e-4


def test_kernel_parameters_of_the_laws():
    """_j2_params: the law ids, the exponent 1/2 of PowerLaw's n = 2 that
    torch evaluates as a square root on the card (pow_mode 1), the
    reciprocals taken in double, and the law-tagged counter names."""
    pw = _j2_family(mt, "J2", "PowerLawHardening")
    vc = _j2_family(mt, "J2Simo", "VoceHardening")
    for mat in (pw, vc):
        mat.setup(3)
    p = tsw._j2_params(pw, DT, 1.0)
    # the derivative's exponent 1/2 - 1 = -1/2 is torch's rsqrt (dpow_mode 4)
    assert (p.law, p.pow_mode, p.dpow_mode, p.rate_dep, p.thermo_mode) == (1, 1, 4, 0, 0)
    assert p.pw == 0.5 and p.dpw == -0.5 and p.inv_eps0 == np.float32(1.0 / 1e-3)
    assert math.isclose(p.dh_coef, 10.0 / (2.0 * 1e-3), rel_tol=1e-7)
    assert p.inv_dt == np.float32(1.0 / DT) and p.g3 == np.float32(3.0 * pw.G)
    q = tsw._j2_params(vc, DT, 1.0, family=tuple(tsw.FULL_KERNELS))
    assert (q.law, q.sigma_sat, q.sat_diff) == (2, 30.0, 20.0)
    assert q.inv_c == np.float32(1.0 / 0.02) and math.isclose(q.dv_coef, 1000.0, rel_tol=1e-7)
    jc = tsw._j2_params(_law_jc(), DT, 1.0)
    assert (jc.law, jc.pow_mode, jc.dpow_mode, jc.m_mode) == (0, 0, 0, 0)
    assert (jc.pw, jc.dpw) == (np.float32(0.2835), np.float32(0.2835 - 1.0))
    assert jc.inv_dtemp == np.float32(1.0 / (1500.0 - 20.0))
    assert tsw.kernel_counters(pw, "sf", visc=True, bf16=True) == (
        "residual_sf[j2-pow,visc]", "assemble_sf[j2-pow,cauchy,visc,bf16]")
    assert tsw.kernel_counters(vc, "dense", 2, 3) == (
        "residual_dense[simo-voce]@2d_p3", "assemble_dense[simo-voce,full]@2d_p3")
    for mat in (pw, vc):
        for kind, shapes in (("sf", [(3, 2)]), ("dense", DENSE_SHAPES)):
            for dim, deg in shapes:
                key = (deg + 1, deg + 2) if kind == "sf" else tsw.dense_key(dim, deg)
                for name in tsw.kernel_counters(mat, kind, dim, deg):
                    assert name in tsw.shape_counters(kind, key), name


def _law_jc():
    mat = mt.J2()
    mat.set_young_poisson(2100.0, 0.3)
    h = mt.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 70.0, 140.0, 0.2835, 1.3558
    h.eps0_dot, h.reference_temperature = 0.004, 20.0
    mat.melting_temperature = 1500.0
    mat.hardening = h
    mat.setup(3)
    return mat
