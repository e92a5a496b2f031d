"""The port's J2Linear on dense tables against the reference package,
float64 on the CPU: 3 plastic steps of the golden cantilever's mesh
(balken.mesh elevated to p = 3, subdivided 3 times: 8^2 elements, boundary
2 clamped, body force -3) against the reference's
`make_step(residual_impl="soa")` at 1e-8, from one carry, the back stress
carried across.  One reference step compile in this module.
"""

import os

import jax.numpy as jnp
import numpy as np

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy, problem_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
BALKEN = os.path.join(DATA, "balken.mesh")
DT = 0.05


def _material(pkg):
    """J2Linear with the moduli of tests/test_materials.py:256-260 and a
    yield stress of 5, which the cantilever passes in its first steps."""
    mat = pkg.J2Linear()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    mat.sigma_y, mat.isotropic_hardening, mat.kinematic_hardening = 5.0, 50.0, 30.0
    return mat


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


def test_three_cantilever_steps_match_reference_soa():
    """Both packages from the reference's initial carry, 3 steps of the
    8^2 p = 3 cantilever (FDM-GMRES at 1e-10): u, v, a, plastic strain, back
    stress and eqps agree to 1e-8 after every step; the beam yields."""
    ref = jsh.build_problem(BALKEN, 2, 3, _material(mimi), [(2, 0), (2, 1)], {1: -3.0},
                            rho_inf=0.5, dtype=jnp.float64)
    port = problem_from_numpy(ref, device="cpu")
    assert port.dense is not None and (port.n_el, port.n_q) == (64, 25)
    assert set(port.state0) == {"plastic_strain", "beta", "eqps"}
    kw = dict(newton_iters=10, solver="cg", lin_rel_tol=1e-10)
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
    assert float(pc["state"]["eqps"].max()) > 0.0
    assert float(pc["state"]["beta"].abs().max()) > 0.0
    assert float(pc["u"].abs().max()) > 1e-3  # the beam sags
