"""The port's implicit step (mimi_tpu_torch, plain torch sweeps, float64 on
the CPU) against the reference package's SoA engine on the same problem:
cube-nurbs.mesh at p=2 and 4^3 elements, the benchmark's J2 Johnson-Cook
material and boundary conditions, generalized-alpha with FDM-preconditioned
GMRES.  The yield stress A is lowered so that the first step already
plasticizes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.utils.convert import (
    carry_from_numpy,
    carry_to_numpy,
    problem_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

MESH = os.path.join(os.path.dirname(__file__), "data", "cube-nurbs.mesh")
A_PLASTIC = 1.0  # JC yield stress; the benchmark's 70 stays elastic at 4^3
BUILD = dict(
    elevate=1,
    subdivide=0,
    dirichlet=[(1, 0), (1, 1), (1, 2)],
    body_force={1: -3.0},
    rho_inf=0.5,
    refine_spans=4,
)
STEP = dict(dt=0.05, newton_iters=4, cg_iters=40)


def _material(pkg, A=A_PLASTIC):
    mat = pkg.J2()
    mat.density = 1.0
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


def _ref_np(carry):
    return {
        "u": np.asarray(carry["u"]),
        "v": np.asarray(carry["v"]),
        "a": np.asarray(carry["a"]),
        "state": {k: np.asarray(v) for k, v in carry["state"].items()},
    }


def _fields(c):
    return {"u": c["u"], "v": c["v"], "a": c["a"], **c["state"]}


def _max_rel_err(ref, got):
    """max over fields of max|got - ref| / max(1, max|ref|)."""
    ref, got = _fields(ref), _fields(got)
    return max(
        float(np.abs(got[k] - ref[k]).max()) / max(1.0, float(np.abs(ref[k]).max()))
        for k in ref
    )


@pytest.fixture(scope="module")
def problems():
    ref = jsh.build_problem(MESH, material=_material(mimi), dtype=jnp.float64, **BUILD)
    port = mt.build_problem(MESH, material=_material(mt), dtype=torch.float64, device="cpu", **BUILD)
    return ref, port


def test_initial_carry_matches_reference(problems):
    ref, port = problems
    a_ref = np.asarray(jsh.initial_carry(ref)["a"])
    a = mt.initial_carry(port)["a"].numpy()
    # a0 = M^-1 (f - E(0)) by diagonal-preconditioned CG stopped at a
    # relative 1e-8 in both packages; CG iterates drift apart by rounding
    # over its ~30 iterations, so the bar is that solve tolerance
    assert np.abs(a - a_ref).max() <= 1e-8 * np.abs(a_ref).max()


@pytest.mark.parametrize("lin_rel_tol", [1e-3, 1e-6])
def test_three_plastic_steps_match_reference(problems, lin_rel_tol):
    """Both packages start from the reference's initial carry and take 3
    steps; u, v, a and the material state agree to 1e-8 (relative to each
    field's scale where it exceeds 1) after every step.  The tight
    lin_rel_tol keeps inexact-Newton slack from hiding a sweep fault."""
    ref, port = problems
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    rstep = jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm",
        lin_rel_tol=lin_rel_tol, **STEP,
    )
    pstep = mt.make_step(port, lin_rel_tol=lin_rel_tol, **STEP)
    for i in range(3):
        rc = rstep(rc)
        pc = pstep(pc)
        if i == 0:
            assert float(np.asarray(rc["state"]["eqps"]).max()) > 0.0
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)


def test_step_on_converted_problem_matches_port_build(problems):
    """problem_from_numpy(reference Problem) drives the same step as the
    port's own build_problem."""
    ref, port = problems
    conv = problem_from_numpy(ref, device="cpu")
    carry0 = mt.initial_carry(port)
    carries = []
    for prob in (port, conv):
        step = mt.make_step(prob, lin_rel_tol=1e-6, **STEP)
        carries.append(carry_to_numpy(step(carry0)))
    assert _max_rel_err(carries[0], carries[1]) <= 1e-10
