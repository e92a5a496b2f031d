"""The golden cantilever (balken.mesh, p=3, 4 elements) with J2Simo and
J2Log on the port's dense-table path with the full tangent storage,
against the reference package (the helpers are
tests/test_torch_dense_finite.py's):

  - 3 golden steps per material against the reference's `soa` step at
    1e-8 (float64, both from one carry);
  - 2 float32 J2Simo steps against the reference's interpret-mode Pallas
    step at 1e-5 of max|u|;
  - all 10 steps of the golden trajectories tests/data/ref/j2_simo_h1_p2
    and j2_log_h1_p2 (the original C++ code's) at the golden test's
    tolerances.
"""

import os

import numpy as np
import pytest
import torch

from mimi_tpu.fem.space import FESpace as RefFESpace
from mimi_tpu.nurbs.mesh_io import read_mfem_nurbs_mesh as ref_read
from mimi_tpu.nurbs.topology import build_patch_from_mesh as ref_patch
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy
from test_torch_dense_finite import (
    BALKEN,
    CLAMP,
    DATA,
    DT,
    FORCE,
    MATERIALS,
    _golden_problems,
    _material,
    _max_rel_err,
    _ref_np,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

GOLDEN = {"J2Simo": "j2_simo_h1_p2", "J2Log": "j2_log_h1_p2"}


@pytest.mark.parametrize("name", MATERIALS)
def test_three_golden_steps_match_reference_soa(name):
    """Both packages from the reference's initial carry, 3 steps of the
    golden cantilever (float64, FDM-GMRES): u, v, a and the state agree to
    1e-8 after every step, with the same Newton counts; the material
    yields."""
    ref, port = _golden_problems(name)
    assert (port.n_el, port.n_q, port.dense["dN_t"].shape[0]) == (4, 25, 16)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu")
    kw = dict(newton_iters=10, solver="cg", lin_rel_tol=1e-10)
    rstep = jsh.make_step(ref, DT, residual_impl="soa", precond="fdm", **kw)
    pstep = mt.make_step(port, DT, **kw)
    for i in range(3):
        rc, pc = rstep(rc), pstep(pc)
        assert pc["newton"]["finite"]
        assert pc["newton"]["iters"] == int(rc["newton"]["iters"])
        err = _max_rel_err(_ref_np(rc), carry_to_numpy(pc))
        assert err <= 1e-8, (i, err)
    assert float(pc["state"]["eqps"].max()) > 0.01


def test_two_float32_j2simo_steps_match_reference_pallas():
    """2 float32 J2Simo steps of the golden cantilever against the
    reference's Pallas engine (its dense-table kernels' full branch in
    interpret mode), both from the reference's initial carry, at 1e-5 of
    max|u|."""
    ref, port = _golden_problems("J2Simo", f32=True)
    kw = dict(newton_iters=10, solver="cg", lin_rel_tol=1e-5)
    rstep = jsh.make_step(ref, DT, residual_impl="pallas", precond="fdm", **kw)
    pstep = mt.make_step(port, DT, **kw)
    rc = jsh.initial_carry(ref)
    pc = carry_from_numpy(_ref_np(rc), device="cpu", dtype=torch.float32)
    for i in range(2):
        rc, pc = rstep(rc), pstep(pc)
        u_ref, u = np.asarray(rc["u"]), pc["u"].numpy()
        err = float(np.abs(u - u_ref).max())
        assert err <= 1e-5 * float(np.abs(u_ref).max()), (i, err)
    assert float(pc["state"]["eqps"].max()) > 0.0


@pytest.mark.parametrize("name", MATERIALS)
def test_golden_trajectory(name):
    """The port's plain float64 step through all 10 steps of the golden
    trajectory (the original C++ code's), with the golden's Newton settings
    (rel 1e-12, abs 1e-8, 10 iterations), at the golden test's tolerance:
    np.allclose's defaults for J2Simo, atol 1e-6 for J2Log
    (tests/test_nonlinear_solid.py says why).  The compiled core's u is
    lexicographic; the golden is in the session's MFEM order: u[inv_perm],
    with the reference FESpace's own permutation."""
    prob = mt.build_problem(BALKEN, 2, 1, _material(mt, name), CLAMP, {1: FORCE},
                            rho_inf=0.5, device="cpu")
    patch, topo, _ = ref_patch(ref_read(BALKEN))
    patch.elevate_degrees(2)
    patch.uniform_refine()
    perm = RefFESpace(patch, topo).inv_perm
    step = mt.make_step(prob, DT, newton_iters=10, rel_tol=1e-12, abs_tol=1e-8,
                        lin_rel_tol=1e-12)
    atol = 1e-6 if name == "J2Log" else 1e-8
    carry = mt.initial_carry(prob)
    for i in range(10):
        carry = step(carry)
        x = carry["u"].numpy()[perm].ravel()
        golden = np.genfromtxt(os.path.join(DATA, "ref", GOLDEN[name], f"x_{i}.txt"))
        assert np.allclose(x, golden, atol=atol), f"step {i}: max err {np.abs(x - golden).max()}"
