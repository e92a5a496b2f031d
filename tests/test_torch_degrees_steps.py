"""Path K's problem on the CPU against the reference package: the J2
body-force cube of cube-nurbs-3.mesh elevated by 1 to p = 4 (sum-factorized
tables, 5 nodes and 6 Gauss points per axis: 125 dofs and 216 points per
element) at 3^3, two float64 steps of the port from the reference's
initial carry, each held against the reference's equations in its SoA
math (test_torch_finite_strain.py's recipe): the first Newton system
(residual and J w at the predictor) at 1e-10, the converged increment
leaves the reference's residual below the Newton goal, the new state is
the reference's accumulate_soa at the new u to 1e-10.  The reference's own
p = 4 step is not compiled: the XLA compile of its `soa` step at 3D p = 4
outgrows a test worker's host memory on the CPU, and its "xla" engine does
not bring that step's Newton residual to the port's tolerance.  A file of its own
beside test_torch_degrees.py, so that the reference's residual compiles on
another test worker."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from mimi_tpu_torch.utils.convert import carry_from_numpy, carry_to_numpy
from test_torch_finite_strain import _ref_newton_system
from test_torch_p3 import DATA, DT, STEP, _material, _ref_np, _rel
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

CUBE3 = os.path.join(DATA, "cube-nurbs-3.mesh")
K_BUILD = dict(elevate=1, subdivide=0, dirichlet=[(1, 0), (1, 1), (1, 2)],
               body_force={1: -3.0}, rho_inf=0.5, refine_spans=3)


def test_two_p4_cube_steps_match_reference():
    """J2 Johnson-Cook at yield stress 1 on the p = 4 cube at 3^3 (sf tables
    at (p + 1, n_g) = (5, 6), the structured gather at pp1 = 5, the FDM on
    6 points per axis): two float64 steps, each held against the
    reference's Newton system, residual and state update; plastic from the
    first."""
    ref = jsh.build_problem(CUBE3, material=_material(mimi, "J2"), dtype=jnp.float64,
                            **K_BUILD)
    port = mt.build_problem(CUBE3, material=_material(mt, "J2"), dtype=torch.float64,
                            device="cpu", **K_BUILD)
    assert (port.sf["pp1"], port.sf["n_g"], port.n_q, port.n_el) == (5, 6, 216, 27)
    pstep = mt.make_step(port, lin_rel_tol=1e-6, **STEP)
    y_jw = _ref_newton_system(ref)
    accumulate = jax.jit(lambda F, st: ref.material.accumulate_soa(F, st, DT))
    f, dt = port.facs, STEP["dt"]
    conn = np.asarray(ref.conn)
    dN_t = np.transpose(np.asarray(ref.dN_dX), (2, 3, 1, 0))
    pc = carry_from_numpy(_ref_np(jsh.initial_carry(ref)), device="cpu")
    rng = np.random.default_rng(24)
    for i in range(2):
        c = carry_to_numpy(pc)
        xa = c["u"] + (c["v"] + f["fac0"] * dt * c["a"]) * f["fac1"] * dt
        st = {k: jnp.asarray(v) for k, v in c["state"].items()}
        w = rng.standard_normal(xa.shape)
        r0, Jw = y_jw(np.zeros_like(xa), xa, st, w)
        ns = pstep.newton_system(pc)
        assert _rel(ns["r"].numpy(), r0.reshape(-1)) < 1e-10, i
        assert _rel(ns["J_apply"](torch.tensor(w.reshape(-1))).numpy(), Jw.reshape(-1)) < 1e-10, i
        pc = pstep(pc)
        assert pc["newton"]["converged"] and pc["newton"]["finite"]
        n = carry_to_numpy(pc)
        aa = (n["a"] - c["a"] * (1.0 - f["fac1_inv"])) / f["fac5_inv"]
        r = y_jw(aa, xa, st, np.zeros_like(xa))[0]
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(r0), i
        F = np.einsum("ndqe,cne->cdqe", dN_t, np.transpose(n["u"][conn], (2, 1, 0)))
        new_ref = accumulate(jnp.asarray(F + np.eye(3)[:, :, None, None]), st)
        for k, v in new_ref.items():
            assert _rel(n["state"][k], v) < 1e-10, (i, k)
        if i == 0:
            assert float(np.asarray(new_ref["eqps"]).max()) > 0.0
            assert float(n["state"]["eqps"].max()) > 0.0
