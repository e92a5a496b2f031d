"""The port's dense (3, 3) path on the CPU against the reference package:
the neo-Hookean two-patch cube of tests/test_multipatch.py elevated by 2
(p = 3: 64 dofs and 125 points per element, the conn gather and scatter,
the additive-Schwarz FDM) at 2 x 2^3, two float64 steps against the
reference's `soa` make_step from one carry (1e-8).  A file of its own
beside test_torch_p3.py, so that the two reference steps (~140 s of XLA
compile each at p = 3) build on two test workers."""

import os

import jax.numpy as jnp
import numpy as np
import torch

import mimi_tpu as mimi
from mimi_tpu.parallel import sharding as jsh

import mimi_tpu_torch as mt
from test_torch_p3 import DATA, STEP, _material, _two_steps
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

TWO_PATCH = os.path.join(DATA, "two-patch-cube.mesh")
TWO_PATCH_BUILD = dict(elevate=2, subdivide=0, dirichlet=[(0, 0), (0, 1), (0, 2)],
                       body_force={1: -5.0}, rho_inf=0.5, refine_spans=2)


def test_two_patch_cube_steps_match_reference():
    """The neo-Hookean two-patch cube elevated by 2 (dense (3, 3) tables:
    64 dofs and 125 points per element, the conn gather and scatter, the
    additive-Schwarz FDM) at 2 x 2^3: two float64 steps against the
    reference's `soa` step."""
    ref = jsh.build_problem(TWO_PATCH, material=_material(mimi, "CompressibleOgdenNeoHookean"),
                            dtype=jnp.float64, **TWO_PATCH_BUILD)
    port = mt.build_problem(TWO_PATCH, material=_material(mt, "CompressibleOgdenNeoHookean"),
                            dtype=torch.float64, device="cpu", **TWO_PATCH_BUILD)
    assert port.sf is None and tuple(port.dense["dN_t"].shape) == (64, 3, 125, 16)
    out = _two_steps(ref, port, lambda: jsh.make_step(
        ref, solver="cg", residual_impl="soa", precond="fdm", lin_rel_tol=1e-6, **STEP))
    assert float(np.abs(out["u"]).max()) > 1e-4  # the cube sags under its weight
