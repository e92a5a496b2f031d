#!/usr/bin/env python3
"""Smoke run of mimi_tpu_torch on one CUDA GPU.

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together, into one library), prints ptxas's registers,
shared memory and spills of every instantiation of the sf kernel template,
residual, assemble and matvec (failing where a matvec or a J2-family
Cauchy or hyperelastic residual or assemble spills), holds each
kernel against its plain torch version, checks one implicit step of the
kernel path against the plain path, then drives five paths, float32.  Four at 48^3 elements
(cube-nurbs.mesh at p=2, 375,000 unknowns):
  - the J2 Johnson-Cook body-force problem, generalized-alpha steps with
    4 line-search Newton iterations and FDM-preconditioned GMRES(40) at
    lin_rel_tol 1e-3 (phases 3-8);
  - the contact press: the top face pressed by a rigid bilinear Bezier
    tool moved down 0.01 per step (mortar penalty contact, kappa 5e7),
    J2 Johnson-Cook with viscosity 100, 12 Newton iterations at rel_tol
    1e-3, GMRES(30, at most 80) at lin_rel_tol 1e-2, the consistent
    contact tangent and a bfloat16 tangent block, which runs the viscous
    and bfloat16 variants of the kernels (phases 9-12); the same variants
    on random plastic input at 47^3 = 103,823 elements, where the sf
    residual kernel's last tile of 32 elements holds 15 (phase 11b);
  - the hyperelastic single-patch path (phases 19-22): the neo-Hookean
    cube, E 2100, nu 0.3, the same face clamped, body force -3, the
    body-force path's step settings, through the sum-factorized kernels
    with the 45-plane symmetric tangent; two steps of the same cube with
    the St. Venant-Kirchhoff material run that material's instantiations;
  - finite-strain J2 plasticity (phases 23-26): the same cube with J2Simo
    and the Johnson-Cook material of the reference's golden trajectories,
    the body-force path's settings, through the sum-factorized kernels
    with the 81-plane full tangent (9 dual-number passes per point); its
    kernels held against plain at 16^3 on random plastic input and one
    plastic step per material there; three steps of the same cube with
    J2Log run that material's instantiations.
And the dense-table path (phases 13-16): the neo-Hookean two-patch
cantilever of tests/test_multipatch.py (two-patch-cube.mesh, the second
patch rotated) at p=2 and 2 x 38^3 = 109,744 elements, 379,200 unknowns,
E 2100, nu 0.3, the x=0 face clamped, body force -5, the body-force
path's step settings, through the three dense kernels with the 45-plane
symmetric tangent and the multi-patch additive-Schwarz FDM.  On its
tables also (phases 17-18): the fused neo-Hookean residual and matrix-free
tangent apply (ops/fused_neohookean.py) against their plain versions and
the dense kernels, driven by a matrix-free solve of the path's Newton
system; and two St. Venant-Kirchhoff steps.

And the 2D dense-table path (phases 27-32): the golden cantilever of the
reference's trajectories (balken.mesh, the unit square, at p=3) at 512^2
= 262,144 elements, 530,450 unknowns, J2 Johnson-Cook (1 warm + 2 timed
steps) and its neo-Hookean twin (1 + 2), through the dense kernels with
the 14-plane Cauchy and the 10-plane symmetric tangent and the 2D FDM;
every instantiation of the templated dense kernels (2D p=2 and p=3, 3D
p=2 with J2) against its plain version, one step of the kernel path
against the plain path per 2D material and for 3D dense J2.

And the finite-strain plasticity models on dense tables (phases 33-37):
the golden cantilever at 512^2 with J2Simo and with J2Log (1 warm + 2
timed steps each, dt 0.1), through the dense kernels with the 16-plane
full tangent (4 dual-number passes per point) and their state; every
dense + full instantiation (2D p=2 and p=3, 3D p=2, both materials)
against its plain version on random plastic input (J2Log also past the
fast log series' range), one plastic step of the kernel path against the
plain path at 64^2 per material (the third step, from two float64 plain
steps) and of 3D J2Simo at 2 x 8^3, the 128^2 p=2 and the two-patch
2 x 38^3 drives of both materials, a profiled step per 2D material at
512^2 and the kernels' rows at the drives' states.

And the viscous neo-Hookean contact presses with the frozen contact
tangent (phases 38-42), the material of tests/test_contact.py:154-158 and
the examples (E 1e6, nu 0.3, density 1e3, viscosity 100, penalty 5e7, dt
0.01, the contact press's step settings): path A, the 2D two-patch press
of examples/multipatch_contact.py at 2 x 512^2 = 524,288 elements (p=2,
the viscous dense (2, 2) kernels with the 10-plane symmetric tangent, the
two-patch FDM with the contact spring); path B, the cube press of
tests/test_contact.py at 48^3 (the viscous sf kernels with the 45-plane
symmetric tangent in bfloat16).  Each tool starts touching the body (the
example's y = 1.02 would leave the first four steps untouched) and is
pushed 0.005 (A) or 0.01 (B) before each of 1 warm + 2 timed steps.  On
each path's tables every new viscous and bfloat16 instantiation is held
against its plain version on random input (at 2 x 512^2 also those of St.
Venant-Kirchhoff and J2), and the path kernels at the path's state; the
next Newton system at full size and one step at 2 x 64^2 / 16^3 are held
kernel path against plain path.  The viscous instantiations of the other
shapes are held where those tables are built (phases 13, 18, 22, 28, 32).

And J2Linear and the PowerLaw and Voce hardening laws (phases 43-47):
path C, the 48^3 body-force cube with J2Linear (E 2100, nu 0.3, the
reference's hardening moduli isotropic 50 and kinematic 30, yield stress
5), the sf kernels with the Cauchy storage; path D, the golden
cantilever's mesh at 512^2 p = 3 with J2Linear, the dense (2, 3) kernels;
path E, the 48^3 cube with J2 and the reference's PowerLaw (sigma_y 10,
n 2, eps0 1e-3), body force -5; dt 0.05, 1 warm + 2 timed steps each, C
and E yielding at 1% of the points or more.  Every new instantiation
(J2Linear's, sf and dense, viscous and not, float32 and bfloat16 sf
blocks; J2, J2Simo and J2Log with each law, sf and dense) is held against
its plain version on random plastic input on the paths' tables (J2Linear's
dense (2, 2) at 128^2 and (3, 2) at 2 x 8^3), the path kernels at the
paths' states, the next Newton system at full size, one profiled step per
path, and one plastic step kernel path against plain path each of J2Linear
(16^3, 64^2 p = 3), J2 + PowerLaw and J2Simo + Voce (16^3) and J2Log +
PowerLaw (64^2 p = 3).

And the finite-strain contact presses and the full block of every
material (phases 48-53): path F, the cube press of phases 9-12 (48^3, the
bilinear tool pushed 0.01 per step, kappa 5e7, E 1e6, density 1e3,
viscosity 100, the Johnson-Cook law A 700 / B 1400, dt 0.01, 12 Newton,
FDM-GMRES(30, 80) at 1e-2, the bfloat16 block, the frozen contact tangent)
with J2Simo and with J2Log, through the viscous bfloat16 full sf kernels;
path G, the 2D two-patch press of path A (2 x 512^2) with the same J2Simo,
through the viscous dense (2, 2) full kernels; 1 warm + 2 timed steps
each.  Every new instantiation (J2Simo's and J2Log's viscous and bfloat16
full kernels, sf and at every dense shape; the full block of J2, J2Linear
and the hyperelastic materials) against its plain version on random input
at full size, the path kernels at the paths' states, the next Newton
system, a profiled step, one step held at 16^3 / 2 x 64^2, one body-force
J2 step with tangent_storage="full" against the Cauchy block's.  Phase 48
times the J2-family kernels' radial return at its cap of 40 trips against
the 100 of the "torch" engine (the press's plastic sf sweeps in phase 11,
the golden J2 cantilever's dense (2, 3) sweeps in phase 32, J2Log's sf
assemble on random plastic input), with the plain twin's share of plastic
points that reach the cap.  The kernels run the radial return at most 40
trips, as the reference's Pallas kernels do; every kernel is held against
its plain version run as its twin (materials.kernel_solver_mode).

And the cubic (p = 3) 3D sweeps (phases 54-57): path H, the body-force
path on the reference's own cubic mesh (cube-nurbs-3.mesh, 4 nodes and 5
Gauss points per axis) at 48^3, 397,953 unknowns, through the sf kernels
of the _p3 sources (1 warm + 2 timed steps); path I, the neo-Hookean
two-patch cube of phases 13-16 elevated to p = 3 at 2 x 38^3, 408,483
unknowns, through the tiled dense (3, 3) kernels (1 warm + 1 timed step).
Every p = 3 instantiation against its plain version on random input (sf at
16^3 and on a ragged tile of 33 elements, dense at 2 x 8^3), each path's
kernels at its state (the plain versions on four slices of the elements:
at path I's size they would not fit the card whole), their rows, a
profiled step, one step of each path's problem held kernel path against
plain path at 16^3 / 2 x 8^3.  ptxas's gate holds the p = 3 J2-family and
hyperelastic sf residual instantiations and every p = 3 sf matvec too.

    python3 chip_smoke.py

Exits non-zero without a CUDA device, outside a checkout, or when any
phase fails.  The last line of standard output is the device record
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import json
import math
import os
import re
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(ROOT, "tests", "data", "cube-nurbs.mesh")
SPANS = 48  # main path: 48^3 elements
CHECK_SPANS = 16  # kernel-vs-plain and one-step parity
# timed steps of the 48^3 body-force, neo-Hookean and J2Simo drives, and of
# the contact press: 2 keep the whole smoke near fourteen minutes
TIMED_STEPS = 2
NEWTON_ITERS = 4
RES_EVALS_PER_STEP = NEWTON_ITERS * 3 + 1  # assemble + 2 line-search residuals, + accumulate
STEP_KW = dict(dt=0.05, newton_iters=NEWTON_ITERS, solver="cg", cg_iters=40,
               precond="fdm", lin_rel_tol=1e-3)
KERNELS = [  # (counter name, TPU kernel it replaces)
    ("matvec_sf", "mimi_tpu/ops/sweeps.py:922"),
    ("assemble_sf", "mimi_tpu/ops/sweeps.py:472"),
    ("residual_sf", "mimi_tpu/ops/sweeps.py:338"),
]
# the contact press (bench.py:361-504 of the reference package)
CONTACT_STEP_KW = dict(dt=0.01, newton_iters=12, solver="cg", cg_iters=80,
                       precond="fdm", lin_rel_tol=1e-2, rel_tol=1e-3,
                       contact_tangent="consistent", matvec_dtype="bf16")
CONTACT_TIMED_STEPS = 2
PUSH = [0.0, 0.0, -0.01]  # tool motion per step
RAGGED_SPANS = 47  # 103,823 elements: the sf residual kernel's last tile holds 15 of 32
VARIANTS = [  # (counter name, TPU kernel it replaces); the contact path's
    ("residual_sf[visc]", "mimi_tpu/ops/sweeps.py:338"),
    ("assemble_sf[visc,bf16]", "mimi_tpu/ops/sweeps.py:472"),
    ("matvec_sf[visc,bf16]", "mimi_tpu/ops/sweeps.py:922"),
]
SOURCE = [
    "mimi_tpu_torch/ops/csrc/sweeps_sf.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_dense.cu",
    "mimi_tpu_torch/ops/csrc/fused_neohookean.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_sf_finite.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_dense_j2.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_dense_finite.cu",
    "mimi_tpu_torch/ops/csrc/sweeps_sf_hyper.cu",
]
# the dense kernels' source by tangent storage
DENSE_SOURCE = {"sym": SOURCE[1], "cauchy": SOURCE[4], "full": SOURCE[5]}
# the dense-table path: the two-patch neo-Hookean cantilever
TWO_PATCH = os.path.join(ROOT, "tests", "data", "two-patch-cube.mesh")
DENSE_SPANS = 38  # per patch and axis: 2 x 38^3 = 109,744 elements
DENSE_CHECK_SPANS = 8  # 2 x 8^3 = 1,024 elements
DENSE_KERNELS = [  # (counter name, TPU kernel it replaces)
    ("residual_dense", "mimi_tpu/ops/sweeps.py:338"),
    ("assemble_dense[sym]", "mimi_tpu/ops/sweeps.py:472"),
    ("matvec_dense[sym]", "mimi_tpu/ops/sweeps.py:838"),
]
# per table kind the TPU kernels that a hyperelastic or finite-strain
# material's (residual, assemble, matvec) instantiations replace; their
# counter names come from ops/sweeps.py (HYPER_KERNELS, FULL_KERNELS,
# material_counters)
SYM_REPLACES = {
    "sf": ("mimi_tpu/ops/sweeps.py:338", "mimi_tpu/ops/sweeps.py:472",
           "mimi_tpu/ops/sweeps.py:922"),
    "dense": tuple(r for _, r in DENSE_KERNELS),
}
STVK_STEPS = 1  # timed steps after the warm one on each St. Venant-Kirchhoff drive
# the finite-strain plasticity cube: J2Simo driven 1 warm + TIMED_STEPS,
# J2Log 1 warm + LOG_STEPS; the one-step parity at 16^3 lowers the yield
# stress so that the step yields (the path's A 70 stays elastic there)
LOG_STEPS = 2
# the finite-strain residual kernel against plain at the paths' states (see
# finite_phases), read at the drive's last state and PATH_READINGS more: the
# assemble's bar; on an NVIDIA H100 80GB HBM3 the readings ran 1.5e-5 to 6.5e-5
PATH_RES_BAR = 1e-4
PATH_READINGS = 3
A_PLASTIC = 1.0
# the 2D dense-table path: the golden cantilever of the reference's
# trajectories (tests/test_nonlinear_solid.py:22-90), balken.mesh (the unit
# square) elevated by 2 to p = 3 and subdivided 9 times: 512^2 = 262,144
# elements, 16 dofs and 25 points each, 530,450 unknowns; boundary 2
# clamped; J2 Johnson-Cook (body force -3, dt 0.5, 1 warm + 2 timed steps)
# and its neo-Hookean twin (body force -5, dt 0.05, 1 + 2); the golden's
# 10 Newton iterations, GMRES(30, at most 80) at lin_rel_tol 1e-3, FDM.
BALKEN = os.path.join(ROOT, "tests", "data", "balken.mesh")
GOLDEN_SUBDIVIDE = 9  # 2^9 = 512 spans per axis, p = 3
P2_SUBDIVIDE = 7  # the p = 2 instantiations (elevate 1) at 128^2
STEP2D_SUBDIVIDE = 6  # the one-step parity at 64^2
GOLDEN_2D = {  # material: (body force in y, dt, timed steps)
    "J2": (-3.0, 0.5, 2),  # 2 timed steps keep the smoke near fourteen minutes
    "CompressibleOgdenNeoHookean": (-5.0, 0.05, 2),
    "StVenantKirchhoff": (-5.0, 0.05, 1),
}
STEP2D_KW = dict(newton_iters=10, solver="cg", cg_iters=80, gmres_restart=30, precond="fdm",
                 lin_rel_tol=1e-3)
# the finite-strain golden cantilevers (tests/test_nonlinear_solid.py:
# 108-134) at 512^2 and 128^2 (p = 2), by material: (body force in y, dt,
# timed steps).  The golden's dt 0.5 does not converge refined, in float64
# too (Newton stops at a drop of 0.43 for J2Simo and diverges for J2Log at
# 64^2).  Neither does dt 0.2 at 512^2: Newton fails in the first step on
# the kernel path and on the plain path, float32 and float64 alike (drops
# 0.33-0.36 for J2Simo, 0.85-31 for J2Log), and at 256^2 in the third
# step; at 128^2 all three paths converge (finite_witness.py).  dt 0.1,
# whose third step (the last of 1 warm + 2 timed) yields at 512^2.  The
# one-step parity at 64^2 takes the third step at dt 0.2 (PARITY_DT),
# which converges there in float64 and yields.
GOLDEN_FINITE = {"J2Simo": (-3.0, 0.1, 2), "J2Log": (-3.0, 0.1, 2)}
PARITY_DT = 0.2
# the fast log series' range left by element 0 (the deep series) and
# element 1 (further: NaN-poisoned in 3D; in 2D float32 cannot resolve C_e's
# small eigenvalue that far, and the deep series takes it) through
# Fp^-1 = diag(x, 1[, 1]), by dimension
LOG_STRETCH = {2: (12.0, 1e8), 3: (6.0, 1e5)}
# A finite-strain kernel forms the trial state in its own float32 rounding
# (inverses, a cube root or a log series), so at a point right at the yield
# surface it may take the other branch than the plain version: the stress
# is continuous there, the tangent is not.  compare_kernels leaves such
# points out of the planes' bar, after checking that the plain trial state
# lies within YIELD_BAND of the flow stress at each of them.
YIELD_BAND = 1e-4
# The first Newton system's residual r = f_ext - f_int(u) - M a of a
# finite-strain drive, kernel path against plain path, by material (1e-4
# for every other).  Near equilibrium r is a small difference of element
# forces, so float32 fixes it only to ~1e-3 of max|r|: the plain path in
# float32 against float64 at the same carry read 2.6e-4 to 2.2e-3 at
# 128^2 and 512^2, for both materials, and the kernel path the same.
# Kernel against plain in float32 read 6.5e-6 to 4.0e-5 for J2Simo, and
# 3.6e-5 to 1.7e-4 for J2Log, whose log series rounds C_e ~ I in its own
# order; the plain path at the carry rounded to bfloat16 reads 5 to 17
# (finite_witness.py, NVIDIA H100 80GB HBM3).  J w keeps 1e-4.
NEWTON_R_BAR = {"J2Log": 1e-3}
# Phases 43-47: J2Linear and the PowerLaw and Voce hardening laws.
# J2Linear: E 2100, nu 0.3, density 1, the hardening moduli of the
# reference's tests/test_materials.py:256-260 (isotropic 50, kinematic 30),
# yield stress 5: its kernel test's 0 leaves every point perfectly plastic,
# where the deviatoric tangent vanishes and the elastic FDM preconditioner
# has nothing to precondition.  Path C: the body-force cube at 48^3 (face
# 1 clamped, body force -3) with J2Linear, the sf kernels with the Cauchy
# storage; path D: the golden cantilever's mesh at 512^2 p = 3 (boundary 2
# clamped, body force -3) with J2Linear, the dense (2, 3) kernels, the 2D
# step settings; path E: the 48^3 cube with J2 and the reference's
# PowerLaw (sigma_y 10, n 2, eps0 1e-3; tests/test_pallas.py:397-440), body
# force -5.  All at dt 0.05 (the J2 cantilever's dt 0.5 does not converge
# refined), 1 warm + PATH_TIMED timed steps; C and E must leave eqps > 0 at
# YIELD_SHARE of the points.  Phase 47's steps lower the yield stress to
# SMALL_SIGMA_Y so that the first step yields at 16^3 and 64^2.
J2LIN_MODULI = (50.0, 30.0)  # isotropic, kinematic
J2LIN_SIGMA_Y = 5.0
POWER_LAW = (10.0, 2.0, 1e-3)  # sigma_y, n, eps0
VOCE_LAW = (10.0, 30.0, 0.02)  # sigma_y, sigma_sat, strain constant
PATH_DT = 0.05
PATH_TIMED = 2
YIELD_SHARE = 0.01
SMALL_SIGMA_Y = 1.0
# |F - I| of phase 43's random plastic input, per element: for J2Linear
# (yield strain ~2e-3) a mixed share of elastic and plastic points; for the
# laws 0.1, as phases 13 and 23 take: at 0.02 J2Log's C_e ~ I leaves its
# sf residual, a small difference of rounded stresses, at 3e-5 of its scale
# against plain (NVIDIA H100 80GB HBM3)
J2LIN_AMPLITUDE = 0.006
LAW_AMPLITUDE = 0.1
# The viscous neo-Hookean contact presses (phases 38-42): the material of
# tests/test_contact.py:154-158 and the examples (examples/toy_problem.py:
# 40-43, multipatch_contact.py:40-44): CompressibleOgdenNeoHookean, E 1e6,
# nu 0.3, density 1e3, viscosity 100, penalty 5e7; dt 0.01, rho_inf 0.5,
# float32; the contact press's step settings with the default (frozen)
# contact tangent.  Path A, the 2D two-patch press of
# examples/multipatch_contact.py: two-patch-square.mesh elevated to p = 2
# and subdivided 9 times, 2 x 512^2 = 524,288 elements, the bottom edge
# clamped, the top edge (both patches) against a flat tool pushed down
# 0.005 per step.  Path B, the cube press of tests/test_contact.py:146-196
# at the bench's size: cube-nurbs.mesh at p = 2, 48^3, the bottom face
# clamped, the top face against the bilinear tool pushed down 0.01 per
# step, a bfloat16 block.  Both tools start touching the body (the
# example's 1.02 leaves four steps untouched), so the warm step and the
# timed steps are engaged.
# Phases 54-57: the cubic (p = 3) 3D sweeps.  Path H: the body-force cube of
# the main path (J2 Johnson-Cook A 70 / B 140, face 1 clamped, body force
# -3, dt 0.05, 4 line-search Newton iterations, FDM-GMRES(30, 40) at 1e-3)
# on the reference's own cubic mesh, cube-nurbs-3.mesh
# (tests/test_mesh_refinement.py:47-54), refined to 48^3 = 110,592
# elements of 64 dofs and 125 points, 397,953 unknowns: the sf kernels at
# (p + 1, n_g) = (4, 5), 1 warm + P3_TIMED steps.  Path I: the neo-Hookean
# two-patch cube of phases 13-16 (tests/test_multipatch.py:123-163: E 2100,
# nu 0.3, the x = 0 face clamped, body force -5) elevated by 2 to p = 3 at
# 2 x 38^3 = 109,744 elements, 408,483 unknowns, the body-force path's step
# settings: the dense (3, 3) kernels with the symmetric block and the
# additive-Schwarz FDM, 1 warm + P3_DENSE_TIMED steps.  At path I's size
# the plain versions would hold (nd, dim, dim, n_q, n_el) products of
# ~32 GB: the sweeps are per element, so on both paths their plain twins run
# on P3_PARTS contiguous slices of the elements, the kernels' outputs held
# slice by slice and the plain version's time summed over the slices.
MESH3 = os.path.join(ROOT, "tests", "data", "cube-nurbs-3.mesh")
P3_TIMED = 2
P3_DENSE_TIMED = 1  # path I's steps take ~10x path H's
P3_PARTS = 4
P3_RAGGED = 33  # the sf residual kernel's tiles of 32: one full, one of 1
TWO_SQUARE = os.path.join(ROOT, "tests", "data", "two-patch-square.mesh")
PRESS_2D_SUBDIVIDE = 9  # 2 x 512^2 elements
PRESS_2D_HELD = 6  # the held step: 2 x 64^2
PRESS_TIMED = 2  # timed steps after the warm one on each press (A and B)
PRESS_F_TIMED = 2  # on paths F and G
PRESS_STEP_KW = dict(dt=0.01, newton_iters=12, solver="cg", cg_iters=80, precond="fdm",
                     lin_rel_tol=1e-2, rel_tol=1e-3)
PRESS_PUSH = {2: [0.0, -0.005], 3: [0.0, 0.0, -0.01]}
# viscosity of the viscous instantiations' checks on random input where
# the material has none (the presses' own)
VISC_MU = 100.0
# the (viscous, bfloat16 block) instantiations held per table kind beside a
# hyperelastic material's inviscid float32 ones
VISC_COMBOS = {"dense": ((True, False),), "sf": ((True, False), (True, True), (False, True))}
FUSED_KERNELS = [  # (counter name, TPU kernel it replaces)
    ("neohookean_tangent_apply", "mimi_tpu/ops/pallas_residual.py:171"),
    ("neohookean_residual", "mimi_tpu/ops/pallas_residual.py:207"),
]
# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and float32
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# Arithmetic per quadrature point that each FUNCTION needs (a multiply and
# an add as two operations, a transcendental as one), not what a kernel's
# loop body happens to do.  The radial return's iterations are not counted:
# how many a point needs was not measured (the kernels run a fixed cap of
# 100), so the plastic rows' bounds leave them out and stay lower bounds.
#
# Sum-factorized tables (p = 2: 3 nodes and 4 points per axis).  The
# function is defined on 1D factors, so interpolation and scatter are
# counted as staged 1D contractions, per element and vector component:
#   x: B and D on (3,3,3) -> 2 arrays (4,3,3):  2 * 36 * 3 * 2  =  432
#   y: DB, BD, BB          -> 3 arrays (4,4,3):  3 * 48 * 3 * 2  =  864
#   z: DBB, BDB, BBD       -> 3 arrays (4,4,4):  3 * 64 * 3 * 2  = 1152
# = 2448; three components over 64 points: 115 per point for a gradient,
# + 18 for the values of the same field (BBB, one more z array), 42 for
# the values of another field (216 + 288 + 384 per component).  The
# scatter is the transpose and costs the same.  The sf kernels instead
# form the 27 basis products at every point and contract densely (~1810
# per point for interpolation and scatter): that is the kernels' overhead
# and no part of their bound.
_SF_GRAD, _SF_SAME_VALUE, _SF_OTHER_VALUE = 115, 18, 42
_JINV = 45  # a 3 x 3 product with jinv (reference -> physical gradient, and back)
_SCALE = 15  # w det J on the 9 flux and 3 mass entries, rho on the 3 values
# residual: grad u, values of a, F = I + grad u, the scatter of flux and mass
_SF_RESIDUAL = (_SF_GRAD + _JINV + 3 + _SF_OTHER_VALUE + _SCALE + _JINV + _SF_GRAD
                + _SF_SAME_VALUE)
# matvec: gradient and values of w, the same scatter
_SF_MATVEC = 2 * (_SF_GRAD + _SF_SAME_VALUE + _JINV) + _SCALE
_SF_VISCOUS = _SF_GRAD + _JINV + 18  # grad v and P += mu_v grad v
# the materials, counted from materials.cuh and sweeps_sf.cu: stress,
# tangent planes, tangent apply
_J2_STRESS = 230  # elastic predictor, yield test, sigma, det F, F^-1, P = J sigma F^-T
_J2_TANGENT = 170  # the 21 D-hat planes
_CAUCHY_APPLY = 330  # D-hat : sym dF, P, tr(F^-1 dF), dF^T F^-T, dP
_NH_STRESS, _NH_TANGENT = 190, 590
_STVK_STRESS, _STVK_TANGENT = 115, 870
_SYM_APPLY = 170  # 45 planes as a symmetric 9 x 9 product, fac0
# The finite-strain materials (sweeps_sf_finite.cu), counted from their
# bodies: J2Simo's two 3 x 3 inverses, cube root, be = f be_old f^T, the
# deviators, the return's one-time residuals and P = tau F^-T; J2Log's
# F_e^T F_e, the fast log (2 square roots of 7 Denman-Beavers iterations,
# two inverses each, and 8 Gregory terms: ~2560), deviator and
# P = J (s + p/J) F^-T.  A tangent pass is the same body on dual numbers:
# a product is 4 operations instead of 1, a sum 2, a quotient ~5, so ~3x
# the stress; the assemble runs 9.  The full apply: 81 products and sums,
# fac0.
_SIMO_STRESS, _SIMO_PASS = 490, 1300
_LOG_STRESS, _LOG_PASS = 2900, 8500
_FULL_APPLY = 170
OPS_PER_POINT = {
    "residual_sf": _SF_RESIDUAL + _J2_STRESS,
    "assemble_sf": _SF_RESIDUAL + _J2_STRESS + _J2_TANGENT,
    "matvec_sf": _SF_MATVEC + _CAUCHY_APPLY,
    "residual_sf[visc]": _SF_RESIDUAL + _SF_VISCOUS + _J2_STRESS,
    "assemble_sf[visc,bf16]": _SF_RESIDUAL + _SF_VISCOUS + _J2_STRESS + _J2_TANGENT,
    "matvec_sf[visc,bf16]": _SF_MATVEC + _CAUCHY_APPLY + 18,
    "residual_sf[nh]": _SF_RESIDUAL + _NH_STRESS,
    "assemble_sf[nh,sym]": _SF_RESIDUAL + _NH_STRESS + _NH_TANGENT,
    "matvec_sf[sym]": _SF_MATVEC + _SYM_APPLY,
    "residual_sf[stvk]": _SF_RESIDUAL + _STVK_STRESS,
    "assemble_sf[stvk,sym]": _SF_RESIDUAL + _STVK_STRESS + _STVK_TANGENT,
    "residual_sf[simo]": _SF_RESIDUAL + _SIMO_STRESS,
    "assemble_sf[simo,full]": _SF_RESIDUAL + _SIMO_STRESS + 9 * _SIMO_PASS,
    "residual_sf[log]": _SF_RESIDUAL + _LOG_STRESS,
    "assemble_sf[log,full]": _SF_RESIDUAL + _LOG_STRESS + 9 * _LOG_PASS,
    "matvec_sf[full]": _SF_MATVEC + _FULL_APPLY,
    # Dense tables: the function is defined on dN (27, 3) and N (27) per
    # point, so the 27-node contractions are its own work (gradient 486,
    # values 162, scatter 648), then the material as above.
    "residual_dense": 1570, "assemble_dense[sym]": 2080, "matvec_dense[sym]": 1630,
    "residual_dense[stvk]": 1500, "assemble_dense[stvk,sym]": 2370,
    # two gradients, F^-1, three 3 x 3 products, the scatter; no N table
    "neohookean_residual": 1250, "neohookean_tangent_apply": 1780,
}
# The dense rows of other (dim, p) and of J2, from dense_ops: per point the
# dim x nd gradient (2 dim^2 nd), the values (2 dim nd) and the scatter of
# flux and mass ((2 dim + 2) dim nd) of the function on dN and N, then the
# material, counted from its body: (stress, tangent planes, tangent
# apply) by material tag and dim.  J2's 2D stress: strain, deviator over
# trace / 2, norm, the return's one-time residual, sigma, det, inverse and
# J sigma F^-T; its 6 D-hat planes; the 2D Cauchy apply (D-hat : sym dF,
# P, tr(F^-1 dF), dF^T F^-T, dP).  The radial return's iterations are not
# counted (see above).
# The finite-strain materials on dense tables (finite.cuh): 3D as on the
# sf tables above; 2D counted from the same bodies on 2 x 2 tensors:
# J2Simo's stress ~150 (two 2 x 2 inverses, cube root, be = f be_old f^T,
# deviators, the return's one-time residual, P = tau F^-T), J2Log's ~800
# (the fast log: 2 square roots of 7 Denman-Beavers iterations, ~480, and
# 7 Gregory terms); a dual pass ~3x the stress, 4 passes; the 16-plane
# apply 32.
# J2Linear (csrc/j2.cuh j2_linear_cauchy): J2's trial state, eta = s - beta,
# its norm, phi, the increment, eta / |eta| and sigma, det F, F^-1 and
# J sigma F^-T (3D ~250, 2D ~125); its D-hat planes take dev(n) and the
# symmetrized n (x) dev(n) (3D ~200, 2D ~70); the Cauchy apply as J2's.
MATERIAL_OPS = {
    ("j2", 3): (_J2_STRESS, _J2_TANGENT, _CAUCHY_APPLY), ("j2", 2): (110, 60, 100),
    ("j2lin", 3): (250, 200, _CAUCHY_APPLY), ("j2lin", 2): (125, 70, 100),
    ("nh", 2): (60, 150, 36), ("stvk", 2): (40, 160, 36),
    ("nh", 3): (_NH_STRESS, _NH_TANGENT, _SYM_APPLY),
    ("stvk", 3): (_STVK_STRESS, _STVK_TANGENT, _SYM_APPLY),
    ("simo", 3): (_SIMO_STRESS, 9 * _SIMO_PASS, _FULL_APPLY),
    ("log", 3): (_LOG_STRESS, 9 * _LOG_PASS, _FULL_APPLY),
    ("simo", 2): (150, 4 * 450, 32), ("log", 2): (800, 4 * 2400, 32),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def jc_material(mt, A=70.0, name="J2"):
    """The J2-family material `name` with the Johnson-Cook temperature-
    and rate-dependent hardening of the reference's golden trajectories
    (tests/test_nonlinear_solid.py:26-42), yield stress A."""
    mat = getattr(mt, name)()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.heat_fraction = 0.9
    mat.set_young_poisson(2100.0, 0.3)
    h = mt.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = A, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


def build(mt, spans, device, name="J2", A=70.0):
    """The body-force cube at `spans` per axis: boundary 1 clamped, body
    force -3, the J2-family material `name` (J2 unless named)."""
    return cube_of(mt, jc_material(mt, A, name), spans, device)


def build_contact(mt, spans, device, name="J2", dtype=None):
    """The contact press: clamped bottom face, top face (bid 1) against a
    rigid bilinear Bezier tool at z = 1.02 (kappa 5e7), the J2-family
    material `name` (J2 unless named) with the Johnson-Cook law A 700,
    B 1400, E 1e6, nu 0.3, density 1e3, viscosity 100."""
    mat = press_finite_material(mt, name)
    scene = mt.NearestDistanceToSplines()
    scene.add_spline(mt.Bezier([1, 1], [[-0.5, -0.5, 1.02], [-0.5, 1.5, 1.02],
                                        [1.5, -0.5, 1.02], [1.5, 1.5, 1.02]]))
    scene.plant_kd_tree(max(spans, 8), 1)
    scene.coefficient = 5e7
    return mt.build_problem(
        MESH, 1, 0, mat, [(0, 0), (0, 1), (0, 2)], {}, rho_inf=0.5,
        device=device, dtype=dtype, refine_spans=spans,
        contact=[(1, scene)],
    )


def nbytes(*objs):
    """Bytes of the tensors in objs, nested in lists, tuples and dicts."""
    total = 0
    for o in objs:
        if isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
        elif o is not None:
            total += o.numel() * o.element_size()
    return total


def bound_of(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the larger of the bytes a call must
    move (inputs read once, outputs written once) over the memory rate and
    its operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, n_bytes, n_ops):
    """One entry of the kernels line, its bound from bound_of."""
    bound, by = bound_of(n_bytes, n_ops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            # no single PyTorch call computes a fused quadrature sweep
            "library_ms": None}


def ptxas_entries(log, nvcc):
    """{kernel: {"registers", "smem", "stack", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v output, the kernels' names demangled by the
    toolkit's cu++filt beside `nvcc` where it is found."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = entries.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    names = list(entries)
    if os.path.exists(filt) and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            return {re.sub(r"<unnamed>::|\(anonymous namespace\)::", "", d): entries[n]
                    for n, d in zip(names, out)}
    return entries


def check_sf_ptxas(kbuild):
    """Registers, shared memory and spills of every instantiation of the
    sf kernel template (sf_common.cuh sf_tile_kernel: one thread per element
    and point slot), at p = 2 and p = 3; fails where a matvec (SfMatvecPoint,
    any storage) or a J2-family Cauchy (J2Mat) or hyperelastic (Hyper)
    residual or assemble spills, with its own or the full block.  The
    finite-strain ones (J2SimoMat, J2LogMat: 9 dual-number passes per point)
    and the other kernels with the full block or at p = 3 are printed, not
    held."""
    if kbuild.BUILD_INFO["cached"]:
        say("[2. ptxas] the library was cached: no ptxas output in this run")
        return
    every = ptxas_entries(kbuild.BUILD_INFO["log"], kbuild.nvcc())
    ents = {n: v for n, v in every.items() if "sf_tile_kernel" in n}
    if not any("SfMatvecPoint" in n for n in ents) or not any("SfResidualPoint" in n
                                                              for n in ents):
        fail("no sf_tile_kernel matvec or residual instantiation in the ptxas output")
    for name, v in sorted(ents.items()):
        spilled = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        # cu++filt writes template arguments as (int)4, (bool)0; the
        # arguments after the template's ">" are cut
        name = re.sub(r"\((int|bool)\)", "", name.split(">(")[0] + ">")
        say(f"[2. ptxas] {name}: {v.get('registers')} registers, {v.get('smem')} B smem, "
            f"spill stores {v.get('spill_stores')} B, loads {v.get('spill_loads')} B, stack "
            f"{v.get('stack')} B")
        if spilled and ("SfMatvecPoint" in name or "J2Mat" in name or "Hyper" in name):
            fail(f"{name} spills {spilled} B")
    # the other kernels with the full block (the dense residual and matvec)
    # and at p = 3 (the tiled dense (3, 3) kernels): printed, not held
    for full_name, v in sorted(every.items()):
        name = re.sub(r"\((int|bool)\)", "", full_name.split("(const float")[0])
        p3 = "dense_tile_kernel<3, 3" in name
        if ("FullStorage" in name or p3) and full_name not in ents:
            say(f"[2. ptxas] {name}: {v.get('registers')} registers, {v.get('smem')} B smem, "
                f"spill stores {v.get('spill_stores')} B, loads {v.get('spill_loads')} B")


def plastic_points(soa, sweeps, prob, u_el, state, dt):
    """Quadrature points on the plastic branch of the J2 return map at the
    element displacements u_el."""
    F = soa.add_diag(sweeps.sf_grad(u_el, prob.sf["tables"], prob.sf["jinv"]), 1.0)
    return int(prob.material._return_map(F, state, dt)[4].sum())


# timed calls of a plain version after its warm call: the plain sweeps take
# 10 ms to 2 s, far above the events' resolution, and their time is a
# reference for the kernels' rows, not a result
PLAIN_REPS = 1


def twin(fn):
    """The plain sweep `fn` as its kernel's twin: the J2 family's radial
    return stops at the kernels' 40 trips (materials.kernel_solver_mode, the
    reference's Pallas-kernel mode); the "torch" engine's steps keep 100."""
    from mimi_tpu_torch.materials import kernel_solver_mode

    def run(*args, **kwargs):
        with kernel_solver_mode():
            return fn(*args, **kwargs)

    return run


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, state, label):
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max_abs_err} and fails past the stated tolerances."""
    mat = prob.material
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    args = (u_el, a_el, state, tabs, jinv, wq, mat, STEP_KW["dt"], float(mat.density))
    fac0 = prob.facs["fac3"] * STEP_KW["dt"] ** 2
    errs = {}
    y_k = sweeps.residual_sf(*args)
    torch.cuda.synchronize()
    y_p = twin(sweeps.residual_sf_plain)(*args)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs["residual_sf"] = err
    say(f"[{label}] residual: max|err| {err:.3e} scale {scale:.3e}")
    # float32 with another summation order (per-point basis products vs
    # staged einsums): a few ulps of the largest element entry
    if not err <= 1e-5 * scale:
        fail(f"residual kernel disagrees with plain ({err} > 1e-5 * {scale})")
    ya_k, C_k = sweeps.assemble_sf(*args)
    torch.cuda.synchronize()
    ya_p, C_p = twin(sweeps.assemble_sf_plain)(*args)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    # tangent block: each plane against the largest entry of its group
    # (D-hat, sigma, F^-1, J); a plane whose entries are all small, such as
    # a shear stress in a nearly uniaxial state, rounds at the scale of the
    # group's largest component, not at its own
    diff = (C_k - C_p).abs().amax(dim=(1, 2))
    mag = C_p.abs().amax(dim=(1, 2))
    rel = torch.cat([diff[a:b] / mag[a:b].max().clamp_min(1e-30)
                     for a, b in ((0, 21), (21, 27), (27, 36), (36, 37))])
    own = diff / mag.clamp_min(1e-30)
    errs["assemble_sf"] = max(err, float(diff.max()))
    say(f"[{label}] assemble: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"tangent worst plane err vs group max {float(rel.max()):.3e} "
        f"(plane {int(rel.argmax())}), vs own max {float(own.max()):.3e} "
        f"(plane {int(own.argmax())})")
    # float32; the kernel's closed-form tangent and the plain version's
    # forward-mode derivatives round differently, and float32 radial returns
    # stop on their iteration cap at slightly different increments
    if not err <= 1e-4 * scale:
        fail(f"assemble kernel residual disagrees ({err} > 1e-4 * {scale})")
    if not float(rel.max()) <= 1e-4:
        fail(f"assemble kernel tangent disagrees (plane err {float(rel.max())})")
    mv_k = sweeps.matvec_sf(w_el, tabs, jinv, wq, C_p, float(mat.density), fac0)
    torch.cuda.synchronize()
    mv_p = twin(sweeps.matvec_sf_plain)(w_el, tabs, jinv, wq, C_p, float(mat.density), fac0)
    err, scale = float((mv_k - mv_p).abs().max()), float(mv_p.abs().max())
    errs["matvec_sf"] = err
    say(f"[{label}] matvec: max|err| {err:.3e} scale {scale:.3e}")
    # float32, summation order
    if not err <= 1e-4 * scale:
        fail(f"matvec kernel disagrees with plain ({err} > 1e-4 * {scale})")
    return errs, C_p


def compare_variants(torch, sweeps, prob, f, dt, mu_v, label):
    """The contact path's kernel variants against their plain versions on
    the same inputs (`f`: u_el, a_el, v_el, w_el, state): the viscous
    residual, the viscous assemble with a bfloat16 tangent block, and the
    viscous matvec on the plain bfloat16 block.  Returns ({variant:
    max_abs_err}, the plain block); fails past the stated bars."""
    mat = prob.material
    tabs, jinv, wq = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    rho = float(mat.density)
    fac0 = prob.facs["fac3"] * dt * dt
    fac1_mu_v = prob.facs["fac4"] * dt * mu_v
    args = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, rho)
    visc = dict(v_el=f["v_el"], mu_v=mu_v)
    errs = {}
    y_k = sweeps.residual_sf(*args, **visc)
    torch.cuda.synchronize()
    y_p = twin(sweeps.residual_sf_plain)(*args, **visc)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs["residual_sf[visc]"] = err
    say(f"[{label}] residual[visc]: max|err| {err:.3e} scale {scale:.3e}")
    # float32, summation order (as the inviscid residual)
    if not err <= 1e-5 * scale:
        fail(f"viscous residual kernel disagrees ({err} > 1e-5 * {scale})")
    ya_k, C_k = sweeps.assemble_sf(*args, **visc, c_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ya_p, C_p = twin(sweeps.assemble_sf_plain)(*args, **visc, c_dtype=torch.bfloat16)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    if C_k.dtype != torch.bfloat16:
        fail(f"bfloat16 assemble wrote {C_k.dtype}")
    diff = (C_k.float() - C_p.float()).abs()
    rel = group_err(torch, C_k, C_p.double(), plane_groups(sweeps, "cauchy", 3))
    share = float((C_k != C_p).float().mean())
    errs["assemble_sf[visc,bf16]"] = max(err, float(diff.max()))
    say(f"[{label}] assemble[visc,bf16]: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"bf16 planes worst err vs group max {rel:.3e} (bar 2^-7 = {2.0**-7:.3e}, one "
        f"bf16 rounding step), share of entries that differ {share:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"viscous assemble kernel residual disagrees ({err} > 1e-4 * {scale})")
    # the float32 planes agree to ~1e-5 of their group's max (phase 3), so
    # a rounded pair can differ by at most one bfloat16 step
    if not rel <= 2.0**-7:
        fail(f"bfloat16 tangent planes disagree (err {rel} of group max)")
    mv_k = sweeps.matvec_sf(f["w_el"], tabs, jinv, wq, C_p, rho, fac0, fac1_mu_v)
    torch.cuda.synchronize()
    mv_p = twin(sweeps.matvec_sf_plain)(f["w_el"], tabs, jinv, wq, C_p, rho, fac0, fac1_mu_v)
    err, scale = float((mv_k - mv_p).abs().max()), float(mv_p.abs().max())
    errs["matvec_sf[visc,bf16]"] = err
    say(f"[{label}] matvec[visc,bf16] on one bf16 block: max|err| {err:.3e} scale {scale:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"viscous bfloat16 matvec kernel disagrees ({err} > 1e-4 * {scale})")
    return errs, C_p


def ragged_tile_phase(torch, mt, sweeps, soa, device, gen):
    """Phase 11b: J2's viscous residual and viscous assemble with a
    bfloat16 block (the contact press's variants) and the matvec on its
    block at RAGGED_SPANS^3 elements, where the residual kernel's last tile
    of 32 elements is partial, on random plastic input (plastic_inputs,
    share >= 0.25), against their plain versions at hold_viscous's bars,
    timed beside phase 11's rows."""
    prob = build(mt, RAGGED_SPANS, device)
    E, dt = prob.n_el, STEP_KW["dt"]
    f, share = plastic_inputs(torch, sweeps, soa, prob, prob.material, gen, dt, LAW_AMPLITUDE)
    label = f"11b. {RAGGED_SPANS}^3 ragged tile"
    say(f"[{label}] {E} elements, {E % 32} in the last tile of 32; |F - I| up to "
        f"{LAW_AMPLITUDE}; plastic share of the points {share:.3f}")
    if E % 32 == 0:
        fail(f"{RAGGED_SPANS}^3 fills every tile of 32: no ragged tile to check")
    if share < 0.25:
        fail(f"{label}: plastic share {share} < 0.25: the check would not exercise the return "
             "map")
    hold_viscous(torch, sweeps, prob, prob.material, f, dt, label, combos=((True, True),))
    del prob, f
    torch.cuda.empty_cache()


def contact_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 9-12: the kernel variants at 16^3, one engaged contact step
    cuda vs torch at 16^3, the contact path at 48^3 and its profile.
    Returns the variants' rows of the kernels line."""
    NDS = mt.NearestDistanceToSplines

    # ---- 9. variant kernels vs plain at 16^3 --------------------------------
    prob = build(mt, CHECK_SPANS, device)
    dt_ = prob.dtype
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, dt_)  # noqa: E731
    E, h = prob.n_el, 1.0 / CHECK_SPANS
    f = {"u_el": 0.06 * h * rnd(3, 27, E), "a_el": rnd(3, 27, E), "v_el": rnd(3, 27, E),
         "w_el": rnd(3, 27, E)}
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["eqps"] = 0.01 * torch.rand(64, E, generator=gen).to(device, dt_)
    state["temperature"] = 20.0 + 100.0 * torch.rand(64, E, generator=gen).to(device, dt_)
    f["state"] = state
    dF = sweeps.sf_grad(f["u_el"], prob.sf["tables"], prob.sf["jinv"])
    *_, active, _ = prob.material._return_map(soa.add_diag(dF, 1.0), state, STEP_KW["dt"])
    frac = float(active.float().mean())
    say(f"[9. 16^3 random] plastic fraction {frac:.3f}; v_el of a_el's scale, mu_v 10 "
        "(viscous and elastic-plastic flux of one size)")
    if frac < 0.25:
        fail(f"plastic fraction {frac} < 0.25: the check would not exercise the return map")
    compare_variants(torch, sweeps, prob, f, STEP_KW["dt"], 10.0, "9. 16^3 random")
    del prob, f, state, dF, active

    # ---- 10. one engaged contact step at 16^3: cuda vs torch -----------------
    prob = build_contact(mt, CHECK_SPANS, device)
    carry0 = mt.initial_carry(prob)
    # tool from z = 1.02 to touching (1.00), then the step's own push
    sd = NDS.translate_scene_data(prob.contact[0]["scene"], [0.0, 0.0, -0.02])
    sd = NDS.translate_scene_data(sd, PUSH)
    steps = {impl: mt.make_step(prob, residual_impl=impl, **CONTACT_STEP_KW)
             for impl in ("cuda", "torch")}
    out = {impl: steps[impl](carry0, contact_scenes=[sd]) for impl in steps}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    cc, ct = out["cuda"]["contact"][0], out["torch"]["contact"][0]
    say(f"[10. 16^3 contact step] cuda vs torch, both bf16 tangent, tool at z 0.99: "
        f"max|du| {err:.3e} max|u| {scale:.3e} (ratio {err / scale:.2e}); newton "
        f"{nc['iters']}/{nt['iters']} gmres {nc['lin_iters']}/{nt['lin_iters']} converged "
        f"{nc['converged']}/{nt['converged']} (|r| {nc['norm']:.3e}/{nt['norm']:.3e} of "
        f"|r0| {nt['norm0']:.3e}); penetrating {int(cc['n_penetrating'])}/"
        f"{int(ct['n_penetrating'])}, pass the float32 angle gate {int(cc['n_engaged'])}/"
        f"{int(ct['n_engaged'])}")
    if int(ct["n_penetrating"]) == 0:
        fail("the 16^3 contact step is not engaged")
    # Which penetrating points pass the reference's angle gate
    # (arccos(ratio) > 1e-5, below float32's arccos resolution of 3.45e-4
    # rad) turns on rounding of the foot point, so two engines whose
    # iterates differ by rounding settle on different contact sets and
    # their converged steps differ far above the reference's 1e-4 bar; no
    # Newton tolerance closes that gap (the gated contact residual has a
    # float32 floor near rel_tol).  The engines are held against each other
    # on the first Newton system of the next step instead, assembled from
    # one carry, where both see the same contact set: the residual at the
    # assemble bar, J w within one bfloat16 step of its scale (each engine
    # rounds its own tangent block).
    sd2 = NDS.translate_scene_data(sd, PUSH)
    w = torch.randn(prob.n_dof * prob.dim, generator=gen).to(device, prob.dtype)
    ns = {impl: steps[impl].newton_system(out["torch"], contact_scenes=[sd2])
          for impl in steps}
    r_err = float((ns["cuda"]["r"] - ns["torch"]["r"]).abs().max())
    r_scale = float(ns["torch"]["r"].abs().max())
    jw = {impl: ns[impl]["J_apply"](w) for impl in steps}
    jw_err = float((jw["cuda"] - jw["torch"]).abs().max())
    jw_scale = float(jw["torch"].abs().max())
    say(f"[10. 16^3 contact Newton system] cuda vs torch from the torch step's carry, "
        f"tool at z 0.98: residual max|err| {r_err:.3e} scale {r_scale:.3e}; J w max|err| "
        f"{jw_err:.3e} scale {jw_scale:.3e}")
    if not r_err <= 1e-4 * r_scale:
        fail(f"contact Newton residual parity {r_err} > 1e-4 * {r_scale}")
    if not jw_err <= 2.0**-7 * jw_scale:
        fail(f"contact J w parity {jw_err} > 2^-7 * {jw_scale}")
    del prob, carry0, out, steps, ns, jw, w
    torch.cuda.empty_cache()

    # ---- 11. the contact path at 48^3 ---------------------------------------
    sweeps.reset_launches()
    t0 = time.perf_counter()
    prob = build_contact(mt, SPANS, device)
    torch.cuda.synchronize()
    cd = prob.contact[0]
    n_fq = cd["wq"].numel()
    say(f"[11. 48^3 contact] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, "
        f"unknowns {prob.n_dof * prob.dim}, contact faces {cd['conn'].shape[0]}, face "
        f"quadrature points {n_fq}, mortar dofs {prob.contact_static[0]['n_local']}")
    query = prob.contact_static[0]["query"]
    n_proj = [0]

    def counted_query(*a):  # counts closest-point projections per step
        n_proj[0] += 1
        return query(*a)

    prob.contact_static[0]["query"] = counted_query
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[11. 48^3 contact] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **CONTACT_STEP_KW)
    sd = cd["scene"]
    times, diags, penetrating, all_diags = [], [], [], []
    for i in range(1 + CONTACT_TIMED_STEPS):
        sd = NDS.translate_scene_data(sd, PUSH)  # on the device
        p0 = n_proj[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=[sd])
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        d, c = carry["newton"], carry["contact"][0]
        eqps = carry["state"]["eqps"]
        force = (-c["res_el"].sum((0, 1))).tolist()
        tool_z = float(sd[0]["cps"][0, 2])
        say(f"[11. 48^3 contact] step {i} ({'warm' if i == 0 else 'timed'}), tool z "
            f"{tool_z:.4f}: {t_s:.3f} s; newton {d['iters']} gmres {d['lin_iters']} "
            f"converged {d['converged']} (|r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e}); "
            f"projections {n_proj[0] - p0}; proj_unconverged {int(c['proj_unconverged'])} "
            f"proj_res_max {float(c['proj_res_max']):.3e}; penetrating (true_g < 0) "
            f"{int(c['n_penetrating'])} of {n_fq}, of those pass the angle gate "
            f"{int(c['n_engaged'])}; force from the traction residual "
            f"({force[0]:.4e}, {force[1]:.4e}, {force[2]:.4e}), observable 'force' z "
            f"{float(c['force'][2]):.4e}; 'area' (the deformed face area, not a contact "
            f"area) {float(c['area']):.6f}; eqps max {float(eqps.max()):.4e}, plastic "
            f"points {int((eqps > 0).sum())}; max|u| {float(carry['u'].abs().max()):.4e}")
        if not d["finite"]:
            fail(f"non-finite state at contact step {i}")
        all_diags.append(d)
        if i > 0:
            times.append(t_s)
            diags.append(d)
            penetrating.append(int(c["n_penetrating"]))
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    say(f"[11. 48^3 contact] {s_step:.4f} s/step over {len(times)} timed steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); newton iters "
        f"{[d['iters'] for d in diags]}; gmres iters {[d['lin_iters'] for d in diags]}; "
        f"launches { {k: n for k, n in launches.items() if n} }")
    # Newton: converged (rel_tol 1e-3), or down to the float32 floor of the
    # gated contact residual (|r| <= 2e-2 |r0|: rounding flips points
    # across the reference's angle gate, each worth ~kappa g w det J), or
    # a step whose |r0| is itself rounding (the tool exactly touching the
    # face: below 1e-6 of the run's largest |r0|)
    r0_max = max(d["norm0"] for d in all_diags)
    for i, d in enumerate(all_diags):
        if not (d["converged"] or d["norm"] <= 2e-2 * d["norm0"]
                or d["norm0"] <= 1e-6 * r0_max):
            fail(f"contact step {i}: Newton stopped at |r| {d['norm']} of |r0| {d['norm0']}")
    # the body may rebound from the tool after the impact (density 1e3,
    # 1 m/s tool speed), so engagement is asked of the timed steps
    # together, not of the last one
    if max(penetrating) == 0:
        fail("no face quadrature point penetrated the tool by the last timed step")
    for name, _ in VARIANTS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the contact path")

    # the variants against plain, and their times, at the path's state: the
    # predictor of the next step, the first assemble's input (after the
    # accumulate, the yielded points sit on the yield surface, where float32
    # rounding picks the elastic or the plastic tangent)
    g, _ = sh._gather_scatter(prob)
    mu_v, dt = float(prob.material.viscosity), CONTACT_STEP_KW["dt"]
    fc = prob.facs
    xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
    va = carry["v"] + fc["fac2"] * dt * carry["a"]
    f = {"u_el": g(xa), "a_el": g(carry["a"]), "v_el": g(va),
         "w_el": rnd(3, 27, prob.n_el), "state": carry["state"]}
    del xa, va
    errs, Cb = compare_variants(torch, sweeps, prob, f, dt, mu_v, "11. 48^3 contact path")
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    rho = float(mat.density)
    fac0 = prob.facs["fac3"] * dt * dt
    fac1_mu_v = prob.facs["fac4"] * dt * mu_v
    args = (f["u_el"], f["a_el"], f["state"], tabs, jinv, wq, mat, dt, rho)
    visc = dict(v_el=f["v_el"], mu_v=mu_v)
    bf16 = torch.bfloat16
    calls = {
        "residual_sf[visc]": (lambda: sweeps.residual_sf(*args, **visc),
                              lambda: twin(sweeps.residual_sf_plain)(*args, **visc)),
        "assemble_sf[visc,bf16]": (
            lambda: sweeps.assemble_sf(*args, **visc, c_dtype=bf16),
            lambda: twin(sweeps.assemble_sf_plain)(*args, **visc, c_dtype=bf16)),
        "matvec_sf[visc,bf16]": (
            lambda: sweeps.matvec_sf(f["w_el"], tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v),
            lambda: twin(sweeps.matvec_sf_plain)(f["w_el"], tabs, jinv, wq, Cb, rho, fac0,
                                           fac1_mu_v)),
    }
    n_pts = prob.n_el * prob.n_q
    n_plastic = plastic_points(soa, sweeps, prob, f["u_el"], f["state"], dt)
    el_out = 3 * 27 * prob.n_el * 4
    byts = {  # inputs read once, outputs written once
        "residual_sf[visc]": nbytes(f["u_el"], f["a_el"], f["v_el"], tabs, jinv, wq,
                                    f["state"]) + el_out,
        "assemble_sf[visc,bf16]": nbytes(f["u_el"], f["a_el"], f["v_el"], tabs, jinv, wq,
                                         f["state"], Cb) + el_out,
        "matvec_sf[visc,bf16]": nbytes(f["w_el"], tabs, jinv, wq, Cb) + el_out,
    }
    rows = []
    for name, replaces in VARIANTS:
        kern, plain = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        row = kernel_row(name, SOURCE[0], replaces, launches[name], errs[name], ms,
                         plain_ms, byts[name], n_pts * OPS_PER_POINT[name])
        say(f"[11. 48^3 timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({byts[name] / 1e9:.3f} GB, "
            f"{n_plastic} plastic points); {byts[name] / ms / 1e9:.3f} TB/s")
        rows.append(row)
    cap_share(torch, "48. 48^3 contact path", lambda: sweeps.residual_sf_plain(*args, **visc))
    del f, Cb, calls
    ragged_tile_phase(torch, mt, sweeps, soa, device, gen)

    # ---- 12. where one contact step's time goes (torch.profiler) -----------
    from torch.profiler import ProfilerActivity, profile

    sd = NDS.translate_scene_data(sd, PUSH)
    p0 = n_proj[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=[sd])
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    d = carry["newton"]
    ev = device_times(prof)
    busy = sum(t for _, _, t in ev)
    if busy > 0:
        say(f"[12. 48^3 contact profile] one step (newton {d['iters']}, gmres "
            f"{d['lin_iters']}, projections {n_proj[0] - p0}): device busy {busy:.1f} ms of "
            f"the profiled step's {t_prof:.1f} ms wall; idle share {1.0 - busy / t_prof:.3f} "
            f"(the profiler slows the host, so this overstates idling); timed mean "
            f"{s_step * 1e3:.1f} ms/step")
        for key, n, t in sorted(ev, key=lambda x: -x[2])[:12]:
            say(f"[12. 48^3 contact profile]   {t:9.3f} ms  x{n:<5d} {key[:90]}")
    else:
        say("[12. 48^3 contact profile] device time not visible to torch.profiler: "
            "not measured")
    # the closest-point projection alone, at the path's last state
    cur = carry["u"][cd["conn"]] + cd["x_ref_el"]
    qpts = torch.einsum("eqn,end->eqd", cd["N"], cur).reshape(-1, prob.dim)
    query(qpts, sd)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = query(qpts, sd)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        query(qpts, sd)
        torch.cuda.synchronize()
    q_dev = sum(t for _, _, t in device_times(prof))
    say(f"[12. 48^3 contact profile] closest-point projection of {qpts.shape[0]} points: "
        f"wall {sorted(walls)[2]:.3f} ms (median of 5), device busy "
        f"{q_dev:.3f} ms; unconverged {int((~res['converged']).sum())}")
    return rows


def hyper_material(mt, name="CompressibleOgdenNeoHookean"):
    """A hyperelastic material of the port by class name: E 2100, nu 0.3,
    density 1, no viscosity."""
    mat = getattr(mt, name)()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    return mat


def dense_build(mt, spans, device, name="CompressibleOgdenNeoHookean", A=70.0, dtype=None):
    """The two-patch cantilever at `spans` per patch and axis (neo-Hookean
    unless another hyperelastic material or a J2-family one, yield stress
    A, is named)."""
    mat = jc_material(mt, A, name) if name.startswith("J2") else hyper_material(mt, name)
    return shared_build(mt, mat, 3, TWO_PATCH, 1, 0, [(0, 0), (0, 1), (0, 2)], -5.0, device,
                        spans, dtype)


def hyper_build(mt, spans, device, name="CompressibleOgdenNeoHookean"):
    """The hyperelastic cube (neo-Hookean unless another material is
    named): one patch at `spans` per axis, boundary 1 clamped, body force
    -3 in y."""
    return cube_of(mt, hyper_material(mt, name), spans, device)


def sym_sweeps(sweeps, prob):
    """(kind, tables, kernel wrappers, plain versions) of the problem's
    three sweeps."""
    if prob.sf is not None:
        kind, tables = "sf", (prob.sf["tables"], prob.sf["jinv"])
    else:
        kind, tables = "dense", (prob.dense["dN_t"], prob.dense["N_t"])
    fns = [getattr(sweeps, f"{n}_{kind}") for n in ("residual", "assemble", "matvec")]
    plain = [twin(getattr(sweeps, f"{n}_{kind}_plain")) for n in ("residual", "assemble", "matvec")]
    return kind, tables, fns, plain


def sym_names(sweeps, kind, mat):
    """Counter names (residual, assemble, matvec) of a hyperelastic
    material's kernels on `kind` tables."""
    tag = sweeps.HYPER_KERNELS[mat.name()][1]
    return [*sweeps.material_counters(kind, tag), f"matvec_{kind}[sym]"]


def near_identity(torch, grad, u_el, amplitude=0.1):
    """u_el with each element scaled so that its largest |F - I|
    (Frobenius) is `amplitude`: strains up to 10%, where mu (F - F^-T)
    cancels most in float32.  Returns (u_el, |F - I| per point)."""
    strain = lambda u: torch.linalg.vector_norm(grad(u), dim=(0, 1))  # noqa: E731
    u_el = u_el * (amplitude / strain(u_el).amax(0))
    return u_el, strain(u_el)


def compare_sym(torch, sweeps, prob, u_el, a_el, w_el, label):
    """Each kernel of the problem's hyperelastic material with the
    symmetric storage against its plain version on the same inputs, on the
    problem's tables; returns ({kernel: max_abs_err}, the plain tangent
    planes) and fails past the stated tolerances."""
    mat = prob.material
    kind, tables, (res, asm, mv), (res_p, asm_p, mv_p) = sym_sweeps(sweeps, prob)
    n_res, n_asm, n_mv = sym_names(sweeps, kind, mat)
    wq = prob.wdet_t
    args = (u_el, a_el, None, *tables, wq, mat, STEP_KW["dt"], float(mat.density))
    fac0 = prob.facs["fac3"] * STEP_KW["dt"] ** 2
    errs = {}
    y_k = res(*args)
    torch.cuda.synchronize()
    y_p = res_p(*args)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    errs[n_res] = err
    say(f"[{label}] {n_res}: max|err| {err:.3e} scale {scale:.3e} ({err / scale:.3e})")
    # float32.  Dense tables: F and P agree to the bit (no FMA, the plain
    # version's operation order), the quadrature sums run in another
    # order.  Sum-factorized tables: F itself differs by rounding of
    # grad u (per-point basis products against staged einsums), so some
    # components of F = I + grad u land on neighbouring float32 grid values
    # of 1, each worth (lambda + 2 mu) 1.2e-7 in P whatever the strain:
    # 4e-7 of scale at strains of 1-10%, 5e-6 near equilibrium (strains of
    # ~1e-3, the 48^3 path's state), both inside the bar
    if not err <= 1e-5 * scale:
        fail(f"{n_res} disagrees with plain ({err} > 1e-5 * {scale})")
    ya_k, C_k = asm(*args)
    torch.cuda.synchronize()
    ya_p, C_p = asm_p(*args)
    err, scale = float((ya_k - ya_p).abs().max()), float(ya_p.abs().max())
    c_err, c_scale = float((C_k - C_p).abs().max()), float(C_p.abs().max())
    errs[n_asm] = max(err, c_err)
    say(f"[{label}] {n_asm}: residual max|err| {err:.3e} scale {scale:.3e}; "
        f"45 planes max|err| {c_err:.3e} of max {c_scale:.3e} ({c_err / c_scale:.3e})")
    if not err <= 1e-4 * scale:
        fail(f"{n_asm} residual disagrees ({err} > 1e-4 * {scale})")
    # the closed-form tangent against the plain version's forward-mode
    # planes, float32
    if not c_err <= 1e-4 * c_scale:
        fail(f"{n_asm} tangent disagrees ({c_err} > 1e-4 * {c_scale})")
    mv_k = mv(w_el, *tables, wq, C_p, float(mat.density), fac0, storage="sym")
    torch.cuda.synchronize()
    mv_pl = mv_p(w_el, *tables, wq, C_p, float(mat.density), fac0, storage="sym")
    err, scale = float((mv_k - mv_pl).abs().max()), float(mv_pl.abs().max())
    errs[n_mv] = err
    say(f"[{label}] {n_mv}: max|err| {err:.3e} scale {scale:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"{n_mv} disagrees with plain ({err} > 1e-4 * {scale})")
    return errs, C_p


def time_sym(torch, sweeps, prob, u_el, a_el, w_el, Cs, names, launches, errs, label):
    """Rows of the kernels line for the hyperelastic kernels in `names`
    (a subset of the three of the problem's material) at the problem's
    size: CUDA-event times of kernel and plain version, bytes and bound."""
    mat = prob.material
    kind, tables, fns, plain = sym_sweeps(sweeps, prob)
    wq, rho, dt = prob.wdet_t, float(mat.density), STEP_KW["dt"]
    fac0 = prob.facs["fac3"] * dt * dt
    args = (u_el, a_el, None, *tables, wq, mat, dt, rho)
    mv_args = (w_el, *tables, wq, Cs, rho, fac0)
    el_out = 3 * 27 * prob.n_el * 4
    byts = [  # inputs read once, outputs written once
        nbytes(u_el, a_el, tables, wq) + el_out,
        nbytes(u_el, a_el, tables, wq, Cs) + el_out,
        nbytes(w_el, tables, wq, Cs) + el_out,
    ]
    n_pts = prob.n_el * prob.n_q
    rows = []
    for i, (name, replaces) in enumerate(zip(sym_names(sweeps, kind, mat), SYM_REPLACES[kind])):
        if name not in names:
            continue
        a, kw = (mv_args, {"storage": "sym"}) if i == 2 else (args, {})
        ms = cuda_ms(torch, lambda: fns[i](*a, **kw), 20)
        plain_ms = cuda_ms(torch, lambda: plain[i](*a, **kw), PLAIN_REPS)
        row = kernel_row(name, SOURCE[6 if kind == "sf" else 1], replaces, launches[name],
                         errs[name], ms, plain_ms, byts[i], n_pts * OPS_PER_POINT[name])
        say(f"[{label}] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"{byts[i] / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
            f"{byts[i] / ms / 1e9:.3f} TB/s ({byts[i] / ms / 1e9 / (HBM_BPS / 1e12):.2f} "
            f"of 3.35)")
        rows.append(row)
    return rows


def drive(torch, mt, sweeps, prob, label, timed, kernels):
    """The default engine's path on `prob`: the initial carry, one warm
    and `timed` timed steps.  Fails unless every kernel in `kernels` was
    launched in each step, the state stayed finite and each timed step's
    Newton residual fell four orders (rel_tol 1e-8 is below float32
    resolution).  Returns (carry, step, s/step, launches)."""
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[{label}] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **STEP_KW)
    t0 = time.perf_counter()
    carry = step(carry)
    torch.cuda.synchronize()
    say(f"[{label}] warm step {time.perf_counter() - t0:.3f} s {carry['newton']}")
    times, diags = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        diags.append(carry["newton"])
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    qp_rate = prob.n_el * prob.n_q * RES_EVALS_PER_STEP / s_step
    say(f"[{label}] {s_step:.4f} s/step over {timed} steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); {qp_rate:.4e} qp-evals/s; newton iters "
        f"{[d['iters'] for d in diags]}; gmres iters {[d['lin_iters'] for d in diags]}; "
        f"max|u| {float(carry['u'].abs().max()):.4e}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for d in diags:
        say(f"[{label}] newton |r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e} "
            f"(ratio {d['norm'] / d['norm0']:.2e})")
    for name in kernels:  # at least once in each of the 1 + timed steps
        if launches[name] < 1 + timed:
            fail(f"kernel {name} was launched {launches[name]} times in {1 + timed} steps "
                 f"of {label}")
    if not all(d["finite"] for d in diags):
        fail(f"non-finite state on {label}")
    for d in diags:
        if not (math.isfinite(d["norm"]) and d["norm"] <= 1e-4 * d["norm0"]):
            fail(f"{label}: Newton did not converge: |r| {d['norm']} vs |r0| {d['norm0']}")
    return carry, step, s_step, launches


def predictor_fields(torch, sh, prob, carry, gen, dt=STEP_KW["dt"]):
    """Element inputs of the sweeps at the path's state: u at the next
    step's predictor, a the carry's, w random."""
    g, _ = sh._gather_scatter(prob)
    fc = prob.facs
    xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
    u_el = g(xa)
    w_el = torch.randn(*u_el.shape, generator=gen).to(prob.device, prob.dtype)
    return u_el, g(carry["a"]), w_el


def device_times(prof):
    """[(kernel name, launches, device ms)] of a profiled window, summed
    from the raw trace events: building the profiler's event tree
    (key_averages) takes tens of seconds for a step of ~10^5 launches."""
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            n, t = acc.get(e.name(), (0, 0.0))
            acc[e.name()] = (n + 1, t + e.duration_ns() / 1e6)
    return [(k, n, t) for k, (n, t) in acc.items()]


def profile_step(torch, step, carry, s_step, label, contact_scenes=None):
    """One profiled step (with the tool at `contact_scenes` on a contact
    problem): device busy time, idle share of the timed s/step, device
    time by kernel name.  Returns the new carry.  Only the device is
    traced: with the host's operators too, a step of ~10^5 launches takes
    tens of seconds to post-process, for rows no line prints."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=contact_scenes)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    ev = device_times(prof)
    busy = sum(t for _, _, t in ev)
    d = carry["newton"]
    if busy > 0:
        # the profiler slows the host, so the profiled step's own wall
        # overstates idling; on a press the profiled (next) step may also do
        # more work than the timed ones did
        say(f"[{label}] one step (newton {d['iters']}, gmres {d['lin_iters']}): "
            f"device busy {busy:.1f} ms; idle share {1.0 - busy / (s_step * 1e3):.3f} of the "
            f"timed {s_step * 1e3:.1f} ms/step, {1.0 - busy / t_prof:.3f} of the profiled "
            f"step's wall {t_prof:.1f} ms")
        for key, n, t in sorted(ev, key=lambda x: -x[2])[:12]:
            key = key.replace("(anonymous namespace)::", "")
            say(f"[{label}]   {t:9.3f} ms  x{n:<5d} {key[:110]}")
    else:
        say(f"[{label}] device time not visible to torch.profiler: not measured")
    return carry


def stvk_rows(torch, mt, sweeps, build, spans, device, u_el, a_el, w_el, label):
    """The St. Venant-Kirchhoff instantiations: the problem of `build` at
    `spans` with that material, its kernels against their plain versions at
    the given inputs, driven for 1 + STVK_STEPS steps from rest, and timed.
    Returns their rows of the kernels line."""
    t0 = time.perf_counter()
    sprob = build(mt, spans, device, "StVenantKirchhoff")
    torch.cuda.synchronize()
    say(f"[{label}] host build {time.perf_counter() - t0:.2f} s")
    kind = sym_sweeps(sweeps, sprob)[0]
    names = sym_names(sweeps, kind, sprob.material)[:2]
    # St. Venant-Kirchhoff has no F^-1 and no 1/J: its stress loses less
    # to cancellation than the neo-Hookean, and the same bars hold
    errs, Cs = compare_sym(torch, sweeps, sprob, u_el, a_el, w_el, label)
    # its viscous (and, on sf tables, bfloat16) instantiations on the same
    # inputs, printed for the record (no driven path launches them)
    v_el = torch.randn(*u_el.shape, generator=torch.Generator().manual_seed(38)).to(u_el)
    hold_viscous(torch, sweeps, sprob, sprob.material,
                 {"u_el": u_el, "a_el": a_el, "v_el": v_el, "w_el": w_el, "state": None},
                 STEP_KW["dt"], f"38. {label.split('. ', 1)[-1]} random",
                 combos=VISC_COMBOS["sf" if sprob.sf is not None else "dense"])
    del v_el
    sweeps.reset_launches()
    _, _, _, launches = drive(torch, mt, sweeps, sprob, f"{label} drive", STVK_STEPS,
                              names + [f"matvec_{kind}[sym]"])
    return time_sym(torch, sweeps, sprob, u_el, a_el, w_el, Cs, names, launches, errs,
                    f"{label} timing")


def fused_phase(torch, sweeps, fused, sh, prob, step, carry, u_el, w_el, Cs, gen, label):
    """Phase 17: the fused neo-Hookean residual and matrix-free tangent
    apply on the dense path's tables, against their plain versions and
    against residual_dense (a_el = 0) / matvec_dense (rho = 0, fac0 = 1) on
    the tangent assembled at the same state; then the path's first Newton
    system solved matrix-free through them, against the stored-tangent
    solve; then their times.  Returns their rows of the kernels line."""
    from mimi_tpu_torch.solvers.linear import gmres

    mat, wq = prob.material, prob.wdet_t
    dN, N = prob.dense["dN_t"], prob.dense["N_t"]
    lam, mu, rho, dt = mat.lambda_, mat.mu, float(mat.density), STEP_KW["dt"]
    errs = {}
    r_k = fused.neohookean_residual(u_el, dN, wq, lam, mu)
    torch.cuda.synchronize()
    r_p = fused.neohookean_residual_plain(u_el, dN, wq, lam, mu)
    r_d = sweeps.residual_dense(u_el, torch.zeros_like(u_el), None, dN, N, wq, mat, dt, rho)
    err, scale = float((r_k - r_p).abs().max()), float(r_p.abs().max())
    err_d = float((r_k - r_d).abs().max())
    errs["neohookean_residual"] = err
    say(f"[{label}] neohookean_residual: vs plain max|err| {err:.3e}, vs residual_dense "
        f"(a_el = 0) {err_d:.3e}, scale {scale:.3e}")
    # the dense residual's bar: F and P to the bit, the sums in another order
    if not max(err, err_d) <= 1e-5 * scale:
        fail(f"neohookean_residual disagrees ({err}, {err_d} > 1e-5 * {scale})")
    y_k = fused.neohookean_tangent_apply(u_el, w_el, dN, wq, lam, mu)
    torch.cuda.synchronize()
    y_p = fused.neohookean_tangent_apply_plain(u_el, w_el, dN, wq, lam, mu)
    y_d = sweeps.matvec_dense(w_el, dN, N, wq, Cs, 0.0, 1.0)
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    err_d = float((y_k - y_d).abs().max())
    errs["neohookean_tangent_apply"] = err
    say(f"[{label}] neohookean_tangent_apply: vs plain max|err| {err:.3e}, vs matvec_dense "
        f"(rho = 0, fac0 = 1) on the assembled planes {err_d:.3e}, scale {scale:.3e}")
    # the dense matvec's bar (float32, the directional formula against the
    # stored planes)
    if not max(err, err_d) <= 1e-4 * scale:
        fail(f"neohookean_tangent_apply disagrees ({err}, {err_d} > 1e-4 * {scale})")

    # the Newton system at the predictor of `carry`, once from the stored
    # tangent (the step's own) and once matrix-free: r from the fused
    # residual (the predictor has aa = 0, so no inertia term), J w =
    # fac0 K(u) w + M w with K from the fused tangent apply and the mass
    # term in plain torch; the same FDM-GMRES on both
    sweeps.reset_launches()
    ns = step.newton_system(carry)
    gather_t, scatter_el = sh._gather_scatter(prob)
    free, n_dof, dim = prob.free, prob.n_dof, prob.dim
    fc = prob.facs
    fac0 = fc["fac3"] * dt * dt
    xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
    x_el = gather_t(xa)
    r_mf = ((scatter_el(fused.neohookean_residual(x_el, dN, wq, lam, mu)) - prob.rhs)
            * free).reshape(-1)

    def J_mf(w_flat):
        w = w_flat.reshape(n_dof, dim) * free
        w_e = gather_t(w).contiguous()
        y_e = fac0 * fused.neohookean_tangent_apply(x_el, w_e, dN, wq, lam, mu)
        y_e = y_e + sweeps.dense_scatter(None, rho * sweeps.dense_value(w_e, N), dN, N, wq)
        return (scatter_el(y_e) * free + w_flat.reshape(n_dof, dim) * (1 - free)).reshape(-1)

    kw = dict(M_apply=ns["M_apply"], rel_tol=STEP_KW["lin_rel_tol"], abs_tol=1e-12,
              restart=30, max_iter=STEP_KW["cg_iters"], return_info=True)
    c_st, i_st = gmres(ns["J_apply"], ns["r"], **kw)
    c_mf, i_mf = gmres(J_mf, r_mf, **kw)
    w = torch.randn(n_dof * dim, generator=gen).to(prob.device, prob.dtype)
    jw_st, jw_mf = ns["J_apply"](w), J_mf(w)
    torch.cuda.synchronize()
    launches = dict(sweeps.LAUNCHES)
    r_err, r_scale = float((r_mf - ns["r"]).abs().max()), float(ns["r"].abs().max())
    jw_err, jw_scale = float((jw_mf - jw_st).abs().max()), float(jw_st.abs().max())
    c_err, c_scale = float((c_mf - c_st).abs().max()), float(c_st.abs().max())
    # the matrix-free solution put into the stored-tangent system
    norm_b = float(torch.linalg.norm(ns["M_apply"](ns["r"])))
    cross = float(torch.linalg.norm(ns["M_apply"](ns["r"] - ns["J_apply"](c_mf)))) / norm_b
    say(f"[{label}] matrix-free Newton system vs the stored-tangent one: residual max|err| "
        f"{r_err:.3e} scale {r_scale:.3e}; J w max|err| {jw_err:.3e} scale {jw_scale:.3e}; "
        f"FDM-GMRES iterations {i_mf['iters']}/{i_st['iters']}, preconditioned residual "
        f"{i_mf['res'] / norm_b:.3e}/{i_st['res'] / norm_b:.3e} of |M r|; the matrix-free "
        f"solution leaves {cross:.3e} in the stored-tangent system; solutions differ by "
        f"{c_err:.3e} of {c_scale:.3e}; launches { {k: n for k, n in launches.items() if n} }")
    # residual and J w at the assemble and matvec bars.  The two solves stop
    # at lin_rel_tol 1e-3 after different
    # iteration counts, so their solutions differ by that tolerance times
    # the system's conditioning (printed, not gated); the matrix-free
    # solution must solve the stored-tangent system as well as its own
    # (within 2 x its final residual: the operators agree to rounding)
    if not r_err <= 1e-4 * r_scale:
        fail(f"matrix-free Newton residual {r_err} > 1e-4 * {r_scale}")
    if not jw_err <= 1e-4 * jw_scale:
        fail(f"matrix-free J w {jw_err} > 1e-4 * {jw_scale}")
    if not cross <= 2.0 * max(i_mf["res"] / norm_b, STEP_KW["lin_rel_tol"]):
        fail(f"the matrix-free solution leaves {cross} in the stored-tangent system "
             f"(its own residual {i_mf['res'] / norm_b})")
    for name, _ in FUSED_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the matrix-free solve")

    calls = {
        "neohookean_residual": (
            lambda: fused.neohookean_residual(u_el, dN, wq, lam, mu),
            lambda: fused.neohookean_residual_plain(u_el, dN, wq, lam, mu),
            nbytes(u_el, dN, wq)),
        "neohookean_tangent_apply": (
            lambda: fused.neohookean_tangent_apply(u_el, w_el, dN, wq, lam, mu),
            lambda: fused.neohookean_tangent_apply_plain(u_el, w_el, dN, wq, lam, mu),
            nbytes(u_el, w_el, dN, wq)),
    }
    el_out = 3 * 27 * prob.n_el * 4
    n_pts = prob.n_el * prob.n_q
    rows = []
    for name, replaces in FUSED_KERNELS:
        kern, plain, n_in = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        row = kernel_row(name, SOURCE[2], replaces, launches[name], errs[name], ms, plain_ms,
                         n_in + el_out, n_pts * OPS_PER_POINT[name])
        say(f"[{label} timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"{(n_in + el_out) / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}; {(n_in + el_out) / ms / 1e9:.3f} TB/s")
        rows.append(row)
    return rows


def dense_phases(torch, mt, sweeps, fused, sh, device, gen):
    """Phases 13-18: the dense kernels against plain at 2 x 8^3, one step
    of the kernel path against the plain path there, the two-patch
    cantilever at 2 x 38^3, the kernels on its state, their times and one
    profiled step; on the same tables the fused neo-Hookean kernels; the
    St. Venant-Kirchhoff cantilever at the same size.  Returns their rows
    of the kernels line."""
    # ---- 13. dense kernels vs plain at 2 x 8^3, random fields ---------------
    prob = dense_build(mt, DENSE_CHECK_SPANS, device)
    E = prob.n_el
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, prob.dtype)  # noqa: E731
    grad = lambda u: sweeps.dense_grad(u, prob.dense["dN_t"])  # noqa: E731
    u_el, eps = near_identity(torch, grad, rnd(3, 27, E))
    a_el, w_el = rnd(3, 27, E), rnd(3, 27, E)
    label = f"13. 2x{DENSE_CHECK_SPANS}^3 random"
    J = sweeps.soa.det(sweeps.soa.add_diag(grad(u_el), 1.0))
    say(f"[{label}] n_el {E}, unknowns {prob.n_dof * 3}; |F - I| min {float(eps.min()):.4f} "
        f"median {float(eps.median()):.4f} max {float(eps.max()):.4f}; det F in "
        f"[{float(J.min()):.4f}, {float(J.max()):.4f}]")
    compare_sym(torch, sweeps, prob, u_el, a_el, w_el, label)

    # ---- 14. one step at 2 x 8^3: cuda vs torch ------------------------------
    carry0 = mt.initial_carry(prob)
    out = {impl: mt.make_step(prob, residual_impl=impl, **STEP_KW)(carry0)
           for impl in ("cuda", "torch")}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    say(f"[14. 2x{DENSE_CHECK_SPANS}^3 step] cuda vs torch: max|du| {err:.3e} max|u| "
        f"{scale:.3e}; newton {nc['iters']}/{nt['iters']} gmres "
        f"{nc['lin_iters']}/{nt['lin_iters']}")
    # float32 with another summation order: rounding, not bitwise
    if not err <= 1e-4 * scale:
        fail(f"dense one-step parity {err} > 1e-4 * {scale}")
    del prob, carry0, out, u_el, a_el, w_el, J, eps
    torch.cuda.empty_cache()

    # ---- 15. the two-patch cantilever at 2 x 38^3 ----------------------------
    sweeps.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = dense_build(mt, DENSE_SPANS, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    tab_gb = nbytes(prob.dense, prob.wdet_t) / 1e9
    say(f"[15. 2x38^3 dense] host build {host_s:.2f} s: n_el {prob.n_el}, n_q {prob.n_q}, "
        f"unknowns {prob.n_dof * prob.dim}; dense tables {tab_gb:.3f} GB on the device "
        f"(peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB)")
    names = [n for n, _ in DENSE_KERNELS]
    carry, step, s_step, launches = drive(torch, mt, sweeps, prob, "15. 2x38^3 dense",
                                          TIMED_STEPS, names)

    # ---- 13 (path). the kernels on the path's state ---------------------------
    u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen)
    errs, Cs = compare_sym(torch, sweeps, prob, u_el, a_el, w_el, "13. 2x38^3 path")
    v_el = torch.randn(*u_el.shape, generator=gen).to(u_el)
    hold_viscous(torch, sweeps, prob, prob.material,
                 {"u_el": u_el, "a_el": a_el, "v_el": v_el, "w_el": w_el, "state": None},
                 STEP_KW["dt"], "38. 2x38^3 path")
    del v_el

    # ---- 16. times, bandwidth and one profiled step ---------------------------
    rows = time_sym(torch, sweeps, prob, u_el, a_el, w_el, Cs, names, launches, errs,
                    "16. 2x38^3 timing")
    carry = profile_step(torch, step, carry, s_step, "16. 2x38^3 profile")

    # ---- 17. the fused neo-Hookean kernels on the same tables ------------------
    rows += fused_phase(torch, sweeps, fused, sh, prob, step, carry, u_el, w_el, Cs, gen,
                        "17. 2x38^3 fused")

    # ---- 18. the St. Venant-Kirchhoff cantilever at the same size -------------
    del Cs, step, carry, prob
    torch.cuda.empty_cache()
    rows += stvk_rows(torch, mt, sweeps, dense_build, DENSE_SPANS, device, u_el, a_el, w_el,
                      "18. 2x38^3 StVK")
    del u_el, a_el, w_el
    torch.cuda.empty_cache()
    return rows


def hyper_phases(torch, mt, sweeps, sh, device, gen):
    """Phases 19-22: the hyperelastic sf kernels (both materials) against
    plain at 16^3, one step of the kernel path against the plain path
    there, the neo-Hookean cube at 48^3, the kernels on its state, their
    times, one profiled step, and the St. Venant-Kirchhoff cube at the
    same size.  Returns their rows of the kernels line."""
    # ---- 19. sf hyperelastic kernels vs plain at 16^3, both materials ----------
    tags = {name: tag for name, (_, tag) in sweeps.HYPER_KERNELS.items()}
    probs = {name: hyper_build(mt, CHECK_SPANS, device, name) for name in tags}
    prob = next(iter(probs.values()))  # both share mesh and tables
    E = prob.n_el
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, prob.dtype)  # noqa: E731
    grad = lambda u: sweeps.sf_grad(u, prob.sf["tables"], prob.sf["jinv"])  # noqa: E731
    u_el, eps = near_identity(torch, grad, rnd(3, 27, E))
    a_el, w_el = rnd(3, 27, E), rnd(3, 27, E)
    label = f"19. {CHECK_SPANS}^3 random"
    J = sweeps.soa.det(sweeps.soa.add_diag(grad(u_el), 1.0))
    say(f"[{label}] n_el {E}, unknowns {prob.n_dof * 3}; |F - I| min {float(eps.min()):.4f} "
        f"median {float(eps.median()):.4f} max {float(eps.max()):.4f}; det F in "
        f"[{float(J.min()):.4f}, {float(J.max()):.4f}]")
    for name, p in probs.items():
        compare_sym(torch, sweeps, p, u_el, a_el, w_el, f"{label} {tags[name]}")

    # ---- 20. one step at 16^3: cuda vs torch, both materials -------------------
    for name, p in probs.items():
        carry0 = mt.initial_carry(p)
        out = {impl: mt.make_step(p, residual_impl=impl, **STEP_KW)(carry0)
               for impl in ("cuda", "torch")}
        err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
        scale = float(out["torch"]["u"].abs().max())
        nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
        say(f"[20. {CHECK_SPANS}^3 step {tags[name]}] cuda vs torch: max|du| {err:.3e} max|u| "
            f"{scale:.3e}; newton {nc['iters']}/{nt['iters']} gmres "
            f"{nc['lin_iters']}/{nt['lin_iters']}")
        # the bar of the reference package's pallas-vs-soa parity check
        if not err <= 1e-4 * scale:
            fail(f"{name} one-step parity {err} > 1e-4 * {scale}")
    del prob, probs, carry0, out, u_el, a_el, w_el, J, eps
    torch.cuda.empty_cache()

    # ---- 21. the neo-Hookean cube at 48^3 ---------------------------------------
    sweeps.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = hyper_build(mt, SPANS, device)
    torch.cuda.synchronize()
    say(f"[21. 48^3 neo-Hookean] host build {time.perf_counter() - t0:.2f} s: n_el "
        f"{prob.n_el}, n_q {prob.n_q}, unknowns {prob.n_dof * prob.dim}; sum-factorized "
        f"tables, symmetric tangent")
    names = sym_names(sweeps, "sf", prob.material)
    carry, step, s_step, launches = drive(torch, mt, sweeps, prob, "21. 48^3 neo-Hookean",
                                          TIMED_STEPS, names)

    # ---- 19 (path). the kernels on the path's state ----------------------------
    u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen)
    eps = torch.linalg.vector_norm(
        sweeps.sf_grad(u_el, prob.sf["tables"], prob.sf["jinv"]), dim=(0, 1))
    say(f"[19. 48^3 path] |F - I| median {float(eps.median()):.3e} max "
        f"{float(eps.max()):.3e}")
    del eps
    errs, Cs = compare_sym(torch, sweeps, prob, u_el, a_el, w_el, "19. 48^3 path")

    # ---- 22. times, one profiled step, the other material -----------------------
    rows = time_sym(torch, sweeps, prob, u_el, a_el, w_el, Cs, names, launches, errs,
                    "22. 48^3 timing")
    profile_step(torch, step, carry, s_step, "22. 48^3 neo-Hookean profile")
    del Cs, step, carry, prob
    torch.cuda.empty_cache()
    rows += stvk_rows(torch, mt, sweeps, hyper_build, SPANS, device, u_el, a_el, w_el,
                      "22. 48^3 StVK")
    del u_el, a_el, w_el
    torch.cuda.empty_cache()
    return rows


def finite_inputs(torch, sweeps, soa, prob, gen):
    """Random element fields and a random plastic history on the problem's
    tables: the state after one plain accumulate_soa at a random F with
    |F - I| up to 0.1 (per element), eqps raised by up to 1e-3, temperature
    20-120; u_el at another such F, a_el and w_el of unit size.  Returns
    (u_el, a_el, w_el, state, plastic share of the points at u_el)."""
    mat, E, dt = prob.material, prob.n_el, STEP_KW["dt"]
    rnd = lambda *s: torch.randn(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    uni = lambda *s: torch.rand(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    grad = lambda u: sweeps.sf_grad(u, prob.sf["tables"], prob.sf["jinv"])  # noqa: E731
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["temperature"] = 20.0 + 100.0 * uni(64, E)
    u0, _ = near_identity(torch, grad, rnd(3, 27, E))
    state = mat.accumulate_soa(soa.add_diag(grad(u0), 1.0), state, dt)
    state = {k: v.contiguous() for k, v in state.items()}
    state["eqps"] = state["eqps"] + 1e-3 * uni(64, E)
    u_el, _ = near_identity(torch, grad, rnd(3, 27, E))
    active = mat._return_map_soa(soa.add_diag(grad(u_el), 1.0), state, dt)[4]
    return u_el, rnd(3, 27, E), rnd(3, 27, E), state, float(active.float().mean())


def masked_err(torch, y_k, y_p, what):
    """(max|y_k - y_p|, max|y_p|) over the entries that are finite in the
    plain version; fails unless both are NaN at the same entries."""
    nan_k, nan_p = torch.isnan(y_k), torch.isnan(y_p)
    if not bool((nan_k == nan_p).all()):
        fail(f"{what}: NaN at {int(nan_k.sum())} entries of the kernel's output, "
             f"{int(nan_p.sum())} of the plain version's")
    ok = ~nan_p
    return float((y_k - y_p)[ok].abs().max()), float(y_p[ok].abs().max())


def _elements(x, sl):
    """x restricted to the elements `sl` (a slice of the last axis),
    through dicts and lists; anything without a shape passes as it is."""
    if isinstance(x, dict):
        return {k: _elements(v, sl) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_elements(v, sl) for v in x]
    return x[..., sl].contiguous() if hasattr(x, "shape") else x


def compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, state, dt, label, parts=None,
                    res_bar=1e-5, whole_scale=False):
    """The problem's material's three kernels (sum-factorized or dense
    tables) against their plain versions on the same inputs; returns
    ({kernel: max_abs_err}, the plain tangent block) and fails past the
    bars: residual `res_bar` x scale, assemble residual and matvec 1e-4 x
    scale, planes 1e-4 of their group's max (plane_groups).  The kernels
    run once on all elements; the plain residual and assemble run on each
    element range of `parts` ({name: slice}, default all elements), each
    held on its own scale.  Entries the plain version NaN-poisons must be
    NaN in the kernel's output too (masked_err).  For a material with a
    yield surface, points at it where the kernel takes the other branch
    (YIELD_BAND) are counted and left out of the planes' bar
    (planes_rel).  With `whole_scale` the parts only bound the plain
    versions' memory: every output and the planes are held on the scale
    of all elements, as without parts."""
    mat, wq = prob.material, prob.wdet_t
    tables, (res_k, asm_k, mv_k), (res_p, asm_p, mv_p) = kernel_fns(sweeps, prob)
    storage = sweeps.tangent_storage(mat)
    n_res, n_asm, n_mv = kernel_names(sweeps, prob)
    rho = float(mat.density)
    args = (u_el, a_el, state, *tables, wq, mat, dt, rho)
    fac0 = prob.facs["fac3"] * dt * dt
    errs = {n_res: 0.0, n_asm: 0.0}
    y_k = res_k(*args)
    ya_k, C_k = asm_k(*args)
    torch.cuda.synchronize()
    if C_k.shape[0] != sweeps.n_planes(storage, prob.dim):
        fail(f"{n_asm} wrote planes of shape {tuple(C_k.shape)}")
    C_p = torch.empty_like(C_k)
    whole = {n_res: [0.0, 0.0], n_asm: [0.0, 0.0]}  # (max|err|, scale) over the parts
    for part, sl in (parts or {"": slice(None)}).items():
        tag = f"[{label}{', ' + part if part else ''}]"
        p_args = args if part == "" else _elements(args, sl)
        err, scale = masked_err(torch, y_k[..., sl], res_p(*p_args), n_res)
        errs[n_res] = max(errs[n_res], err)
        whole[n_res] = [max(err, whole[n_res][0]), max(scale, whole[n_res][1])]
        say(f"{tag} {n_res}: max|err| {err:.3e} scale {scale:.3e} ({err / scale:.3e}); "
            f"non-finite entries {int(torch.isnan(y_k[..., sl]).sum())}")
        # float32: dense F to the bit (no FMA, the plain version's order),
        # the quadrature sums in another order; the materials' float32
        # bodies (J2's to the bit, the finite-strain ones in their own
        # rounding)
        if not whole_scale and not err <= res_bar * scale:
            fail(f"{n_res} disagrees with plain ({err} > {res_bar} * {scale}) {tag}")
        ya_p, C_p[..., sl] = asm_p(*p_args)
        err, scale = masked_err(torch, ya_k[..., sl], ya_p, f"{n_asm} residual")
        whole[n_asm] = [max(err, whole[n_asm][0]), max(scale, whole[n_asm][1])]
        masked_err(torch, C_k[..., sl], C_p[..., sl], f"{n_asm} planes")
        del ya_p
        if whole_scale:
            say(f"{tag} {n_asm}: residual max|err| {err:.3e} scale {scale:.3e}")
            continue
        rel, dmax, surface, _ = planes_rel(torch, sweeps, prob, C_k[..., sl], C_p[..., sl], 1e-4,
                                        p_args, f"{n_asm} {tag}")
        errs[n_asm] = max(errs[n_asm], err, dmax)
        say(f"{tag} {n_asm}: residual max|err| {err:.3e} scale {scale:.3e}; {C_k.shape[0]} "
            f"planes worst err vs group max {rel:.3e}{surface}")
        if not err <= 1e-4 * scale:
            fail(f"{n_asm} residual disagrees ({err} > 1e-4 * {scale}) {tag}")
        # the kernel's tangent (closed form, or dual numbers) against the
        # plain version's forward-mode planes, float32
        if not rel <= 1e-4:
            fail(f"{n_asm} tangent disagrees (plane err {rel} of its group's max) {tag}")
    if whole_scale:
        (err_r, scale_r), (err_a, scale_a) = whole[n_res], whole[n_asm]
        rel, dmax, surface, _ = planes_rel(torch, sweeps, prob, C_k, C_p, 1e-4, args,
                                           f"{n_asm} [{label}]")
        errs[n_asm] = max(err_a, dmax)
        say(f"[{label}] all elements: {n_res} max|err| {err_r:.3e} scale {scale_r:.3e} "
            f"({err_r / scale_r:.3e}); {n_asm} residual max|err| {err_a:.3e} scale "
            f"{scale_a:.3e}; {C_k.shape[0]} planes worst err vs group max {rel:.3e}{surface}")
        if not err_r <= res_bar * scale_r:
            fail(f"{n_res} disagrees with plain ({err_r} > {res_bar} * {scale_r}) [{label}]")
        if not err_a <= 1e-4 * scale_a:
            fail(f"{n_asm} residual disagrees ({err_a} > 1e-4 * {scale_a}) [{label}]")
        if not rel <= 1e-4:
            fail(f"{n_asm} tangent disagrees (plane err {rel} of its group's max) [{label}]")
    del y_k, ya_k, C_k
    mv_args = (w_el, *tables, wq, C_p, rho, fac0)
    y_mv = mv_k(*mv_args, storage=storage)
    torch.cuda.synchronize()
    err, scale = masked_err(torch, y_mv, mv_p(*mv_args, storage=storage), n_mv)
    errs[n_mv] = err
    say(f"[{label}] {n_mv}: max|err| {err:.3e} scale {scale:.3e}")
    if not err <= 1e-4 * scale:
        fail(f"{n_mv} disagrees with plain ({err} > 1e-4 * {scale})")
    return errs, C_p


def group_err(torch, C, C_ref, groups, keep=None):
    """max over the plane groups of max|C - C_ref| / max|C_ref| in the
    group, in float64, over the entries C_ref has finite (and, with `keep`,
    the points it marks)."""
    d = torch.nan_to_num((C.double() - C_ref).abs())
    if keep is not None:
        d = d * keep.to(d.dtype)
    d = d.amax(dim=(1, 2))
    m = torch.nan_to_num(C_ref.abs()).amax(dim=(1, 2))
    return max(float(d[a:b].max() / m[a:b].max().clamp_min(1e-300)) for a, b in groups)


def planes_rel(torch, sweeps, prob, C_k, C_p, bar, args, what, mat=None, storage=None,
               witness=False):
    """(worst plane error against its group's max (plane_groups of the
    block's `storage`, default the material's), max |C_k - C_p|, a note,
    the points kept) of the kernel's tangent block C_k against the plain
    one C_p (either dtype; compared in float32).  For a material with
    state (`mat`, default the problem's), the points whose planes differ by
    more than `bar` of the block's max must lie within YIELD_BAND of the
    yield surface in the plain trial state at args = (u_el, a_el, state,
    *tables): the kernel, rounding its own trial state, took the other
    branch there; they are counted and left out.  A point off the yield
    surface past the bar fails, unless `witness` (a state that holds
    inverted elements): then it stays in the error, and the caller holds
    the planes of the kept points against float64."""
    mat = mat or prob.material
    dC = torch.nan_to_num(C_k.float() - C_p.float()).abs()
    mag = torch.nan_to_num(C_p.float()).abs().amax(dim=(1, 2))
    note, keep = "", None
    if args[2] is not None:
        off = dC.amax(0) > bar * mag.max()
        if bool(off.any()):
            margin = yield_margin(torch, sweeps, prob, args[0], args[2], args[3:5], mat)
            band = off & (margin <= YIELD_BAND)
            far = off & ~band
            if bool(band.any()):
                note = (f"; {int(band.sum())} points at the yield surface (plain trial within "
                        f"{float(margin[band].max()):.1e} of the flow stress) on the other "
                        "branch in the kernel, left out of the planes' bar")
            if bool(far.any()):
                nearest = float(margin[far].min())
                if not witness:
                    fail(f"{what}: tangent disagrees at {int(far.sum())} points off the yield "
                         f"surface (plain trial at least {nearest} of the flow stress from it)")
                note += (f"; {int(far.sum())} points off the yield surface (at least "
                         f"{nearest:.1e} of the flow stress from it) past the bar, held against "
                         "float64")
            keep = ~band
            dC = dC * keep.to(dC.dtype)
            del margin, band, far
    diff = dC.amax(dim=(1, 2))
    del dC
    storage = storage or sweeps.tangent_storage(mat)
    rel = max(float(diff[a:b].max() / mag[a:b].max().clamp_min(1e-30))
              for a, b in plane_groups(sweeps, storage, prob.dim))
    return rel, float(diff.max()), note, keep


def path_residual(torch, sweeps, sh, prob, carry, gen, label):
    """The residual kernel against its plain version at the next step's
    predictor of `carry`: max|err| / max|y|."""
    mat = prob.material
    u_el, a_el, _ = predictor_fields(torch, sh, prob, carry, gen)
    args = (u_el, a_el, carry["state"], prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, mat,
            STEP_KW["dt"], float(mat.density))
    y_k = sweeps.residual_sf(*args)
    torch.cuda.synchronize()
    err, scale = masked_err(torch, y_k, twin(sweeps.residual_sf_plain)(*args), label)
    return err / scale


# the sf kernels' source by tangent storage (p = 2; sf_source)
SF_SOURCE = {"cauchy": SOURCE[0], "full": SOURCE[3], "sym": SOURCE[6]}


def sf_source(storage, p):
    """The source of the sf kernels of `storage` at degree p: the _p3
    twins at p = 3."""
    return SF_SOURCE[storage].replace(".cu", "_p3.cu") if p == 3 else SF_SOURCE[storage]


def time_sf(torch, sweeps, prob, u_el, a_el, w_el, state, C, names, launches, errs, label):
    """Rows of the kernels line for the problem's material's sum-factorized
    kernels in `names` at the problem's size: CUDA-event times of kernel
    and plain version, bytes and bound."""
    mat, tabs, jinv, wq = prob.material, prob.sf["tables"], prob.sf["jinv"], prob.wdet_t
    storage = sweeps.tangent_storage(mat)
    rho, dt = float(mat.density), STEP_KW["dt"]
    fac0 = prob.facs["fac3"] * dt * dt
    args = (u_el, a_el, state, tabs, jinv, wq, mat, dt, rho)
    mv_args = (w_el, tabs, jinv, wq, C, rho, fac0)
    fns = [(lambda: sweeps.residual_sf(*args), lambda: twin(sweeps.residual_sf_plain)(*args)),
           (lambda: sweeps.assemble_sf(*args), lambda: twin(sweeps.assemble_sf_plain)(*args)),
           (lambda: sweeps.matvec_sf(*mv_args, storage=storage),
            lambda: twin(sweeps.matvec_sf_plain)(*mv_args, storage=storage))]
    el_out = nbytes(u_el)
    byts = [  # inputs read once, outputs written once
        nbytes(u_el, a_el, tabs, jinv, wq, state) + el_out,
        nbytes(u_el, a_el, tabs, jinv, wq, state, C) + el_out,
        nbytes(w_el, tabs, jinv, wq, C) + el_out,
    ]
    n_pts = prob.n_el * prob.n_q
    rows = []
    for i, (name, replaces, ops) in enumerate(zip(kernel_names(sweeps, prob), SYM_REPLACES["sf"],
                                                  sf_ops(sweeps, prob))):
        if name not in names:
            continue
        ms = cuda_ms(torch, fns[i][0], 10)
        torch.cuda.empty_cache()
        plain_ms = cuda_ms(torch, fns[i][1], PLAIN_REPS)
        torch.cuda.empty_cache()
        row = kernel_row(name, sf_source(storage, degree_of(prob)), replaces, launches[name],
                         errs[name], ms, plain_ms, byts[i], n_pts * ops)
        say(f"[{label}] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"{byts[i] / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
            f"{byts[i] / ms / 1e9:.3f} TB/s ({byts[i] / ms / 1e9 / (HBM_BPS / 1e12):.2f} "
            f"of 3.35)")
        rows.append(row)
    return rows


def finite_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 23-26: the finite-strain kernels (J2Simo, J2Log, the 81-plane
    storage) against plain at 16^3 on random plastic input (and, for
    J2Log, input past the fast log series' range), one plastic step of the
    kernel path against the plain path there per material, the J2Simo
    cube at 48^3 (the kernels on its state, their times, one profiled
    step) and the J2Log cube at the same size.  Returns their rows of the
    kernels line."""
    # ---- 23. finite-strain kernels vs plain at 16^3 ------------------------------
    probs = {name: build(mt, CHECK_SPANS, device, name) for name in sweeps.FULL_KERNELS}
    for name, p in probs.items():
        label = f"23. {CHECK_SPANS}^3 random {name}"
        u_el, a_el, w_el, state, share = finite_inputs(torch, sweeps, soa, p, gen)
        eps = torch.linalg.vector_norm(
            sweeps.sf_grad(u_el, p.sf["tables"], p.sf["jinv"]), dim=(0, 1))
        say(f"[{label}] plastic share of the points {share:.3f}; |F - I| median "
            f"{float(eps.median()):.4f} max {float(eps.max()):.4f}; eqps of the history max "
            f"{float(state['eqps'].max()):.4e}")
        if share < 0.25:
            fail(f"{name}: plastic share {share} < 0.25: the check would not exercise the "
                 "return map")
        compare_kernels(torch, sweeps, p, u_el, a_el, w_el, state, STEP_KW["dt"], label)
        if name == "J2Log":
            # The same input with element 0 stretched past the fast series'
            # range at all 64 points (Fp^-1 = diag(6, 1, 1): the deep series,
            # not poisoned) and element 1 past the deep range (diag(1e5, 1,
            # 1): NaN-poisoned).  The plain version, as the reference, takes
            # the deep series for a whole batch with one point out of range,
            # the kernel for that point alone: the plain calls run on
            # elements 0-1 and 2.. apart, so that both sides take the same
            # series everywhere.
            st = {k: v.clone() for k, v in state.items()}
            diag = lambda x: torch.diag(torch.tensor([x, 1.0, 1.0])).to(device, p.dtype)  # noqa: E731
            st["Fp_inv"][..., 0] = diag(6.0)[:, :, None]
            st["Fp_inv"][..., 1] = diag(1e5)[:, :, None]
            active = p.material._return_map_soa(
                soa.add_diag(sweeps.sf_grad(u_el, p.sf["tables"], p.sf["jinv"]), 1.0), st,
                STEP_KW["dt"])[4]
            say(f"[23. {CHECK_SPANS}^3 J2Log out of range] plastic points {int(active.sum())} "
                f"of {active.numel()} (element 1's are NaN)")
            compare_kernels(torch, sweeps, p, u_el, a_el, w_el, st, STEP_KW["dt"],
                            f"23. {CHECK_SPANS}^3 J2Log out of range",
                            parts={"elements 0-1 (deep series, poisoned)": slice(0, 2),
                                "elements 2.. (fast series)": slice(2, None)})
    del probs, u_el, a_el, w_el, state, st, active, eps

    # ---- 24. one plastic step at 16^3: cuda vs torch, both materials -------------
    for name in sweeps.FULL_KERNELS:
        p = build(mt, CHECK_SPANS, device, name, A=A_PLASTIC)
        carry0 = mt.initial_carry(p)
        out = {impl: mt.make_step(p, residual_impl=impl, **STEP_KW)(carry0)
               for impl in ("cuda", "torch")}
        err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
        scale = float(out["torch"]["u"].abs().max())
        nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
        plastic = [int((out[i]["state"]["eqps"] > 0).sum()) for i in ("cuda", "torch")]
        say(f"[24. {CHECK_SPANS}^3 step {name}, A {A_PLASTIC}] cuda vs torch: max|du| {err:.3e} "
            f"max|u| {scale:.3e} ({err / scale:.3e}); plastic points {plastic[0]}/{plastic[1]} "
            f"of {p.n_el * p.n_q}; newton {nc['iters']}/{nt['iters']} gmres "
            f"{nc['lin_iters']}/{nt['lin_iters']}; |r| {nc['norm']:.3e}/{nt['norm']:.3e} of "
            f"|r0| {nt['norm0']:.3e}")
        if min(plastic) == 0:
            fail(f"{name}: the 16^3 parity step has no plastic point")
        # the bar of the reference package's pallas-vs-soa parity check
        if not err <= 1e-4 * scale:
            fail(f"{name} one-step parity {err} > 1e-4 * {scale}")
        del p, carry0, out
    torch.cuda.empty_cache()

    # ---- 25. the J2Simo cube at 48^3 and 26. the J2Log cube ---------------------------
    rows = []
    for name, timed, ph in (("J2Simo", TIMED_STEPS, 25), ("J2Log", LOG_STEPS, 26)):
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = build(mt, SPANS, device, name)
        torch.cuda.synchronize()
        say(f"[{ph}. 48^3 {name}] host build {time.perf_counter() - t0:.2f} s: n_el "
            f"{prob.n_el}, n_q {prob.n_q}, unknowns {prob.n_dof * prob.dim}; sum-factorized "
            f"tables, full tangent (81 planes, "
            f"{81 * prob.n_q * prob.n_el * 4 / 1e9:.3f} GB)")
        names = kernel_names(sweeps, prob)
        carry, step, s_step, launches = drive(torch, mt, sweeps, prob, f"{ph}. 48^3 {name}",
                                              timed, names)
        eqps = carry["state"]["eqps"]
        state_max = {k: float(v.abs().max()) for k, v in carry["state"].items()}
        say(f"[{ph}. 48^3 {name}] eqps max {float(eqps.max()):.4e}, plastic points "
            f"{int((eqps > 0).sum())}; state max|.| {state_max}")
        # The kernels on the path's state, the next step's predictor.  Near
        # equilibrium (strains ~1e-3) the residual is a small difference of
        # element forces, while both versions round quantities of size 1 in
        # their own order (nvcc contracts FMAs, torch rounds every op):
        # J2Simo's F^-1, F_old F^-1, its inverse, cbrt and be = f be_old f^T
        # (be ~ I), J2Log's square roots of C_e ~ I, whose log the series
        # scales by 2^3.  A few ulps of 1 in be or log C are G x 1e-7 ~ 1e-4
        # in the stress: the path-state bar is PATH_RES_BAR, read at
        # PATH_READINGS further states below.
        u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen)
        errs, Cf = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"],
                                   STEP_KW["dt"], f"{ph}. 48^3 {name} path",
                                   res_bar=PATH_RES_BAR)
        keep = names if name == "J2Simo" else names[:2]  # the matvec is timed once
        rows += time_sf(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], Cf, keep,
                          launches, errs, f"{ph}. 48^3 {name} timing")
        if name == "J2Simo":
            carry = profile_step(torch, step, carry, s_step, f"{ph}. 48^3 {name} profile")
        del Cf, u_el, a_el, w_el
        readings = []
        for _ in range(PATH_READINGS):
            carry = step(carry)
            readings.append(path_residual(torch, sweeps, sh, prob, carry, gen,
                                          f"{ph}. 48^3 {name} path readings"))
        say(f"[{ph}. 48^3 {name} path readings] {names[0]} max|err| / max|y| at the "
            f"predictors of {PATH_READINGS} further steps: "
            f"{', '.join(f'{x:.3e}' for x in readings)} (bar {PATH_RES_BAR})")
        if not max(readings) <= PATH_RES_BAR:
            fail(f"{names[0]} disagrees with plain at a {name} path state: {max(readings)}")
        del step, carry, prob
        torch.cuda.empty_cache()
    return rows


def balken_build(mt, name, elevate, subdivide, device, dtype=None):
    """The golden cantilever: balken.mesh elevated by `elevate`, subdivided
    `subdivide` times, boundary 2 clamped, the golden's material `name`
    (J2, J2Simo or J2Log with Johnson-Cook hardening, or a hyperelastic
    material) and body force."""
    mat = jc_material(mt, name=name) if name.startswith("J2") else hyper_material(mt, name)
    force = {**GOLDEN_2D, **GOLDEN_FINITE}[name][0]
    return shared_build(mt, mat, 2, BALKEN, elevate, subdivide, [(2, 0), (2, 1)], force, device,
                        dtype=dtype)


def dense_degree(prob):
    nd = prob.dense["dN_t"].shape[0]
    return round(nd ** (1.0 / prob.dim)) - 1


def degree_of(prob):
    """The problem's degree, sum-factorized or dense tables."""
    return prob.sf["pp1"] - 1 if prob.sf is not None else dense_degree(prob)


def nodes_of(prob):
    """Dofs per element of the problem's tables."""
    return prob.sf["pp1"] ** 3 if prob.sf is not None else prob.dense["dN_t"].shape[0]


def ops_tag(sweeps, mat):
    """The material's key of MATERIAL_OPS: its tag without the law (the law
    changes how the flow stress is evaluated, not the operations counted)."""
    return sweeps.kernel_tag(mat).split("-")[0]


def kernel_names(sweeps, prob):
    """Counter names (residual, assemble, matvec) of the problem's material
    on its tables: kind, storage, material tag and (dim, p) suffix."""
    mat, storage = prob.material, sweeps.tangent_storage(prob.material)
    kind = "sf" if prob.sf is not None else "dense"
    dim, p = prob.dim, degree_of(prob)
    return [*sweeps.kernel_counters(mat, kind, dim, p), sweeps.matvec_counter(kind, storage, dim, p)]


def sf_ops(sweeps, prob):
    """Operations per point of the (residual, assemble, matvec) functions
    of the problem's material on its sum-factorized tables
    (OPS_PER_POINT, else the sf structure of its shape, sf_struct, with
    MATERIAL_OPS)."""
    names = kernel_names(sweeps, prob)
    if all(n in OPS_PER_POINT for n in names):
        return [OPS_PER_POINT[n] for n in names]
    stress, tangent, apply = MATERIAL_OPS[(ops_tag(sweeps, prob.material), 3)]
    st = sf_struct(prob)
    return [st["residual"] + stress, st["residual"] + stress + tangent, st["matvec"] + apply]


def sf_struct(prob):
    """Operations per point of the sf functions' interpolation and scatter
    at the problem's shape (p + 1 = P nodes, G points per axis), counted as
    the staged 1D contractions of the p = 2 constants above, per vector
    component and element: a gradient 2 P (2 G P^2 + 3 G^2 P + 3 G^3), the
    values of the same field 2 P G^3 more, of another field
    2 P (G P^2 + G^2 P + G^3); three components over G^3 points.  At p = 2
    these are _SF_GRAD, _SF_SAME_VALUE and _SF_OTHER_VALUE (115, 18, 42);
    at p = 3 (P 4, G 5) 160, 24 and 59."""
    P, G = prob.sf["pp1"], prob.sf["n_g"]
    grad = round(3 * 2 * P * (2 * G * P * P + 3 * G * G * P + 3 * G**3) / G**3)
    same = 6 * P
    other = round(3 * 2 * P * (G * P * P + G * G * P + G**3) / G**3)
    return {"residual": grad + _JINV + 3 + other + _SCALE + _JINV + grad + same,
            "matvec": 2 * (grad + same + _JINV) + _SCALE, "viscous": grad + _JINV + 18}


def kernel_fns(sweeps, prob):
    """The problem's tables and sweeps: (tables, (residual, assemble,
    matvec), their plain versions), sum-factorized or dense."""
    if prob.sf is not None:
        return ((prob.sf["tables"], prob.sf["jinv"]),
                (sweeps.residual_sf, sweeps.assemble_sf, sweeps.matvec_sf),
                tuple(map(twin, (sweeps.residual_sf_plain, sweeps.assemble_sf_plain,
                                 sweeps.matvec_sf_plain))))
    return ((prob.dense["dN_t"], prob.dense["N_t"]),
            (sweeps.residual_dense, sweeps.assemble_dense, sweeps.matvec_dense),
            tuple(map(twin, (sweeps.residual_dense_plain, sweeps.assemble_dense_plain,
                             sweeps.matvec_dense_plain))))


def grad_of(sweeps, prob, u_el, tables=None):
    """Physical displacement gradient (dim, dim, n_q, n_el) of u_el on the
    problem's tables (or on `tables`, the same restricted to u_el's
    elements)."""
    tables = tables or kernel_fns(sweeps, prob)[0]
    if prob.sf is not None:
        return sweeps.sf_grad(u_el, *tables)
    return sweeps.dense_grad(u_el, tables[0])


def dense_ops(sweeps, prob):
    """Operations per point of the (residual, assemble, matvec) functions
    of the problem's material on its dense tables (MATERIAL_OPS)."""
    names = kernel_names(sweeps, prob)
    if all(n in OPS_PER_POINT for n in names):
        return [OPS_PER_POINT[n] for n in names]
    dim, nd = prob.dim, prob.dense["dN_t"].shape[0]
    stress, tangent, apply = MATERIAL_OPS[(ops_tag(sweeps, prob.material), dim)]
    base = 2 * dim * dim * nd + 2 * dim * nd + (2 * dim + 2) * dim * nd
    return [base + 2 * dim + stress, base + 2 * dim + stress + tangent, base + dim + apply]


def plane_groups(sweeps, storage, dim):
    """Plane ranges of a tangent block held against their group's max:
    the Cauchy block's D-hat, sigma, F^-1 and J; the symmetric block as
    one group."""
    if storage == "cauchy":
        lay = sweeps.cauchy_plane_layout(dim)
        return [(0, lay["n_tri"]), (lay["off_sig"], lay["off_fi"]),
                (lay["off_fi"], lay["off_j"]), (lay["off_j"], lay["n_plane"])]
    return [(0, sweeps.n_planes(storage, dim))]


def dense_inputs(torch, sweeps, soa, prob, gen, dt, amplitude=0.1):
    """Random element fields on the problem's dense tables: u_el with |F - I|
    up to `amplitude` per element, a_el and w_el of unit size; for J2 a
    random history (eqps up to 0.01, temperature 20-120).  Returns (u_el,
    a_el, w_el, state, plastic share of the points at u_el or None)."""
    dN, E, nq = prob.dense["dN_t"], prob.n_el, prob.n_q
    shape = (prob.dim, dN.shape[0], E)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    uni = lambda *s: torch.rand(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    u_el, _ = near_identity(torch, lambda u: sweeps.dense_grad(u, dN), rnd(*shape), amplitude)
    state, share = None, None
    if prob.state0 is not None:
        state = {k: v.clone() for k, v in prob.state0.items()}
        state["eqps"] = 0.01 * uni(nq, E)
        state["temperature"] = 20.0 + 100.0 * uni(nq, E)
        F = soa.add_diag(sweeps.dense_grad(u_el, dN), 1.0)
        share = float(prob.material._return_map(F, state, dt)[4].float().mean())
    return u_el, rnd(*shape), rnd(*shape), state, share


def time_dense(torch, sweeps, prob, u_el, a_el, w_el, state, C, dt, launches, errs, label,
               matvec=True):
    """Rows of the kernels line for the problem's material's dense kernels
    (the matvec unless `matvec` is False: another material's row times the
    same instantiation): CUDA-event times of kernel and plain version,
    bytes (inputs read once, outputs written once) and bound."""
    mat, wq = prob.material, prob.wdet_t
    dN, N = prob.dense["dN_t"], prob.dense["N_t"]
    storage = sweeps.tangent_storage(mat)
    rho, fac0 = float(mat.density), prob.facs["fac3"] * dt * dt
    args = (u_el, a_el, state, dN, N, wq, mat, dt, rho)
    mv_args = (w_el, dN, N, wq, C, rho, fac0)
    fns = [(lambda: sweeps.residual_dense(*args), lambda: twin(sweeps.residual_dense_plain)(*args)),
           (lambda: sweeps.assemble_dense(*args), lambda: twin(sweeps.assemble_dense_plain)(*args)),
           (lambda: sweeps.matvec_dense(*mv_args, storage=storage),
            lambda: twin(sweeps.matvec_dense_plain)(*mv_args, storage=storage))]
    el_out = nbytes(u_el)
    byts = [nbytes(u_el, a_el, dN, N, wq, state) + el_out,
            nbytes(u_el, a_el, dN, N, wq, state, C) + el_out,
            nbytes(w_el, dN, N, wq, C) + el_out]
    n_pts = prob.n_el * prob.n_q
    source = DENSE_SOURCE[storage]
    rows = []
    for i, (name, replaces, ops) in enumerate(zip(kernel_names(sweeps, prob),
                                                  SYM_REPLACES["dense"], dense_ops(sweeps, prob))):
        if i == 2 and not matvec:
            continue
        ms = cuda_ms(torch, fns[i][0], 20)
        plain_ms = cuda_ms(torch, fns[i][1], PLAIN_REPS)
        torch.cuda.empty_cache()
        row = kernel_row(name, source, replaces, launches[name], errs[name], ms, plain_ms,
                         byts[i], n_pts * ops)
        say(f"[{label}] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"{byts[i] / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
            f"{byts[i] / ms / 1e9:.3f} TB/s ({byts[i] / ms / 1e9 / (HBM_BPS / 1e12):.2f} "
            f"of 3.35)")
        rows.append(row)
    return rows


def drive_dense(torch, mt, sweeps, prob, label, timed, dt, step_kw):
    """The default engine's path on the dense problem: the initial carry,
    one warm and `timed` timed steps.  Prints s/step, qp-evals/s (with its
    count: n_el n_q (3 Newton iterations + 1) per step, the assemble and
    two line-search residuals per iteration and the state update), the
    Newton and GMRES iterations, the residual drop and the plastic share
    of each step.  Fails unless the problem's three kernels were launched
    in each step and the state stayed finite; returns (carry, step, s/step,
    launches, [(step input carry, step output carry, drop)])."""
    names = kernel_names(sweeps, prob)
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[{label}] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, dt, **step_kw)
    t0 = time.perf_counter()
    carry = step(carry)
    torch.cuda.synchronize()
    say(f"[{label}] warm step {time.perf_counter() - t0:.3f} s {carry['newton']}")
    times, steps = [], []
    for _ in range(timed):
        before = carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        d = carry["newton"]
        steps.append((before, carry, d["norm"] / d["norm0"]))
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    evals = [prob.n_el * prob.n_q * (c["newton"]["iters"] * 3 + 1) for _, c, _ in steps]
    say(f"[{label}] {s_step:.4f} s/step over {timed} steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); {sum(evals) / sum(times):.4e} qp-evals/s "
        f"(n_el {prob.n_el} x n_q {prob.n_q} x (3 x Newton iterations + 1) per step: "
        f"{evals}); max|u| {float(carry['u'].abs().max()):.4e}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for i, (b, c, drop) in enumerate(steps):
        d = c["newton"]
        share = ""
        if c["state"] is not None:
            yielded = c["state"]["eqps"] > b["state"]["eqps"]
            share = (f"; plastic share {float(yielded.float().mean()):.4f}, eqps max "
                     f"{float(c['state']['eqps'].max()):.4e}")
        say(f"[{label}] timed step {i}: newton {d['iters']}, gmres {d['lin_iters']} "
            f"({d['lin_iters'] / max(d['iters'], 1):.1f} per solve), |r0| "
            f"{d['norm0']:.4e} -> |r| {d['norm']:.4e} (drop {drop:.2e}){share}")
    for name in names:  # at least once in each of the 1 + timed steps
        if launches[name] < 1 + timed:
            fail(f"kernel {name} was launched {launches[name]} times in {1 + timed} steps "
                 f"of {label}")
    if not all(c["newton"]["finite"] for _, c, _ in steps):
        fail(f"non-finite state on {label}")
    return carry, step, s_step, launches, steps


def drop_of(carry):
    """The step's Newton residual drop |r| / |r0| (0 for a step that starts
    at equilibrium)."""
    d = carry["newton"]
    return d["norm"] / d["norm0"] if d["norm0"] > 0 else 0.0


def hold_short_step(torch, mt, prob, before, after, dt, step_kw, label, gen, full=True,
                    r_bar=1e-4, plain=None):
    """A step of the kernel path whose Newton residual did not fall four
    orders (`after`, taken from the carry `before`), held against the
    plain path.  Always: the step's first Newton system, assembled by both
    paths from `before` (the residual at `r_bar` x scale, J w at the matvec
    bar, 1e-4 x scale).  With `full`, also the whole step on the plain path: the
    kernel path must not stop short where the plain path reaches the drop,
    its drop must be within 3x of the plain path's, and where Newton got
    the residual below 1e-2 of |r0| on both paths (a solution fixed to that
    precision) the two steps agree at 1e-4 x max|u|.  Where Newton stalls
    on both paths (GMRES at its cap: the configuration, not the kernel,
    phase 29 runs it in float64) the outputs of two stalled iterations are
    printed, not held.  Anything else fails the run.  `plain` is the plain
    path's step from `before` where the caller has it."""
    cap = step_kw["cg_iters"]
    ns = [mt.make_step(prob, dt, residual_impl=impl, **step_kw).newton_system(before)
          for impl in ("cuda", "torch")]
    w = torch.randn(ns[0]["r"].shape, generator=gen).to(prob.device, prob.dtype)
    jw = [n["J_apply"](w) for n in ns]
    r_err, r_scale = float((ns[0]["r"] - ns[1]["r"]).abs().max()), float(ns[1]["r"].abs().max())
    jw_err, jw_scale = float((jw[0] - jw[1]).abs().max()), float(jw[1].abs().max())
    d = after["newton"]
    say(f"[{label}] drop {drop_of(after):.3e} (newton {d['iters']}, gmres {d['lin_iters']}: "
        f"{d['lin_iters'] / max(d['iters'], 1):.1f} per solve against the cap of {cap}); the "
        f"step's first Newton system, kernel path vs plain path: residual max|err| "
        f"{r_err:.3e} of {r_scale:.3e}, J w {jw_err:.3e} of {jw_scale:.3e}")
    if not (r_err <= r_bar * r_scale and jw_err <= 1e-4 * jw_scale):
        fail(f"{label}: the Newton system differs between the kernel and plain paths")
    if not after["newton"]["finite"]:
        fail(f"{label}: non-finite state")
    if drop_of(after) > 1e-2:
        say(f"[{label}] Newton stalled on the kernel path (GMRES at its cap): the whole step "
            "is not rerun on the plain path, whose stalled iterates would not be held")
        return
    if not full:
        return
    if plain is None:
        plain = mt.make_step(prob, dt, residual_impl="torch", **step_kw)(before)
    dk, dp = drop_of(after), drop_of(plain)
    err = float((plain["u"] - after["u"]).abs().max())
    scale = float(plain["u"].abs().max())
    stalled = dp > 1e-2 and dk > 1e-2
    say(f"[{label}] the step on both paths: drop {dk:.3e} / {dp:.3e} (newton "
        f"{after['newton']['iters']}/{plain['newton']['iters']}, gmres "
        f"{after['newton']['lin_iters']}/{plain['newton']['lin_iters']}); max|du| {err:.3e} of "
        f"max|u| {scale:.3e} ({err / scale:.3e}); "
        + ("Newton stalls on both paths: two stalled iterations, not held" if stalled else
           "both stop short of 1e-4 at the float32 floor of the residual"))
    if not plain["newton"]["finite"]:
        fail(f"{label}: non-finite state on the plain path")
    if not (math.isfinite(dk) and dp > 1e-4 and dk <= 3.0 * dp):
        fail(f"{label}: the kernel path's Newton drop {dk} falls short of the plain path's "
             f"{dp} and of 1e-4")
    if not stalled and not err <= 1e-4 * scale:
        fail(f"{label}: kernel path vs plain path {err} > 1e-4 * {scale}")


def check_drops(torch, mt, prob, steps, dt, step_kw, label, gen, r_bar=1e-4):
    """Each timed step's Newton residual must fall four orders (rel_tol
    1e-8 is below float32 resolution); a step that does not is held kernel
    path against plain path from its input carry (hold_short_step): the
    whole step for the first such step, the Newton system for every one."""
    first = True
    for i, (before, after, drop) in enumerate(steps):
        if not (math.isfinite(drop) and drop <= 1e-4):
            hold_short_step(torch, mt, prob, before, after, dt, step_kw,
                            f"{label} timed step {i}", gen, full=first, r_bar=r_bar)
            first = False


def step_parity(torch, mt, build64, prob, dt, step_kw, label, gen, warm=0):
    """One step from the initial carry, kernel path against plain path at
    1e-4 x max|u|, finite state.  The float32 Newton residual may stop
    short of a 1e-4 drop at this size: the same step from the same carry
    in float64 on the plain path (`build64` builds the problem in float64)
    must reach it,
    and the float32 kernel step must agree with it at 1e-4 x max|u|; a
    float32 step short of the drop is then held as hold_short_step does.
    With `warm` > 0 the step held is step warm + 1: its carry is that of
    `warm` plain float64 steps from the initial carry, cast to float32, and
    the float64 plain step continues from the float64 carry."""
    if warm:
        p64 = build64()
        carry64 = mt.initial_carry(p64, residual_impl="torch")
        step64 = mt.make_step(p64, dt, residual_impl="torch", **step_kw)
        for i in range(warm):
            carry64 = step64(carry64)
            say(f"[{label}] float64 plain step {i + 1}: drop {drop_of(carry64):.2e}, newton "
                f"{carry64['newton']['iters']}, eqps max "
                f"{float(carry64['state']['eqps'].max()):.3e}")
        carry0 = dict(carry64, **{k: carry64[k].to(prob.dtype) for k in ("u", "v", "a")})
        carry0["state"] = {k: v.to(prob.dtype) for k, v in carry64["state"].items()}
    else:
        carry0 = mt.initial_carry(prob)
    out = {impl: mt.make_step(prob, dt, residual_impl=impl, **step_kw)(carry0)
           for impl in ("cuda", "torch")}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    plastic = ""
    if carry0["state"] is not None:
        plastic = "; points yielding in the step " + "/".join(
            str(int((out[i]["state"]["eqps"] > carry0["state"]["eqps"]).sum()))
            for i in ("cuda", "torch"))
    say(f"[{label}] cuda vs torch: max|du| {err:.3e} max|u| {scale:.3e} ({err / scale:.3e}); "
        f"newton {nc['iters']}/{nt['iters']} gmres {nc['lin_iters']}/{nt['lin_iters']}; "
        f"drop {drop_of(out['cuda']):.2e}/{drop_of(out['torch']):.2e}{plastic}")
    # the bar of the reference package's pallas-vs-soa parity check
    if not err <= 1e-4 * scale:
        fail(f"{label}: one-step parity {err} > 1e-4 * {scale}")
    if not warm:
        p64 = build64()
        carry64 = dict(carry0, **{k: carry0[k].double() for k in ("u", "v", "a")})
        if carry0["state"] is not None:
            carry64["state"] = {k: v.double() for k, v in carry0["state"].items()}
    ref = mt.make_step(p64, dt, residual_impl="torch", **step_kw)(carry64)
    err64 = float((out["cuda"]["u"].double() - ref["u"]).abs().max())
    scale64 = float(ref["u"].abs().max())
    say(f"[{label}] float64 plain step: Newton {ref['newton']['iters']}, drop "
        f"{drop_of(ref):.2e}; the float32 kernel step vs it max|du| {err64:.3e} of "
        f"{scale64:.3e} ({err64 / scale64:.3e})")
    if not (ref["newton"]["finite"] and drop_of(ref) <= 1e-4):
        fail(f"{label}: the float64 step did not reach a 1e-4 drop ({ref['newton']})")
    if not err64 <= 1e-4 * scale64:
        fail(f"{label}: the float32 kernel step vs float64 {err64} > 1e-4 * {scale64}")
    if not drop_of(out["cuda"]) <= 1e-4:
        hold_short_step(torch, mt, prob, carry0, out["cuda"], dt, step_kw, label, gen,
                        plain=out["torch"])
    elif not (nc["finite"] and nt["finite"]):
        fail(f"{label}: non-finite state")
    return p64, ref


def dense2d_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 27-32: the 2D dense-table path (the golden cantilever at
    p = 3), the 2D p = 2 instantiations and 3D dense J2.  27: host build of
    the 512^2 J2 problem; 28: every new kernel against plain (2D p = 3 at
    512^2, J2 on a plastic input; 2D p = 2 at 128^2; 3D J2 on the two-patch
    cube at 2 x 8^3); 29: one step kernel path against plain path (2D J2
    and neo-Hookean at 64^2, 3D two-patch J2 at 2 x 8^3); 30: the timed
    drives at 512^2 (J2 1 + 2 steps, neo-Hookean 1 + 2) and the short
    drives that launch the other instantiations; 31: one profiled step per
    2D material at 512^2; 32: the rows of the kernels line, timed at the
    drives' states.  Returns the rows."""
    rows = []
    t_start = time.perf_counter()

    def clock(what):
        say(f"[27-32 clock] {what}: {time.perf_counter() - t_start:.1f} s since phase 27")

    # ---- 29. one step at 64^2 (2D) and 2 x 8^3 (3D J2): cuda vs torch ----------
    f64 = torch.float64
    for name in ("J2", "CompressibleOgdenNeoHookean"):
        prob = balken_build(mt, name, 2, STEP2D_SUBDIVIDE, device)
        label = f"29. {2**STEP2D_SUBDIVIDE}^2 step {name}"
        p64, carry = step_parity(
            torch, mt, lambda: balken_build(mt, name, 2, STEP2D_SUBDIVIDE, device, f64), prob,
            GOLDEN_2D[name][1], STEP2D_KW, label, gen)
        if name != "J2":
            continue
        # the J2 configuration itself in float64 on the plain path, two
        # steps further (printed, not held): where Newton stalls here it is
        # the problem and its solver settings, not float32 or the kernels
        step64 = mt.make_step(p64, GOLDEN_2D[name][1], residual_impl="torch", **STEP2D_KW)
        for i in (1, 2):
            carry = step64(carry)
            d = carry["newton"]
            eqps = (f", eqps max {float(carry['state']['eqps'].max()):.3e}"
                    if carry["state"] is not None else "")
            say(f"[{label}] float64 plain step {i}: drop {drop_of(carry):.2e}, newton "
                f"{d['iters']}, gmres {d['lin_iters']} ({d['lin_iters'] / max(d['iters'], 1):.1f} "
                f"per solve, cap {STEP2D_KW['cg_iters']}), max|u| "
                f"{float(carry['u'].abs().max()):.3e}{eqps}")
        del p64, carry, step64
    prob = dense_build(mt, DENSE_CHECK_SPANS, device, "J2", A=A_PLASTIC)
    step_parity(torch, mt,
                lambda: dense_build(mt, DENSE_CHECK_SPANS, device, "J2", A_PLASTIC, f64), prob,
                STEP_KW["dt"], {k: v for k, v in STEP_KW.items() if k != "dt"},
                f"29. 2x{DENSE_CHECK_SPANS}^3 step J2, A {A_PLASTIC}", gen)

    # ---- 28. 3D dense J2 + cauchy against plain at 2 x 8^3 ----------------------
    prob = dense_build(mt, DENSE_CHECK_SPANS, device, "J2")
    u_el, a_el, w_el, state, share = dense_inputs(torch, sweeps, soa, prob, gen, STEP_KW["dt"],
                                                  0.2)
    label = f"28. 2x{DENSE_CHECK_SPANS}^3 random J2"
    say(f"[{label}] plastic share of the points {share:.3f}")
    if share < 0.25:
        fail(f"{label}: plastic share {share} < 0.25")
    compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, state, STEP_KW["dt"], label)
    del prob, u_el, a_el, w_el, state
    torch.cuda.empty_cache()
    clock("phases 28-29 at 64^2 and 2 x 8^3")

    # ---- 27-32. 2D p = 3 at 512^2 and p = 2 at 128^2 ------------------------------
    cases = [(name, 2, GOLDEN_SUBDIVIDE) for name in GOLDEN_2D]
    cases += [(name, 1, P2_SUBDIVIDE) for name in GOLDEN_2D]
    for name, elevate, subdivide in cases:
        force, dt, timed = GOLDEN_2D[name]
        n = 2**subdivide
        if elevate == 1:
            timed = 1
        tag = f"{n}^2 p={elevate + 1} {name}"
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        prob = balken_build(mt, name, elevate, subdivide, device)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        say(f"[27. {tag}] host build {host_s:.2f} s: n_el {prob.n_el}, n_q {prob.n_q}, nd "
            f"{prob.dense['dN_t'].shape[0]}, unknowns {prob.n_dof * prob.dim}; dense tables "
            f"{nbytes(prob.dense, prob.wdet_t) / 1e9:.3f} GB; device peak allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; host peak RSS of the process "
            f"{rss / 1e6:.3f} GB ({(rss - rss0) / 1e6:.3f} GB above its peak before the build)")
        u_el, a_el, w_el, state, share = dense_inputs(torch, sweeps, soa, prob, gen, dt, 0.2)
        if share is not None:
            say(f"[28. {tag} random] plastic share of the points {share:.3f}")
            if share < 0.25:
                fail(f"{tag}: plastic share {share} < 0.25: the check would not exercise "
                     "the return map")
        compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, state, dt, f"28. {tag} random")
        if elevate == 2:  # the viscous (2, 3) instantiations, printed for the record
            v_el = torch.randn(*u_el.shape, generator=gen).to(u_el)
            hold_viscous(torch, sweeps, prob, prob.material,
                         {"u_el": u_el, "a_el": a_el, "v_el": v_el, "w_el": w_el,
                          "state": state}, dt, f"38. {tag} random")
            del v_el
        del u_el, a_el, w_el, state
        torch.cuda.empty_cache()
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        carry, step, s_step, launches, steps = drive_dense(
            torch, mt, sweeps, prob, f"30. {tag}", timed, dt, STEP2D_KW)
        clock(f"{tag} drive")
        check_drops(torch, mt, prob, steps, dt, STEP2D_KW, f"30. {tag}", gen)
        clock(f"{tag} drops held")
        del steps
        u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen, dt)
        errs, C = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], dt,
                                f"28. {tag} path")
        rows += time_dense(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C, dt,
                           launches, errs, f"32. {tag} timing",
                           matvec=name != "StVenantKirchhoff")
        if name == "J2" and elevate == 2:
            dargs = (u_el, a_el, carry["state"], prob.dense["dN_t"], prob.dense["N_t"],
                     prob.wdet_t, prob.material, dt, float(prob.material.density))
            cap_share(torch, f"48. {tag} path", lambda: sweeps.residual_dense_plain(*dargs))
            del dargs
        if elevate == 2 and name != "StVenantKirchhoff":
            profile_step(torch, step, carry, s_step, f"31. {tag} profile")
        del prob, carry, step, u_el, a_el, w_el, C
        torch.cuda.empty_cache()
        clock(tag)

    # ---- 30, 32. 3D dense J2 on the cantilever's 2 x 38^3 tables -----------------
    sweeps.reset_launches()
    t0 = time.perf_counter()
    prob = dense_build(mt, DENSE_SPANS, device, "J2")
    torch.cuda.synchronize()
    tag = f"2x{DENSE_SPANS}^3 J2"
    say(f"[30. {tag}] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}")
    kw = {k: v for k, v in STEP_KW.items() if k != "dt"}
    carry, step, s_step, launches, steps = drive_dense(
        torch, mt, sweeps, prob, f"30. {tag}", 1, STEP_KW["dt"], kw)
    check_drops(torch, mt, prob, steps, STEP_KW["dt"], kw, f"30. {tag}", gen)
    u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen)
    errs, C = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"],
                            STEP_KW["dt"], f"28. {tag} path")
    rows += time_dense(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C,
                       STEP_KW["dt"], launches, errs, f"32. {tag} timing")
    del C
    v_el = torch.randn(*u_el.shape, generator=gen).to(u_el)
    hold_viscous(torch, sweeps, prob, prob.material,
                 {"u_el": u_el, "a_el": a_el, "v_el": v_el, "w_el": w_el,
                  "state": carry["state"]}, STEP_KW["dt"], f"38. {tag} path")
    del v_el
    del prob, carry, step, steps, u_el, a_el, w_el
    torch.cuda.empty_cache()
    clock(tag)
    return rows


def dense_finite_inputs(torch, sweeps, soa, prob, gen, dt, amplitude=0.2):
    """Random element fields and a random plastic history on the problem's
    dense tables (a finite-strain material): the state after one plain
    accumulate_soa at a random F with |F - I| up to `amplitude` per
    element, eqps raised by up to 1e-3, temperature 20-120; u_el at another
    such F, a_el and w_el of unit size.  Returns (u_el, a_el, w_el, state,
    plastic share of the points at u_el)."""
    mat, E, nq, dN = prob.material, prob.n_el, prob.n_q, prob.dense["dN_t"]
    shape = (prob.dim, dN.shape[0], E)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    uni = lambda *s: torch.rand(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    grad = lambda u: sweeps.dense_grad(u, dN)  # noqa: E731
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["temperature"] = 20.0 + 100.0 * uni(nq, E)
    u0, _ = near_identity(torch, grad, rnd(*shape), amplitude)
    state = mat.accumulate_soa(soa.add_diag(grad(u0), 1.0), state, dt)
    state = {k: v.contiguous() for k, v in state.items()}
    state["eqps"] = state["eqps"] + 1e-3 * uni(nq, E)
    u_el, _ = near_identity(torch, grad, rnd(*shape), amplitude)
    active = mat._return_map_soa(soa.add_diag(grad(u_el), 1.0), state, dt)[4]
    return u_el, rnd(*shape), rnd(*shape), state, float(active.float().mean())


def yield_margin(torch, sweeps, prob, u_el, state, tables=None, mat=None):
    """|q - H| / H per point (n_q, n_el): how far the plain trial state of
    a J2-family material (`mat`, default the problem's) lies from the yield
    surface, relative to the flow stress H (H thermo for the laws, sigma_y +
    H_iso eqps for J2Linear; grad_of's `tables`)."""
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.materials.logm import logm_sym_soa

    mat = mat or prob.material
    F = soa.add_diag(grad_of(sweeps, prob, u_el, tables), 1.0)
    if mat.name() == "J2Linear":
        eps = soa.add_diag(soa.sym(F) - state["plastic_strain"], -1.0)
        q = math.sqrt(1.5) * soa.fro_norm(soa.dev(eps, 2.0 * mat.G) - state["beta"])
        flow = mat.sigma_y + mat.isotropic_hardening * state["eqps"]
        return (q - flow).abs() / flow
    if mat.name() == "J2":
        q = mat._trial_soa(F, state)[2]
    elif mat.name() == "J2Simo":
        q = mat._trial_soa(F, state)[3]
    else:
        Fe = soa.matmul(F, state["Fp_inv"])
        E = 0.5 * logm_sym_soa(soa.matmul_tn(Fe, Fe))
        q = math.sqrt(1.5) * soa.fro_norm(soa.dev(E, 2.0 * mat.G))
    h = mat.hardening
    flow = h.evaluate(state["eqps"]) * h.thermo_contribution(state["temperature"])
    return (q - flow).abs() / flow


def yield_flips(torch, sweeps, soa, prob, u_el, state, dt):
    """(points on the plastic branch of the plain float32 return map at
    u_el, points whose yield decision the same plain return map takes
    otherwise in float64 on the same F and state): how many points sit so
    close to the yield surface that float32 rounding decides their branch,
    where the kernel, rounding in its own order, may take the other."""
    mat = prob.material
    F = soa.add_diag(sweeps.dense_grad(u_el, prob.dense["dN_t"]), 1.0)
    a32 = mat._return_map_soa(F, state, dt)[4]
    a64 = mat._return_map_soa(F.double(), {k: v.double() for k, v in state.items()}, dt)[4]
    return int(a32.sum()), int((a32 != a64).sum())


def deep_points(torch, sweeps, soa, prob, u_el, state):
    """Points whose fast log series' argument is out of range
    (materials/logm.py: ||X||_F > 0.40), where the J2Log kernels take the
    deep series."""
    from mimi_tpu_torch.materials import logm

    F = soa.add_diag(sweeps.dense_grad(u_el, prob.dense["dN_t"]), 1.0)
    Fe = soa.matmul(F, state["Fp_inv"])
    _, xn = logm._logm_core(soa.matmul_tn(Fe, Fe), *logm.LOGM_FAST)
    return int((~(xn <= logm.LOGM_X_MAX)).sum())


def check_dense_finite(torch, sweeps, soa, prob, gen, dt, label):
    """Phase 33 on one problem: its finite-strain material's three dense
    kernels against plain on random plastic input (in the fast log
    series' range), with the points whose yield decision float32 rounding
    decides; for J2Log also the same input with element 0 past the fast
    series' range (the deep series) and element 1 further (LOG_STRETCH),
    the plain calls on elements 0-1 and 2.. apart (the plain version
    escalates per batch, the kernel per point)."""
    u_el, a_el, w_el, state, share = dense_finite_inputs(torch, sweeps, soa, prob, gen, dt)
    n_pl, flips = yield_flips(torch, sweeps, soa, prob, u_el, state, dt)
    say(f"[{label}] plastic share of the points {share:.3f} ({n_pl} of {prob.n_el * prob.n_q}); "
        f"yield decision differs between the float32 and float64 plain return maps at {flips} "
        f"points; eqps of the history max {float(state['eqps'].max()):.4e}")
    if share < 0.25:
        fail(f"{label}: plastic share {share} < 0.25: the check would not exercise the return map")
    name = prob.material.name()
    if name == "J2Log":
        deep = deep_points(torch, sweeps, soa, prob, u_el, state)
        say(f"[{label}] points past the fast log series' range: {deep}")
        if deep:
            fail(f"{label}: the in-range input has {deep} points past the fast series' range")
    compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, state, dt, label)
    if name == "J2Log":
        st = {k: v.clone() for k, v in state.items()}
        for e, x in enumerate(LOG_STRETCH[prob.dim]):
            diag = torch.ones(prob.dim, dtype=prob.dtype, device=prob.device)
            diag[0] = x
            st["Fp_inv"][..., e] = torch.diag(diag)[:, :, None]
        deep = deep_points(torch, sweeps, soa, prob, u_el, st)
        say(f"[{label}, out of range] points past the fast log series' range: {deep} of "
            f"{prob.n_el * prob.n_q} (elements 0-1: {2 * prob.n_q} points)")
        if deep < 2 * prob.n_q:
            fail(f"{label}: the stretched elements do not leave the fast series' range")
        compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, st, dt, f"{label}, out of range",
                      parts={"elements 0-1 (deep series)": slice(0, 2),
                             "elements 2.. (fast series)": slice(2, None)})
    del u_el, a_el, w_el, state
    torch.cuda.empty_cache()


def dense_finite_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 33-37: the finite-strain plasticity models J2Simo and J2Log
    on dense tables with the full tangent.  33: every dense + full
    instantiation against plain on random plastic input (2D p = 3 at
    512^2, 2D p = 2 at 128^2, 3D p = 2 at 2 x 8^3), J2Log also past the
    fast log series' range; 34: one plastic step of the kernel path
    against the plain path (64^2 per material: the third step at dt 0.2
    from two float64 plain steps; 3D J2Simo at 2 x 8^3, A 1); 35: the timed
    drives (the golden cantilevers at 512^2 and 128^2 p = 2, 1 + 2 steps at
    dt 0.1; 2 x 38^3, 1 + 1), each step short of a 1e-4 Newton drop held
    against the plain path; 36: one profiled step per material at 512^2;
    37: the kernels' rows at the drives' states.  Returns the rows."""
    rows = []
    t_start = time.perf_counter()

    def clock(what):
        say(f"[33-37 clock] {what}: {time.perf_counter() - t_start:.1f} s since phase 33")

    f64 = torch.float64
    kw3 = {k: v for k, v in STEP_KW.items() if k != "dt"}

    # ---- 34. one plastic step: cuda vs torch ----------------------------------------
    for name in GOLDEN_FINITE:
        prob = balken_build(mt, name, 2, STEP2D_SUBDIVIDE, device)
        step_parity(torch, mt, lambda: balken_build(mt, name, 2, STEP2D_SUBDIVIDE, device, f64),
                    prob, PARITY_DT, STEP2D_KW,
                    f"34. {2**STEP2D_SUBDIVIDE}^2 step 3 {name}, dt {PARITY_DT}", gen, warm=2)
        del prob
    prob = dense_build(mt, DENSE_CHECK_SPANS, device, "J2Simo", A=A_PLASTIC)
    step_parity(torch, mt,
                lambda: dense_build(mt, DENSE_CHECK_SPANS, device, "J2Simo", A_PLASTIC, f64),
                prob, STEP_KW["dt"], kw3,
                f"34. 2x{DENSE_CHECK_SPANS}^3 step J2Simo, A {A_PLASTIC}", gen)

    # ---- 33. 3D dense + full against plain at 2 x 8^3 ---------------------------------
    for name in sweeps.FULL_KERNELS:
        prob = dense_build(mt, DENSE_CHECK_SPANS, device, name)
        check_dense_finite(torch, sweeps, soa, prob, gen, STEP_KW["dt"],
                           f"33. 2x{DENSE_CHECK_SPANS}^3 random {name}")
    del prob
    torch.cuda.empty_cache()
    clock("phases 33-34 at 64^2 and 2 x 8^3")

    # ---- 33, 35-37. 2D p = 3 at 512^2, p = 2 at 128^2, 3D at 2 x 38^3 --------------------
    cases = [(name, 2, GOLDEN_SUBDIVIDE) for name in GOLDEN_FINITE]
    cases += [(name, 1, P2_SUBDIVIDE) for name in GOLDEN_FINITE]
    cases += [(name, None, DENSE_SPANS) for name in GOLDEN_FINITE]
    for name, elevate, n in cases:
        if elevate is None:
            dt, timed, kw = STEP_KW["dt"], 1, kw3
            tag = f"2x{n}^3 {name}"
        else:
            _, dt, timed = GOLDEN_FINITE[name]
            kw = STEP2D_KW
            tag = f"{2**n}^2 p={elevate + 1} {name}"
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = (dense_build(mt, n, device, name) if elevate is None
                else balken_build(mt, name, elevate, n, device))
        torch.cuda.synchronize()
        say(f"[35. {tag}] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, n_q "
            f"{prob.n_q}, nd {prob.dense['dN_t'].shape[0]}, unknowns {prob.n_dof * prob.dim}; "
            f"dense tables {nbytes(prob.dense, prob.wdet_t) / 1e9:.3f} GB, state "
            f"{nbytes(prob.state0) / 1e9:.3f} GB, full tangent "
            f"{sweeps.n_planes('full', prob.dim)} planes "
            f"({sweeps.n_planes('full', prob.dim) * prob.n_q * prob.n_el * 4 / 1e9:.3f} GB); "
            f"device peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if elevate is not None:
            check_dense_finite(torch, sweeps, soa, prob, gen, dt, f"33. {tag} random")
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        carry, step, s_step, launches, steps = drive_dense(
            torch, mt, sweeps, prob, f"35. {tag}", timed, dt, kw)
        clock(f"{tag} drive")
        check_drops(torch, mt, prob, steps, dt, kw, f"35. {tag}", gen,
                    NEWTON_R_BAR.get(name, 1e-4))
        clock(f"{tag} drops held")
        del steps
        u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen, dt)
        n_pl, flips = yield_flips(torch, sweeps, soa, prob, u_el, carry["state"], dt)
        say(f"[33. {tag} path] plastic points at the next predictor {n_pl}; yield decision "
            f"differs between the float32 and float64 plain return maps at {flips}")
        # near equilibrium the residual is a small difference of element
        # forces, and both versions round be ~ I or log C_e ~ 0 in their own
        # order: the finite-strain path-state bar of phases 25-26
        errs, C = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], dt,
                                f"33. {tag} path", res_bar=PATH_RES_BAR)
        rows += time_dense(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C, dt,
                           launches, errs, f"37. {tag} timing", matvec=name == "J2Simo")
        if elevate == 2:
            profile_step(torch, step, carry, s_step, f"36. {tag} profile")
        del prob, carry, step, u_el, a_el, w_el, C
        torch.cuda.empty_cache()
        clock(tag)
    return rows


def as_f64(torch, x):
    """x with every floating tensor (in dicts, lists and tuples) in float64."""
    if isinstance(x, dict):
        return {k: as_f64(torch, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as_f64(torch, v) for v in x)
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def witnessed(torch, what, err, scale, bar, y_k, y_p, plain64):
    """A kernel output y_k held against its plain version y_p at `bar` x
    scale; where that fails and `plain64` (the plain version in float64 on
    the same inputs, a callable) is given, held instead against float64:
    the kernel passes if it is within `bar` x scale of the float64 output,
    or as close to it as the plain float32 output is, twice over.  Given
    only at a state that holds inverted elements, where float32 itself
    resolves the output no better.  Prints the witness; returns whether the
    output is held."""
    if err <= bar * scale:
        return True
    if not plain64:
        return False
    y64 = plain64()
    ok = ~torch.isnan(y64)
    e32 = float((y_p.double() - y64)[ok].abs().max())
    ek = float((y_k.double() - y64)[ok].abs().max())
    held = ek <= max(bar * scale, 2.0 * e32)
    say(f"    {what}: kernel vs plain {err:.3e} of {scale:.3e} past {bar:.1e}; the float64 "
        f"witness: plain float32 vs float64 {e32:.3e} ({e32 / scale:.3e}), kernel vs float64 "
        f"{ek:.3e} ({ek / scale:.3e}), bar max({bar:.1e}, 2x the plain's): "
        f"{'held' if held else 'not held'}")
    return held


def hold_viscous(torch, sweeps, prob, mat, f, dt, label, launches=None,
                 combos=((True, False),), inviscid_residual=False, storage=None,
                 residual=True, witness=False, timed=True):
    """The viscous and bfloat16 instantiations of `mat`'s kernels on the
    problem's tables, sum-factorized or dense (`mat` need not be the
    problem's: the tables do not depend on it), against their plain
    versions on the inputs `f` (u_el, a_el, v_el, w_el, state), for each
    (viscous, bfloat16 block) of `combos`: the residual (viscous only, it
    writes no block, unless `inviscid_residual`; none without `residual`),
    the assemble of the block in `storage` (default: the material's own)
    and the matvec on the plain version's block.  Bars: residual 1e-5 x
    scale; assemble residual and matvec 1e-4 x scale; float32 planes 1e-4
    of their group's max; bfloat16 planes 2^-7 of their group's max (one
    bfloat16 step) against the plain float32 planes rounded to bfloat16;
    points at a yield surface on the other branch in the kernel are counted
    and left out (planes_rel).  With `witness` (a path state that holds
    inverted elements), an output past its bar is held against the plain
    version in float64 instead (witnessed; the planes by their group's max
    likewise, over every point but the yield-band ones).  Each is timed
    (CUDA events over 20 calls,
    the plain version over PLAIN_REPS after a warm one) unless not `timed`;
    returns the rows with their launches in `launches` (0 where no driven
    path launched the variant: such rows are printed for the record, not
    put in the kernels line)."""
    import dataclasses

    launches = launches or {}
    vprob = dataclasses.replace(prob, material=mat)
    kind = "sf" if prob.sf is not None else "dense"
    tables, kern, plain = kernel_fns(sweeps, vprob)
    own, dim = sweeps.tangent_storage(mat), prob.dim
    storage = storage or own
    p = degree_of(prob)
    wq, rho = prob.wdet_t, float(mat.density)
    mu_v = float(mat.viscosity) if float(mat.viscosity) > 0.0 else VISC_MU
    fac0 = prob.facs["fac3"] * dt * dt
    fac1_mu_v = prob.facs["fac4"] * dt * mu_v
    args = (f["u_el"], f["a_el"], f["state"], *tables, wq, mat, dt, rho)
    args64 = as_f64(torch, args) if witness else None
    if kind == "sf":
        base, st = sf_ops(sweeps, vprob), sf_struct(prob)
        extra = (st["viscous"], st["viscous"], 18)
        full_apply = st["matvec"] + _FULL_APPLY
    else:
        base, nd = dense_ops(sweeps, vprob), prob.dense["dN_t"].shape[0]
        extra = (2 * dim * dim * nd + 2 * dim * dim,) * 2 + (2 * dim * dim,)
        # dense_ops' matvec with the full apply, 2 dim^4
        full_apply = (2 * dim * dim * nd + 2 * dim * nd + (2 * dim + 2) * dim * nd + dim
                      + 2 * dim**4)
    if storage != own:  # the full block of a material with a stronger own storage
        base = [base[0], base[1], full_apply]
    src = (lambda st: sf_source(st, p)) if kind == "sf" else DENSE_SOURCE.get
    source = (src(own), src(own), src(storage))
    el_out = nbytes(f["u_el"])
    n_pts = prob.n_el * prob.n_q
    rows, held = [], set()
    for visc, bf16 in combos:
        vk = dict(v_el=f["v_el"], mu_v=mu_v) if visc else {}
        fm = fac1_mu_v if visc else None
        cd = torch.bfloat16 if bf16 else torch.float32
        names = (*sweeps.kernel_counters(mat, kind, dim, p, visc, bf16, storage),
                 sweeps.matvec_counter(kind, storage, dim, p, visc, bf16))
        checks = []  # (i, name, err, kernel call, plain call, bytes)
        fields = (f["u_el"], f["a_el"], f["v_el"] if visc else None, tables, wq, f["state"])
        if residual and (visc or inviscid_residual) and names[0] not in held:
            held.add(names[0])  # it writes no block
            y_k = kern[0](*args, **vk)
            torch.cuda.synchronize()
            y_p = plain[0](*args, **vk)
            err, scale = masked_err(torch, y_k, y_p, names[0])
            say(f"[{label}] {names[0]}: max|err| {err:.3e} scale {scale:.3e} ({err / scale:.3e})")
            if not witnessed(torch, names[0], err, scale, 1e-5, y_k, y_p, witness and (
                    lambda vk=vk: plain[0](*args64, **as_f64(torch, vk)))):
                fail(f"{names[0]} disagrees with plain ({err} > 1e-5 * {scale}) [{label}]")
            del y_p
            checks.append((0, err, lambda vk=vk: kern[0](*args, **vk),
                           lambda vk=vk: plain[0](*args, **vk), nbytes(*fields) + el_out))
            del y_k
        ak = dict(vk, c_dtype=cd, storage=storage)
        ya_k, C_k = kern[1](*args, **ak)
        torch.cuda.synchronize()
        ya_p, C_p = plain[1](*args, **ak)
        if C_k.dtype != cd or C_k.shape[0] != sweeps.n_planes(storage, dim):
            fail(f"{names[1]} wrote a {C_k.dtype} block of {C_k.shape[0]} planes")
        err, scale = masked_err(torch, ya_k, ya_p, f"{names[1]} residual")
        bar = 2.0**-7 if bf16 else 1e-4
        rel, dmax, note, keep = planes_rel(torch, sweeps, prob, C_k, C_p, bar, args,
                                           f"{names[1]} [{label}]", mat, storage, witness)
        say(f"[{label}] {names[1]}: residual max|err| {err:.3e} scale {scale:.3e}; "
            f"{C_k.shape[0]} {'bfloat16' if bf16 else 'float32'} planes worst err vs group max "
            f"{rel:.3e} (bar {bar:.3e}){note}")
        if witness and (err > 1e-4 * scale or not rel <= bar):
            ya64, C64 = plain[1](*args64, **as_f64(torch, dict(vk, storage=storage)),
                                 c_dtype=torch.float64)
            # the planes of the points kept by planes_rel (the yield-band
            # points left out of both), every other point in
            groups = plane_groups(sweeps, storage, dim)
            rel_p = group_err(torch, C_p, C64, groups, keep)
            rel_k = group_err(torch, C_k, C64, groups, keep)
            held_planes = rel <= bar or rel_k <= max(bar, 2.0 * rel_p)
            say(f"    {names[1]} planes: kernel vs plain {rel:.3e} of the group max past "
                f"{bar:.1e}; the float64 witness: plain {'bfloat16' if bf16 else 'float32'} vs "
                f"float64 {rel_p:.3e}, kernel vs float64 {rel_k:.3e}, bar max({bar:.1e}, 2x the "
                f"plain's): {'held' if held_planes else 'not held'}")
            held_res = witnessed(torch, f"{names[1]} residual", err, scale, 1e-4, ya_k, ya_p,
                                 lambda y=ya64: y)
            del ya64, C64
        else:
            held_res, held_planes = err <= 1e-4 * scale, rel <= bar
        del keep
        if not held_res:
            fail(f"{names[1]} residual disagrees ({err} > 1e-4 * {scale}) [{label}]")
        if not held_planes:
            fail(f"{names[1]} planes disagree ({rel} of their group's max) [{label}]")
        checks.append((1, max(err, dmax), lambda ak=ak: kern[1](*args, **ak),
                       lambda ak=ak: plain[1](*args, **ak),
                       nbytes(*fields, C_p) + el_out))
        del ya_k, C_k, ya_p
        mv_args = (f["w_el"], *tables, wq, C_p, rho, fac0, fm)
        y_k = kern[2](*mv_args, storage=storage)
        torch.cuda.synchronize()
        y_p = plain[2](*mv_args, storage=storage)
        err, scale = masked_err(torch, y_k, y_p, names[2])
        say(f"[{label}] {names[2]}: max|err| {err:.3e} scale {scale:.3e}")
        if not witnessed(torch, names[2], err, scale, 1e-4, y_k, y_p, witness and (
                lambda a=mv_args: plain[2](*as_f64(torch, a), storage=storage))):
            fail(f"{names[2]} disagrees with plain ({err} > 1e-4 * {scale}) [{label}]")
        del y_p
        checks.append((2, err, lambda a=mv_args: kern[2](*a, storage=storage),
                       lambda a=mv_args: plain[2](*a, storage=storage),
                       nbytes(f["w_el"], tables, wq, C_p) + el_out))
        del y_k
        for i, _, _, _, byts in () if timed else checks:
            bound, by = bound_of(byts, n_pts * (base[i] + (extra[i] if visc else 0)))
            say(f"[{label}] {names[i]}: held, not timed; {byts / 1e9:.4f} GB, bound "
                f"{bound:.5f} ms by {by} at {prob.n_el} elements")
        for i, err, kcall, pcall, byts in checks if timed else ():
            ms = cuda_ms(torch, kcall, 20)
            plain_ms = cuda_ms(torch, pcall, PLAIN_REPS)
            torch.cuda.empty_cache()
            row = kernel_row(names[i], source[i], SYM_REPLACES[kind][i],
                             launches.get(names[i], 0), err, ms, plain_ms, byts,
                             n_pts * (base[i] + (extra[i] if visc else 0)))
            say(f"[{label} timing] {names[i]}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
                f"{byts / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
                f"{byts / ms / 1e9:.3f} TB/s ({byts / ms / 1e9 / (HBM_BPS / 1e12):.2f} of 3.35); "
                f"launches on a driven path {row['launches']}")
            rows.append(row)
        del C_p, checks
        torch.cuda.empty_cache()
    return rows


def random_visc_inputs(torch, sweeps, prob, mat, gen, dt, amplitude=0.1):
    """Random element fields on the problem's tables for `mat`: u_el with
    |F - I| up to `amplitude` per element, a_el, v_el and w_el of unit
    size; for a J2-family material a random history (its initial state,
    eqps up to 0.01, temperature 20-120)."""
    rnd = lambda *s: torch.randn(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    uni = lambda *s: torch.rand(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    shape = (prob.dim, nodes_of(prob), prob.n_el)
    u_el, _ = near_identity(torch, lambda u: grad_of(sweeps, prob, u), rnd(*shape), amplitude)
    state = None
    if mat.has_state:
        from mimi_tpu_torch.fem import soa

        state = soa.state_to_soa(mat.init_state((prob.n_el, prob.n_q), dtype=prob.dtype,
                                                device=prob.device))
        state["eqps"] = 0.01 * uni(prob.n_q, prob.n_el)
        state["temperature"] = 20.0 + 100.0 * uni(prob.n_q, prob.n_el)
    return {"u_el": u_el, "a_el": rnd(*shape), "v_el": rnd(*shape), "w_el": rnd(*shape),
            "state": state}


def press_material(mt):
    """The presses' material: the viscous neo-Hookean of the examples."""
    mat = mt.CompressibleOgdenNeoHookean()
    mat.density = 1e3
    mat.viscosity = 100.0
    mat.set_young_poisson(1e6, 0.3)
    return mat


def press_build(mt, dim, size, device, dtype=None, mat=None):
    """Path A (dim 2: two-patch-square.mesh at p = 2 subdivided `size`
    times, the top edge, bid 3, against a flat tool at y = 1) or path B
    (dim 3: cube-nurbs.mesh at p = 2 and size^3, the top face, bid 1,
    against the bilinear tool at z = 1); the other side clamped; penalty
    5e7; the presses' material unless `mat` is given (paths G and F)."""
    scene = mt.NearestDistanceToSplines()
    if dim == 2:
        scene.add_spline(mt.Bezier([1], [[-0.5, 1.0], [2.5, 1.0]]))
        scene.plant_kd_tree(200, 1)
    else:
        scene.add_spline(mt.Bezier([1, 1], [[-0.5, -0.5, 1.0], [-0.5, 1.5, 1.0],
                                            [1.5, -0.5, 1.0], [1.5, 1.5, 1.0]]))
        scene.plant_kd_tree(max(size, 8), 1)
    scene.coefficient = 5e7
    mat = mat or press_material(mt)
    if dim == 2:
        return mt.build_problem(TWO_SQUARE, 1, size, mat, [(2, 0), (2, 1)], {},
                                rho_inf=0.5, device=device, dtype=dtype, contact=[(3, scene)])
    return mt.build_problem(MESH, 1, 0, mat, [(0, 0), (0, 1), (0, 2)], {},
                            rho_inf=0.5, device=device, dtype=dtype, refine_spans=size,
                            contact=[(1, scene)])


def drive_press(torch, mt, sweeps, prob, label, step_kw, timed=None, engaged_each=True):
    """The default engine's path on a press: the initial carry, one warm
    and `timed` (default PRESS_TIMED) timed steps, the tool pushed before
    each.  Prints per
    step the wall time, Newton and GMRES counts, the residual drop, the
    closest-point projections, the face points that penetrate and that
    pass the angle gate, the contact force from the traction residual;
    s/step, qp-evals/s, peak device memory.  Fails unless the problem's
    three kernels were launched in each step, the state stayed finite and
    the tool engaged the body in every step (without `engaged_each`: in a
    timed step; the reference's press starts its tool 0.02 above the
    body).  Returns (carry, step, s/step, launches, the last scene
    data)."""
    NDS = mt.NearestDistanceToSplines
    timed = timed or PRESS_TIMED
    cd, cs = prob.contact[0], prob.contact_static[0]
    query, n_proj = cs["query"], [0]

    def counted_query(*a):  # closest-point projections per step
        n_proj[0] += 1
        return query(*a)

    cs["query"] = counted_query
    push = PRESS_PUSH[prob.dim]
    t0 = time.perf_counter()
    carry = mt.initial_carry(prob)
    torch.cuda.synchronize()
    say(f"[{label}] initial carry {time.perf_counter() - t0:.2f} s")
    step = mt.make_step(prob, **step_kw)
    sd, times, diags, engaged = cd["scene"], [], [], []
    n_fq = cd["wq"].numel()
    for i in range(1 + timed):
        sd = NDS.translate_scene_data(sd, push)
        p0 = n_proj[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = step(carry, contact_scenes=[sd])
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        d, c = carry["newton"], carry["contact"][0]
        force = (-c["res_el"].sum((0, 1))).tolist()
        tool = float(sd[0]["cps"][0, prob.dim - 1])
        say(f"[{label}] step {i} ({'warm' if i == 0 else 'timed'}), tool at {tool:.4f}: "
            f"{t_s:.3f} s; newton {d['iters']}, gmres {d['lin_iters']} "
            f"({d['lin_iters'] / max(d['iters'], 1):.1f} per solve, cap "
            f"{step_kw['cg_iters']}), |r0| {d['norm0']:.4e} -> |r| {d['norm']:.4e} (drop "
            f"{drop_of(carry):.3e}, converged {d['converged']}); projections "
            f"{n_proj[0] - p0}, unconverged {int(c['proj_unconverged'])}; face points "
            f"penetrating {int(c['n_penetrating'])} of {n_fq}, past the angle gate "
            f"{int(c['n_engaged'])}; force from the traction residual "
            f"({', '.join(f'{x:.4e}' for x in force)}); max|u| "
            f"{float(carry['u'].abs().max()):.4e}")
        if not d["finite"]:
            fail(f"{label}: non-finite state at step {i}")
        engaged.append(int(c["n_engaged"]))
        if i > 0:
            times.append(t_s)
            diags.append(d)
    cs["query"] = query
    launches = dict(sweeps.LAUNCHES)
    s_step = sum(times) / len(times)
    evals = [prob.n_el * prob.n_q * (d["iters"] * 3 + 1) for d in diags]
    say(f"[{label}] {s_step:.4f} s/step over {timed} timed steps "
        f"({', '.join(f'{t:.3f}' for t in times)}); {sum(evals) / sum(times):.4e} qp-evals/s "
        f"(n_el {prob.n_el} x n_q {prob.n_q} x (3 x Newton iterations + 1) per step: "
        f"{evals}); newton {[d['iters'] for d in diags]}, gmres "
        f"{[d['lin_iters'] for d in diags]}, drops "
        f"{', '.join(f'{d['norm'] / max(d['norm0'], 1e-300):.3e}' for d in diags)}; engaged points "
        f"{engaged}; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
        f"launches { {k: n for k, n in launches.items() if n} }")
    for name in press_kernel_names(sweeps, prob, step_kw):
        if launches[name] < 1 + timed:
            fail(f"kernel {name} was launched {launches[name]} times in {1 + timed} "
                 f"steps of {label}")
    if (min(engaged) if engaged_each else max(engaged[1:])) == 0:
        fail(f"{label}: a step ended with no face point past the angle gate ({engaged})")
    return carry, step, s_step, launches, sd


def press_kernel_names(sweeps, prob, step_kw):
    """Counter names (residual, assemble, matvec) of a press's viscous
    kernels, with the block of step_kw's matvec_dtype."""
    kind = "sf" if prob.sf is not None else "dense"
    bf16 = step_kw.get("matvec_dtype") == "bf16"
    tag, storage = sweeps.kernel_tag(prob.material), sweeps.tangent_storage(prob.material)
    p = degree_of(prob)
    return [*sweeps.material_counters(kind, tag, storage, prob.dim, p, True, bf16),
            sweeps.matvec_counter(kind, storage, prob.dim, p, True, bf16)]


def newton_system_parity(torch, mt, prob, carry, sd, step_kw, label, gen, prob64=None):
    """The Newton system of the next step from `carry` (with the tool at
    `sd` on a press, None without contact), kernel path against plain
    path: the residual at 1e-4 x scale, J w at 1e-4 x scale (2^-7 with a
    bfloat16 block: each path rounds its own).  With `prob64` (the problem
    in float64, given at a state that holds inverted elements), a part
    past its bar is held against the plain path's float64 system instead
    (witnessed).  Returns the two paths' steps.
    (Contact steps are held on the Newton system: which float32 points pass
    the reference's angle gate turns on rounding, ROADMAP Queue 3.)"""
    bf16 = step_kw.get("matvec_dtype") == "bf16"
    steps = [mt.make_step(prob, residual_impl=impl, **step_kw) for impl in ("cuda", "torch")]
    ns = [s.newton_system(carry, contact_scenes=None if sd is None else [sd]) for s in steps]
    w = torch.randn(ns[0]["r"].shape, generator=gen).to(prob.device, prob.dtype)
    jw = [n["J_apply"](w) for n in ns]
    r_err, r_scale = float((ns[0]["r"] - ns[1]["r"]).abs().max()), float(ns[1]["r"].abs().max())
    jw_err, jw_scale = float((jw[0] - jw[1]).abs().max()), float(jw[1].abs().max())
    jw_bar = 2.0**-7 if bf16 else 1e-4
    say(f"[{label}] the Newton system, kernel path vs plain path: residual max|err| "
        f"{r_err:.3e} of {r_scale:.3e} ({r_err / r_scale:.3e}); J w {jw_err:.3e} of "
        f"{jw_scale:.3e} ({jw_err / jw_scale:.3e}, bar {jw_bar:.3e})")
    ns64 = []

    def plain64():
        if not ns64:
            kw64 = dict(step_kw, matvec_dtype="f32", residual_impl="torch")
            ns64.append(mt.make_step(prob64, **kw64).newton_system(
                as_f64(torch, carry), contact_scenes=None if sd is None else [as_f64(torch, sd)]))
        return ns64[0]

    held = (witnessed(torch, "residual", r_err, r_scale, 1e-4, ns[0]["r"], ns[1]["r"],
                      prob64 and (lambda: plain64()["r"]))
            and witnessed(torch, "J w", jw_err, jw_scale, jw_bar, jw[0], jw[1],
                          prob64 and (lambda: plain64()["J_apply"](w.double()))))
    if not held:
        fail(f"{label}: the Newton system differs between the kernel and plain paths")
    return steps


def scatter_timing(torch, sh, prob, gen, label):
    """The fixed-order conn scatter of a multi-patch problem (fem/scatter.py,
    sharding._gather_scatter) on random float32 element values: its inverse
    map's bytes and its transient gather's, ms per call against the
    index_add_ it replaced (timed here only, as a yardstick), the largest
    difference between the two, and whether two of its calls agree to the
    bit (two index_add_ calls need not)."""
    _, scatter = sh._gather_scatter(prob)
    nd, dim, inv = prob.connT.shape[0], prob.dim, prob.conn_inv
    r = torch.randn(dim, nd, prob.n_el, generator=gen).to(prob.device, prob.dtype)
    idx = prob.connT.reshape(-1)

    def index_add():
        out = torch.zeros((dim, prob.n_dof), dtype=r.dtype, device=r.device)
        return out.index_add_(1, idx, r.reshape(dim, -1)).T

    y, y2, y_ia = scatter(r), scatter(r), index_add()
    torch.cuda.synchronize()
    ms, ms_ia = cuda_ms(torch, lambda: scatter(r), 20), cuda_ms(torch, index_add, 20)
    say(f"[{label}] conn scatter (fixed order): inverse map {tuple(inv.shape)} "
        f"{inv.numel() * inv.element_size() / 1e6:.1f} MB, transient gather "
        f"{dim * inv.numel() * r.element_size() / 1e6:.1f} MB; {ms:.4f} ms a call against "
        f"index_add_ {ms_ia:.4f} ms; max|diff| {float((y - y_ia).abs().max()):.3e} of "
        f"{float(y_ia.abs().max()):.3e}; two calls equal to the bit: {torch.equal(y, y2)}")
    if not torch.equal(y, y2):
        fail(f"{label}: the fixed-order scatter differs between two calls")


def press_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 38-42: the viscous neo-Hookean contact presses with the
    frozen contact tangent.  For each path: the host build, the new
    instantiations on the path's tables against plain on random input (38:
    at 2 x 512^2 the viscous dense (2, 2) kernels of the neo-Hookean, St.
    Venant-Kirchhoff and J2 materials; at 48^3 the neo-Hookean sf kernels
    viscous with a float32 block and inviscid with a bfloat16 one), the
    drive (39 path A, 41 path B: 1 warm + PRESS_TIMED steps), the path
    kernels against plain at the path's state and their rows, the next
    Newton system kernel path against plain path at full size, one
    profiled step, and one step held kernel path against plain path at a
    small size (40: 2 x 64^2, 42: 16^3).  Returns the rows of the kernels
    line."""
    NDS = mt.NearestDistanceToSplines
    rows = []
    for dim, size, held, tag in ((2, PRESS_2D_SUBDIVIDE, PRESS_2D_HELD, "A"),
                                 (3, SPANS, CHECK_SPANS, "B")):
        step_kw = dict(PRESS_STEP_KW, **({"matvec_dtype": "bf16"} if dim == 3 else {}))
        dt = step_kw["dt"]
        n_drive, n_held = ("39", "40") if dim == 2 else ("41", "42")
        size_s = f"2x{2**size}^2" if dim == 2 else f"{size}^3"
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = press_build(mt, dim, size, device)
        torch.cuda.synchronize()
        cd = prob.contact[0]
        label = f"{n_drive}. path {tag} {size_s}"
        tables = prob.dense if prob.dense is not None else (prob.sf["tables"], prob.sf["jinv"])
        say(f"[{label}] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, n_q "
            f"{prob.n_q}, unknowns {prob.n_dof * prob.dim}, {'dense' if prob.dense else 'sf'} "
            f"tables {nbytes(tables, prob.wdet_t) / 1e9:.3f} GB; contact elements "
            f"{cd['conn'].shape[0]} x {cd['wq'].shape[1]} points, mortar dofs "
            f"{prob.contact_static[0]['n_local']}; device peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if prob.grid is None:
            scatter_timing(torch, sh, prob, gen, label)

        # ---- 38. the new instantiations on the path's tables, random input ----
        if dim == 2:
            others = [("CompressibleOgdenNeoHookean", ((True, False),)),
                      ("StVenantKirchhoff", ((True, False),)), ("J2", ((True, False),))]
        else:
            others = [("CompressibleOgdenNeoHookean", ((True, False), (False, True)))]
        for name, combos in others:
            mat = jc_material(mt, name=name) if name == "J2" else hyper_material(mt, name)
            mat.setup(dim)
            f = random_visc_inputs(torch, sweeps, prob, mat, gen, dt,
                                   0.2 if name == "J2" else 0.1)
            # no driven path launches these: held, not timed
            hold_viscous(torch, sweeps, prob, mat, f, dt,
                         f"38. {size_s} random {sweeps.kernel_tag(mat)}", combos=combos,
                         timed=False)
            del f
            torch.cuda.empty_cache()

        # ---- 39 / 41. the drive ------------------------------------------------
        sweeps.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        carry, step, s_step, launches, sd = drive_press(torch, mt, sweeps, prob, label, step_kw)

        # ---- the path kernels at the path's state, their rows ---------------------
        g, _ = sh._gather_scatter(prob)
        fc = prob.facs
        xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
        va = carry["v"] + fc["fac2"] * dt * carry["a"]
        f = {"u_el": g(xa), "a_el": g(carry["a"]), "v_el": g(va), "state": None,
             "w_el": torch.randn(*g(xa).shape, generator=gen).to(device, prob.dtype)}
        del xa, va
        rows += hold_viscous(torch, sweeps, prob, prob.material, f, dt, f"{label} path",
                             launches, combos=((True, dim == 3),))
        del f
        torch.cuda.empty_cache()

        # ---- the next Newton system, kernel path vs plain path ----------------------
        sd_next = NDS.translate_scene_data(sd, PRESS_PUSH[dim])
        newton_system_parity(torch, mt, prob, carry, sd_next, step_kw, f"{label} next system",
                            gen)
        torch.cuda.empty_cache()

        # ---- one profiled step ------------------------------------------------------
        carry = profile_step(torch, step, carry, s_step, f"{label} profile",
                             contact_scenes=[sd_next])
        del carry, step, prob, cd, g, tables
        torch.cuda.empty_cache()

        # ---- 40 / 42. one step at a small size, kernel path vs plain path ----------
        hprob = press_build(mt, dim, held, device)
        hlabel = f"{n_held}. path {tag} {f'2x{2**held}^2' if dim == 2 else f'{held}^3'} step"
        carry0 = mt.initial_carry(hprob)
        sd = NDS.translate_scene_data(hprob.contact[0]["scene"], PRESS_PUSH[dim])
        steps = newton_system_parity(torch, mt, hprob, carry0, sd, step_kw, hlabel, gen)
        out = [s(carry0, contact_scenes=[sd]) for s in steps]
        err = float((out[0]["u"] - out[1]["u"]).abs().max())
        scale = float(out[1]["u"].abs().max())
        nk, npl = out[0]["newton"], out[1]["newton"]
        ck, cp = out[0]["contact"][0], out[1]["contact"][0]
        say(f"[{hlabel}] the whole step, kernel path vs plain path: max|du| {err:.3e} of max|u| "
            f"{scale:.3e} ({err / scale:.3e}); newton {nk['iters']}/{npl['iters']}, gmres "
            f"{nk['lin_iters']}/{npl['lin_iters']}, drops {nk['norm'] / nk['norm0']:.3e}/"
            f"{npl['norm'] / npl['norm0']:.3e}; past the angle gate {int(ck['n_engaged'])}/"
            f"{int(cp['n_engaged'])} of penetrating {int(ck['n_penetrating'])}/"
            f"{int(cp['n_penetrating'])}")
        if not (nk["finite"] and npl["finite"]) or int(cp["n_penetrating"]) == 0:
            fail(f"{hlabel}: a non-finite or unengaged step")
        del hprob, carry0, steps, out
        torch.cuda.empty_cache()
    return rows


def j2lin_material(mt, sigma_y=None):
    """J2Linear: E 2100, nu 0.3, density 1, no viscosity, the hardening
    moduli of the reference's tests/test_materials.py:256-260 (isotropic 50,
    kinematic 30), yield stress J2LIN_SIGMA_Y unless given."""
    mat = mt.J2Linear()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.set_young_poisson(2100.0, 0.3)
    mat.isotropic_hardening, mat.kinematic_hardening = J2LIN_MODULI
    mat.sigma_y = J2LIN_SIGMA_Y if sigma_y is None else sigma_y
    return mat


def law_material(mt, name, law, sigma_y=None):
    """The J2-family material `name` with the elastic and thermal data of
    jc_material and the PowerLaw ("pow": POWER_LAW, the reference's
    tests/test_pallas.py:397-440) or Voce ("voce": VOCE_LAW) hardening, its
    initial yield sigma_y where given."""
    mat = jc_material(mt, name=name)
    if law == "pow":
        h = mt.PowerLawHardening()
        h.sigma_y, h.n, h.eps0 = POWER_LAW
    else:
        h = mt.VoceHardening()
        h.sigma_y, h.sigma_sat, h.strain_constant = VOCE_LAW
    if sigma_y is not None:
        h.sigma_y = sigma_y
    mat.hardening = h
    return mat


# the body-force problems built so far, by mesh, refinement, clamped
# boundary, force, device, dtype and the material's elastic constants: the
# tables, the load and the FDM data depend on nothing else, so each is built
# once (~3-7 s at full size) and every other material of the same constants
# gets it through with_material
_BUILT = {}


def shared_build(mt, mat, dim, mesh, elevate, subdivide, clamp, force, device, spans=None,
                 dtype=None):
    """The body-force problem on `mesh` (boundary 1 loaded with `force` in
    y, the boundaries of `clamp` fixed) with the material `mat`, from
    _BUILT where it was built before."""
    from mimi_tpu_torch.fem import soa

    mat.setup(dim)
    key = (mesh, elevate, subdivide, tuple(clamp), force, spans, str(device), dtype,
           float(mat.lambda_), float(mat.mu))
    if key not in _BUILT:
        _BUILT[key] = mt.build_problem(mesh, elevate, subdivide, mat, clamp, {1: force},
                                       rho_inf=0.5, device=device, refine_spans=spans,
                                       dtype=dtype)
    return with_material(soa, _BUILT[key], mat)


def cube_of(mt, mat, spans, device, force=-3.0, dtype=None):
    """The body-force cube at `spans` per axis with the material `mat`."""
    return shared_build(mt, mat, 3, MESH, 1, 0, [(1, 0), (1, 1), (1, 2)], force, device, spans,
                        dtype)


def cantilever_of(mt, mat, elevate, subdivide, device, dtype=None):
    """The golden cantilever's mesh (boundary 2 clamped, body force -3) with
    the material `mat`."""
    return shared_build(mt, mat, 2, BALKEN, elevate, subdivide, [(2, 0), (2, 1)], -3.0, device,
                        dtype=dtype)


def plastic_mask(mat, F, state, dt):
    """The points on the plastic branch of a J2-family material's plain
    return map at F."""
    if mat.name() == "J2Linear":
        return mat._common_soa(F, state)[3] > 0
    if mat.name() == "J2":
        return mat._return_map(F, state, dt)[4]
    return mat._return_map_soa(F, state, dt)[4]


def plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amplitude):
    """Random element fields and a random plastic history of the J2-family
    material `mat` on the problem's tables (`mat` need not be the
    problem's): the state after one plain accumulate_soa from `mat`'s
    initial state at a random F with |F - I| up to `amplitude` per element
    (temperature 20-120 where the material has one), eqps raised by up to
    1e-3; u_el at another such F; a_el, v_el and w_el of unit size.
    Returns (fields as hold_viscous takes them, plastic share of the points
    at u_el)."""
    rnd = lambda *s: torch.randn(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    uni = lambda *s: torch.rand(*s, generator=gen).to(prob.device, prob.dtype)  # noqa: E731
    shape = (prob.dim, nodes_of(prob), prob.n_el)
    grad = lambda u: grad_of(sweeps, prob, u)  # noqa: E731
    state = soa.state_to_soa(mat.init_state((prob.n_el, prob.n_q), dtype=prob.dtype,
                                            device=prob.device))
    if "temperature" in state:
        state["temperature"] = 20.0 + 100.0 * uni(prob.n_q, prob.n_el)
    u0, _ = near_identity(torch, grad, rnd(*shape), amplitude)
    state = mat.accumulate_soa(soa.add_diag(grad(u0), 1.0), state, dt)
    state = {k: v.contiguous() for k, v in state.items()}
    state["eqps"] = state["eqps"] + 1e-3 * uni(prob.n_q, prob.n_el)
    u_el, _ = near_identity(torch, grad, rnd(*shape), amplitude)
    share = float(plastic_mask(mat, soa.add_diag(grad(u_el), 1.0), state, dt).float().mean())
    return {"u_el": u_el, "a_el": rnd(*shape), "v_el": rnd(*shape), "w_el": rnd(*shape),
            "state": state}, share


def hold_branches(torch, sweeps, soa, prob, cases, dt, label, gen):
    """Phase 43 on one problem's tables: each (material, (viscous,
    bfloat16) combinations, amplitude) of `cases` against its plain
    versions on random plastic input (plastic_inputs, share >= 0.25),
    residual, assemble and matvec of every combination (hold_viscous; no
    driven path launches them: held, not timed)."""
    kind = "sf" if prob.sf is not None else "dense"
    for mat, combos, amplitude in cases:
        mat.setup(prob.dim)
        tag = sweeps.kernel_tag(mat)
        f, share = plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amplitude)
        say(f"[43. {label} random {tag}] {kind} tables, {prob.n_el} elements; |F - I| up to "
            f"{amplitude}; plastic share of the points {share:.3f}; eqps of the history max "
            f"{float(f['state']['eqps'].max()):.4e}")
        if share < 0.25:
            fail(f"43. {label} {tag}: plastic share {share} < 0.25: the check would not exercise "
                 "the return map")
        hold_viscous(torch, sweeps, prob, mat, f, dt, f"43. {label} random {tag}",
                     combos=combos, inviscid_residual=True, timed=False)
        del f
        torch.cuda.empty_cache()


def drive_path(torch, mt, sweeps, sh, prob, label, dt, step_kw, gen, min_yield):
    """Phases 44-46 on one path: the host-built problem driven 1 warm +
    PATH_TIMED steps (drive_dense: s/step, qp-evals/s, Newton, GMRES, drops,
    the plastic share of each step, peak memory, the kernels launched in
    every step), each step short of a 1e-4 Newton drop held against the
    plain path (check_drops); the share of points with eqps > 0 after the
    last timed step (at least `min_yield`); the path's kernels against
    plain at the next predictor and their rows; the next Newton system
    kernel path against plain path; one profiled step.  Returns the rows of
    the residual and the assemble."""
    sweeps.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    carry, step, s_step, launches, steps = drive_dense(torch, mt, sweeps, prob, label,
                                                       PATH_TIMED, dt, step_kw)
    yielded = float((carry["state"]["eqps"] > 0).float().mean())
    say(f"[{label}] share of the points with eqps > 0 after the last timed step {yielded:.4f} "
        f"(at least {min_yield})")
    if not yielded >= min_yield:
        fail(f"{label}: {yielded} of the points yielded, fewer than {min_yield}")
    check_drops(torch, mt, prob, steps, dt, step_kw, label, gen)
    del steps
    u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen, dt)
    # Near equilibrium the residual is a small difference of element forces;
    # on sf tables F is formed with FMAs (sweeps_sf.cu), one ulp of 1 from the
    # plain version's, which is G x 1e-7 in the stress: the path-state bar of
    # phases 25-26, PATH_RES_BAR (the J2Linear cube read 2.0e-5 of max|y|
    # there, NVIDIA H100 80GB HBM3).  Dense F is the plain version's to the
    # bit: 1e-5.
    errs, C = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], dt,
                              f"{label} path",
                              res_bar=PATH_RES_BAR if prob.sf is not None else 1e-5)
    # the matvec instantiation is J2's, whose row the main path and phase 32
    # time: one row per name in the kernels line
    if prob.sf is not None:
        rows = time_sf(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C,
                       kernel_names(sweeps, prob)[:2], launches, errs, f"{label} timing")
    else:
        rows = time_dense(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C, dt,
                          launches, errs, f"{label} timing", matvec=False)
    del u_el, a_el, w_el, C
    torch.cuda.empty_cache()
    newton_system_parity(torch, mt, prob, carry, None, dict(step_kw, dt=dt),
                         f"{label} next system", gen)
    profile_step(torch, step, carry, s_step, f"{label} profile")
    return rows


def small_step(torch, mt, prob, dt, step_kw, label, gen):
    """Phase 47: one plastic step from the initial carry, kernel path
    against plain path at 1e-4 x max|u| where both reach a 1e-4 Newton
    drop; a step short of it is held from its input carry
    (hold_short_step).  Fails unless points yield on both paths."""
    carry0 = mt.initial_carry(prob)
    out = {impl: mt.make_step(prob, dt, residual_impl=impl, **step_kw)(carry0)
           for impl in ("cuda", "torch")}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    plastic = [int((out[i]["state"]["eqps"] > 0).sum()) for i in ("cuda", "torch")]
    say(f"[{label}] cuda vs torch: max|du| {err:.3e} max|u| {scale:.3e} ({err / scale:.3e}); "
        f"plastic points {plastic[0]}/{plastic[1]} of {prob.n_el * prob.n_q}; newton "
        f"{nc['iters']}/{nt['iters']} gmres {nc['lin_iters']}/{nt['lin_iters']}; drop "
        f"{drop_of(out['cuda']):.2e}/{drop_of(out['torch']):.2e}")
    if min(plastic) == 0:
        fail(f"{label}: no point yields in the step")
    if not (nc["finite"] and nt["finite"]):
        fail(f"{label}: non-finite state")
    if max(drop_of(out["cuda"]), drop_of(out["torch"])) <= 1e-4:
        # the bar of the reference package's pallas-vs-soa parity check
        if not err <= 1e-4 * scale:
            fail(f"{label}: one-step parity {err} > 1e-4 * {scale}")
    else:
        hold_short_step(torch, mt, prob, carry0, out["cuda"], dt, step_kw, label, gen,
                        r_bar=NEWTON_R_BAR.get(prob.material.name(), 1e-4),
                        plain=out["torch"])


def j2lin_law_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 43-47: J2Linear and the PowerLaw and Voce laws on the CUDA
    sweeps.  43: every new instantiation against plain at full size on
    random plastic input: J2Linear's sf (viscous and not, float32 and
    bfloat16 blocks) on path C's 48^3 tables, its dense (2, 3) on path D's
    512^2 tables, (2, 2) at 128^2 and (3, 2) at 2 x 8^3 (viscous and not);
    J2, J2Simo and J2Log with each law on the 48^3 and the 512^2 tables.
    44-46: paths C (J2Linear, 48^3 sf), D (J2Linear, 512^2 p = 3 dense) and
    E (J2 + PowerLaw, 48^3 sf) driven (drive_path).  47: one plastic step
    kernel path against plain path each of J2Linear at 16^3 and at 64^2
    p = 3, J2 + PowerLaw and J2Simo + Voce at 16^3, J2Log + PowerLaw at
    64^2 p = 3.  Returns the paths' rows of the kernels line."""
    rows = []
    t_start = time.perf_counter()
    kw3 = {k: v for k, v in STEP_KW.items() if k != "dt"}
    both = [(False, False), (False, True), (True, False), (True, True)]
    dense_visc = [(False, False), (True, False)]

    def clock(what):
        say(f"[43-47 clock] {what}: {time.perf_counter() - t_start:.1f} s since phase 43")

    def law_cases(amplitude):
        return [(law_material(mt, name, law), [(False, False)], amplitude)
                for name in ("J2", "J2Simo", "J2Log") for law in ("pow", "voce")]

    # ---- path C's tables: 43 (sf) and 44 -------------------------------------------
    t0 = time.perf_counter()
    prob = cube_of(mt, j2lin_material(mt), SPANS, device)
    torch.cuda.synchronize()
    say(f"[44. path C {SPANS}^3 J2Linear] host build {time.perf_counter() - t0:.2f} s: n_el "
        f"{prob.n_el}, n_q {prob.n_q}, unknowns {prob.n_dof * prob.dim}; state leaves "
        f"{sorted(prob.state0)} ({nbytes(prob.state0) / 1e9:.3f} GB)")
    hold_branches(torch, sweeps, soa, prob,
                  [(j2lin_material(mt), both, J2LIN_AMPLITUDE)] + law_cases(LAW_AMPLITUDE),
                  STEP_KW["dt"], f"{SPANS}^3", gen)
    clock("43 on the 48^3 tables")
    rows += drive_path(torch, mt, sweeps, sh, prob, f"44. path C {SPANS}^3 J2Linear", PATH_DT,
                       kw3, gen, YIELD_SHARE)
    del prob
    torch.cuda.empty_cache()
    clock("44")

    # ---- 46. path E ------------------------------------------------------------------
    t0 = time.perf_counter()
    prob = cube_of(mt, law_material(mt, "J2", "pow"), SPANS, device, force=-5.0)
    torch.cuda.synchronize()
    say(f"[46. path E {SPANS}^3 J2 + PowerLaw] host build {time.perf_counter() - t0:.2f} s")
    rows += drive_path(torch, mt, sweeps, sh, prob, f"46. path E {SPANS}^3 J2 + PowerLaw",
                       PATH_DT, kw3, gen, YIELD_SHARE)
    del prob
    torch.cuda.empty_cache()
    clock("46")

    # ---- path D's tables: 43 (dense (2, 3)) and 45 ---------------------------------------
    t0 = time.perf_counter()
    prob = cantilever_of(mt, j2lin_material(mt), 2, GOLDEN_SUBDIVIDE, device)
    torch.cuda.synchronize()
    tag = f"{2**GOLDEN_SUBDIVIDE}^2 p=3"
    say(f"[45. path D {tag} J2Linear] host build {time.perf_counter() - t0:.2f} s: n_el "
        f"{prob.n_el}, n_q {prob.n_q}, unknowns {prob.n_dof * prob.dim}; dense tables "
        f"{nbytes(prob.dense, prob.wdet_t) / 1e9:.3f} GB")
    hold_branches(torch, sweeps, soa, prob,
                  [(j2lin_material(mt), dense_visc, J2LIN_AMPLITUDE)] + law_cases(LAW_AMPLITUDE),
                  PATH_DT, tag, gen)
    clock("43 on the 512^2 tables")
    rows += drive_path(torch, mt, sweeps, sh, prob, f"45. path D {tag} J2Linear", PATH_DT,
                       STEP2D_KW, gen, 0.0)
    del prob
    torch.cuda.empty_cache()
    clock("45")

    # ---- 43: dense (2, 2) at 128^2 and (3, 2) at 2 x 8^3 -----------------------------------
    prob = cantilever_of(mt, j2lin_material(mt), 1, P2_SUBDIVIDE, device)
    hold_branches(torch, sweeps, soa, prob, [(j2lin_material(mt), dense_visc, J2LIN_AMPLITUDE)],
                  PATH_DT, f"{2**P2_SUBDIVIDE}^2 p=2", gen)
    prob = mt.build_problem(TWO_PATCH, 1, 0, j2lin_material(mt), [(0, 0), (0, 1), (0, 2)],
                            {1: -5.0}, rho_inf=0.5, device=device, refine_spans=DENSE_CHECK_SPANS)
    hold_branches(torch, sweeps, soa, prob, [(j2lin_material(mt), dense_visc, J2LIN_AMPLITUDE)],
                  PATH_DT, f"2x{DENSE_CHECK_SPANS}^3", gen)
    del prob
    torch.cuda.empty_cache()
    clock("43 at 128^2 and 2 x 8^3")

    # ---- 47. one plastic step each, kernel path vs plain path -------------------------------
    small = 2**STEP2D_SUBDIVIDE
    for label, prob, kw in (
        (f"{CHECK_SPANS}^3 J2Linear", cube_of(mt, j2lin_material(mt, SMALL_SIGMA_Y), CHECK_SPANS,
                                              device), kw3),
        (f"{small}^2 p=3 J2Linear", cantilever_of(mt, j2lin_material(mt, SMALL_SIGMA_Y), 2,
                                                  STEP2D_SUBDIVIDE, device), STEP2D_KW),
        (f"{CHECK_SPANS}^3 J2 + PowerLaw", cube_of(mt, law_material(mt, "J2", "pow", SMALL_SIGMA_Y),
                                                   CHECK_SPANS, device, force=-5.0), kw3),
        (f"{CHECK_SPANS}^3 J2Simo + Voce", cube_of(mt, law_material(mt, "J2Simo", "voce",
                                                                    SMALL_SIGMA_Y),
                                                   CHECK_SPANS, device, force=-5.0), kw3),
        (f"{small}^2 p=3 J2Log + PowerLaw", cantilever_of(
            mt, law_material(mt, "J2Log", "pow", SMALL_SIGMA_Y), 2, STEP2D_SUBDIVIDE, device),
         STEP2D_KW),
    ):
        small_step(torch, mt, prob, PATH_DT, kw, f"47. {label} step, sigma_y {SMALL_SIGMA_Y}", gen)
        del prob
        torch.cuda.empty_cache()
    clock("47")
    return rows


def cap_share(torch, label, plain_residual):
    """Phase 48, how far the radial return's cap of 40 trips binds on one
    kernel input: the plain residual `plain_residual` run as the kernels'
    twin (kernel_solver_mode) and as the "torch" engine's 100-trip solve;
    prints the share of the plastic points that reach the cap of 40 and
    that run past it.  (The kernels' times at 100 and 40 trips:
    scripts/ab_trip_cap.py.)"""
    from mimi_tpu_torch.materials import kernel_solver_mode, record_trips

    with kernel_solver_mode(), record_trips() as log40:
        plain_residual()
    with record_trips() as log100:
        plain_residual()
    t40, t100 = torch.cat([t.reshape(-1) for t in log40]), torch.cat(
        [t.reshape(-1) for t in log100])
    plastic = t40 > 0
    n_pl = max(int(plastic.sum()), 1)
    say(f"[{label}] plain twin: plastic points {int(plastic.sum())} of {t40.numel()}; share of "
        f"them at the cap of 40 trips {int((t40 >= 40).sum()) / n_pl:.4f}; without the cap past "
        f"40 {int((t100 > 40).sum()) / n_pl:.4f}, at 100 {int((t100 >= 100).sum()) / n_pl:.4f}; "
        f"mean trips {float(t40[plastic].float().mean()):.2f} (capped) / "
        f"{float(t100[plastic].float().mean()):.2f}")


def press_finite_material(mt, name):
    """The contact press's J2-family material `name` (J2; J2Simo or J2Log
    on paths F and G): the Johnson-Cook law A 700, B 1400, E 1e6, nu 0.3,
    density 1e3, viscosity 100."""
    mat = jc_material(mt, A=700.0, name=name)
    mat.hardening.B = 1400.0
    mat.density = 1e3
    mat.viscosity = 100.0
    mat.set_young_poisson(1e6, 0.3)
    return mat


def with_material(soa, prob, mat):
    """The problem with another material of the same elastic constants
    (the FDM data is the same) and that material's initial state (None for
    a stateless one)."""
    import dataclasses

    mat.setup(prob.dim)
    state0 = None
    if mat.has_state:
        state0 = soa.state_to_soa(mat.init_state((prob.n_el, prob.n_q), dtype=prob.dtype,
                                                 device=prob.device))
    return dataclasses.replace(prob, material=mat, state0=state0)


def full_others(mt, dim):
    """The materials whose kernels write the full block on request: J2,
    J2Linear, the neo-Hookean and the St. Venant-Kirchhoff material, set up
    for `dim`, with the body-force problems' data."""
    mats = [jc_material(mt), j2lin_material(mt), hyper_material(mt),
            hyper_material(mt, "StVenantKirchhoff")]
    for m in mats:
        m.setup(dim)
    return mats


def hold_full_others(torch, mt, sweeps, soa, prob, combos, dt, label, gen, timed=True):
    """The full block of J2 (Johnson-Cook, the golden's law), J2Linear and
    the hyperelastic materials on the problem's tables against the plain
    full planes (hold_viscous with storage="full", the residual being the
    material's own instantiation), on random input: plastic for the J2
    family (share >= 0.25), |F - I| up to 0.1 for the hyperelastic ones."""
    rows = []
    for mat in full_others(mt, prob.dim):
        tag = sweeps.kernel_tag(mat)
        if mat.has_state:
            amp = J2LIN_AMPLITUDE if tag == "j2lin" else 0.2
            f, share = plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amp)
            if share < 0.25:
                fail(f"{label} {tag}: plastic share {share} < 0.25")
        else:
            f, share = random_visc_inputs(torch, sweeps, prob, mat, gen, dt), 0.0
        say(f"[{label} full {tag}] plastic share of the points {share:.3f}")
        rows += hold_viscous(torch, sweeps, prob, mat, f, dt, f"{label} full {tag}",
                             combos=combos, storage="full", residual=False, timed=timed)
        del f
        torch.cuda.empty_cache()
    return rows


def cube3_of(mt, mat, spans, device, force=-3.0, dtype=None):
    """The body-force cube on the reference's p = 3 mesh at `spans` per
    axis with the material `mat` (path H's problem)."""
    return mt.build_problem(MESH3, 0, 0, mat, [(1, 0), (1, 1), (1, 2)], {1: force},
                            rho_inf=0.5, device=device, refine_spans=spans, dtype=dtype)


def two_patch3_of(mt, mat, spans, device, dtype=None):
    """The two-patch cube elevated by 2 to p = 3 at 2 x `spans`^3 with the
    material `mat` (path I's problem)."""
    return mt.build_problem(TWO_PATCH, 2, 0, mat, [(0, 0), (0, 1), (0, 2)], {1: -5.0},
                            rho_inf=0.5, device=device, refine_spans=spans, dtype=dtype)


def first_elements(prob, n):
    """The problem restricted to its first n elements (the sweeps are per
    element): tables, w det J and the initial state."""
    import dataclasses

    sl = slice(0, n)
    sf = None if prob.sf is None else dict(prob.sf, tables=_elements(prob.sf["tables"], sl),
                                           jinv=_elements(prob.sf["jinv"], sl))
    dense = None if prob.dense is None else _elements(prob.dense, sl)
    return dataclasses.replace(prob, n_el=n, sf=sf, dense=dense,
                               wdet_t=_elements(prob.wdet_t, sl),
                               state0=None if prob.state0 is None else _elements(prob.state0, sl))


def p3_materials(mt):
    """Every material the p = 3 kernels instantiate, set up in 3D: J2
    (Johnson-Cook, A 70), J2Linear, the neo-Hookean, St. Venant-Kirchhoff,
    J2Simo and J2Log (Johnson-Cook)."""
    mats = [jc_material(mt), j2lin_material(mt), hyper_material(mt),
            hyper_material(mt, "StVenantKirchhoff"), jc_material(mt, name="J2Simo"),
            jc_material(mt, name="J2Log")]
    for m in mats:
        m.setup(3)
    return mats


def hold_p3(torch, mt, sweeps, soa, prob, combos, label, gen, mats=None, full=True,
            amplitude=LAW_AMPLITUDE):
    """Phase 54 on one problem's p = 3 tables: each material's residual,
    assemble and matvec (hold_viscous, untimed: no driven path launches
    most of them) for each (viscous, bfloat16 block) of `combos`, on random
    plastic input for the J2 family (|F - I| up to `amplitude`, J2Linear's
    J2LIN_AMPLITUDE; share of plastic points >= 0.25), |F - I| up to 0.1
    for the hyperelastic ones; with `full` also the full block of J2,
    J2Linear and the hyperelastic materials."""
    dt = STEP_KW["dt"]
    for mat in mats or p3_materials(mt):
        tag = sweeps.kernel_tag(mat)
        if mat.has_state:
            amp = J2LIN_AMPLITUDE if tag == "j2lin" else amplitude
            f, share = plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, amp)
            if share < 0.25:
                fail(f"{label} {tag}: plastic share {share} < 0.25: the check would not "
                     "exercise the return map")
        else:
            f, share = random_visc_inputs(torch, sweeps, prob, mat, gen, dt), 0.0
        say(f"[{label} {tag}] {prob.n_el} elements, p = {degree_of(prob)}; plastic share of "
            f"the points {share:.3f}")
        hold_viscous(torch, sweeps, prob, mat, f, dt, f"{label} {tag}", combos=combos,
                     inviscid_residual=True, timed=False)
        del f
        torch.cuda.empty_cache()
    if full:
        hold_full_others(torch, mt, sweeps, soa, prob, combos, dt, label, gen, timed=False)


def p3_rows(torch, sweeps, prob, u_el, a_el, w_el, state, C, dt, launches, errs, label, parts):
    """Rows of the kernels line for the problem's p = 3 kernels at the
    path's state: CUDA-event times of the kernels on all elements, of their
    plain versions summed over the element slices `parts`, bytes (inputs
    read once, outputs written once) and bound."""
    mat, wq = prob.material, prob.wdet_t
    tables, kern, plain = kernel_fns(sweeps, prob)
    storage = sweeps.tangent_storage(mat)
    rho, fac0 = float(mat.density), prob.facs["fac3"] * dt * dt
    args = (u_el, a_el, state, *tables, wq, mat, dt, rho)
    mv_args = (w_el, *tables, wq, C, rho, fac0)
    calls = [(kern[0], plain[0], args, {}), (kern[1], plain[1], args, {}),
             (kern[2], plain[2], mv_args, {"storage": storage})]
    el_out = nbytes(u_el)
    byts = [nbytes(u_el, a_el, tables, wq, state) + el_out,
            nbytes(u_el, a_el, tables, wq, state, C) + el_out,
            nbytes(w_el, tables, wq, C) + el_out]
    kind = "sf" if prob.sf is not None else "dense"
    ops = sf_ops(sweeps, prob) if kind == "sf" else dense_ops(sweeps, prob)
    source = sf_source(storage, 3) if kind == "sf" else DENSE_SOURCE[storage]
    n_pts = prob.n_el * prob.n_q
    rows = []
    for i, name in enumerate(kernel_names(sweeps, prob)):
        kfn, pfn, a, kw = calls[i]
        ms = cuda_ms(torch, lambda: kfn(*a, **kw), 5)
        torch.cuda.empty_cache()
        plain_ms = 0.0
        for sl in parts.values():
            a_sl = _elements(a, sl)
            plain_ms += cuda_ms(torch, lambda: pfn(*a_sl, **kw), PLAIN_REPS)
            del a_sl
            torch.cuda.empty_cache()
        row = kernel_row(name, source, SYM_REPLACES[kind][i], launches[name], errs[name], ms,
                         plain_ms, byts[i], n_pts * ops[i])
        say(f"[{label}] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms (summed over "
            f"{len(parts)} slices); {byts[i] / 1e9:.3f} GB, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}; {byts[i] / ms / 1e9:.3f} TB/s "
            f"({byts[i] / ms / 1e9 / (HBM_BPS / 1e12):.2f} of 3.35); launches {row['launches']}")
        rows.append(row)
    return rows


def drive_p3(torch, mt, sweeps, sh, prob, label, timed, gen):
    """Phases 55-56 on one path: 1 warm + `timed` steps (drive_dense: s/step,
    qp-evals/s, Newton, GMRES, drops, the kernels launched in every step),
    peak memory, the share of points with eqps > 0; the path's kernels
    against plain at the next predictor, the plain versions on P3_PARTS
    slices of the elements (compare_kernels); their rows (p3_rows); one
    profiled step."""
    dt = STEP_KW["dt"]
    kw = {k: v for k, v in STEP_KW.items() if k != "dt"}
    sweeps.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    carry, step, s_step, launches, _ = drive_dense(torch, mt, sweeps, prob, label, timed, dt, kw)
    say(f"[{label}] peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
        + ("" if carry["state"] is None else
           f"; share of the points with eqps > 0 "
           f"{float((carry['state']['eqps'] > 0).float().mean()):.4f}"))
    u_el, a_el, w_el = predictor_fields(torch, sh, prob, carry, gen, dt)
    cut = [round(k * prob.n_el / P3_PARTS) for k in range(P3_PARTS + 1)]
    parts = {f"elements {a}-{b - 1}": slice(a, b) for a, b in zip(cut, cut[1:])}
    # sf tables: F is formed with FMAs, the path-state bar of phases 25-26
    errs, C = compare_kernels(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], dt,
                              f"{label} path", parts=parts,
                              res_bar=PATH_RES_BAR if prob.sf is not None else 1e-5,
                              whole_scale=True)
    rows = p3_rows(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], C, dt, launches, errs,
                   f"{label} timing", parts)
    del u_el, a_el, w_el, C
    torch.cuda.empty_cache()
    profile_step(torch, step, carry, s_step, f"{label} profile")
    return rows


def p3_phases(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 54-57: the cubic (p = 3) 3D sweeps.  54: every p = 3
    instantiation against plain on random input: the sf kernels at 16^3
    (every material, viscous or not, float32 and bfloat16 blocks, the full
    block of every material) and on a ragged tile (the first 33 elements),
    the dense (3, 3) kernels at 2 x 8^3 (viscous or not).  55: path H (48^3,
    sf).  56: path I (2 x 38^3, dense (3, 3)).  57: one step kernel path
    against plain path of path H's problem at 16^3 (yield stress
    SMALL_SIGMA_Y: the step yields) and of path I's at 2 x 8^3.  Returns the
    paths' rows of the kernels line."""
    t_start = time.perf_counter()
    both = [(False, False), (False, True), (True, False), (True, True)]
    dense_visc = [(False, False), (True, False)]

    def clock(what):
        say(f"[54-57 clock] {what}: {time.perf_counter() - t_start:.1f} s since phase 54")

    # ---- 54. every p = 3 instantiation on random input ---------------------------------
    prob = cube3_of(mt, jc_material(mt), CHECK_SPANS, device)
    hold_p3(torch, mt, sweeps, soa, prob, both, f"54. {CHECK_SPANS}^3 p=3 random", gen)
    mats = p3_materials(mt)
    # 33 elements hold ~100x fewer points than 16^3: |F - I| up to 0.2 keeps
    # the share of plastic points past 0.25 (0.128 at 0.1 on an NVIDIA H100
    # 80GB HBM3)
    hold_p3(torch, mt, sweeps, soa, first_elements(prob, P3_RAGGED),
            [(False, False), (True, True)], f"54. {P3_RAGGED} elements p=3 random", gen,
            mats=[mats[0], mats[2], mats[4]], full=False, amplitude=0.2)
    clock("54 sf")
    prob = two_patch3_of(mt, hyper_material(mt), DENSE_CHECK_SPANS, device)
    hold_p3(torch, mt, sweeps, soa, prob, dense_visc, f"54. 2x{DENSE_CHECK_SPANS}^3 p=3 random",
            gen)
    del prob
    torch.cuda.empty_cache()
    clock("54 dense")

    # ---- 55. path H ---------------------------------------------------------------------
    t0 = time.perf_counter()
    prob = cube3_of(mt, jc_material(mt), SPANS, device)
    torch.cuda.synchronize()
    label = f"55. path H {SPANS}^3 p=3 J2"
    say(f"[{label}] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, n_q "
        f"{prob.n_q}, nd {prob.sf['pp1'] ** 3}, unknowns {prob.n_dof * prob.dim}; sf tables "
        f"and jinv {nbytes(prob.sf['tables'], prob.sf['jinv']) / 1e9:.3f} GB")
    rows = drive_p3(torch, mt, sweeps, sh, prob, label, P3_TIMED, gen)
    del prob
    torch.cuda.empty_cache()
    clock("55")

    # ---- 56. path I ---------------------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    prob = two_patch3_of(mt, hyper_material(mt), DENSE_SPANS, device)
    torch.cuda.synchronize()
    label = f"56. path I 2x{DENSE_SPANS}^3 p=3 neo-Hookean"
    say(f"[{label}] host build {time.perf_counter() - t0:.2f} s: n_el {prob.n_el}, n_q "
        f"{prob.n_q}, nd {prob.dense['dN_t'].shape[0]}, unknowns {prob.n_dof * prob.dim}; "
        f"dense tables {nbytes(prob.dense, prob.wdet_t) / 1e9:.3f} GB (peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB)")
    rows += drive_p3(torch, mt, sweeps, sh, prob, label, P3_DENSE_TIMED, gen)
    del prob
    torch.cuda.empty_cache()
    clock("56")

    # ---- 57. one step each, kernel path vs plain path -----------------------------------
    kw3 = {k: v for k, v in STEP_KW.items() if k != "dt"}
    prob = cube3_of(mt, jc_material(mt, A=SMALL_SIGMA_Y), CHECK_SPANS, device)
    small_step(torch, mt, prob, STEP_KW["dt"], kw3,
               f"57. {CHECK_SPANS}^3 p=3 J2 step, A {SMALL_SIGMA_Y}", gen)
    prob = two_patch3_of(mt, hyper_material(mt), DENSE_CHECK_SPANS, device)
    carry0 = mt.initial_carry(prob)
    out = {impl: mt.make_step(prob, residual_impl=impl, **STEP_KW)(carry0)
           for impl in ("cuda", "torch")}
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    nc, nt = out["cuda"]["newton"], out["torch"]["newton"]
    say(f"[57. 2x{DENSE_CHECK_SPANS}^3 p=3 neo-Hookean step] cuda vs torch: max|du| {err:.3e} "
        f"max|u| {scale:.3e} ({err / scale:.3e}); newton {nc['iters']}/{nt['iters']} gmres "
        f"{nc['lin_iters']}/{nt['lin_iters']}; drop {drop_of(out['cuda']):.2e}/"
        f"{drop_of(out['torch']):.2e}")
    # the bar of the reference package's pallas-vs-soa parity check
    if not (nc["finite"] and err <= 1e-4 * scale):
        fail(f"p = 3 dense one-step parity {err} > 1e-4 * {scale}")
    del prob, carry0, out
    torch.cuda.empty_cache()
    clock("57")
    return rows


def finite_press_paths(torch, mt, sweeps, soa, sh, device, gen):
    """Phases 48-53: the finite-strain contact presses and the full block
    of every material.  48: how far the trip cap binds (cap_share), here
    on J2Log's random plastic input at the golden law (at the press's and
    the golden J2 cantilever's path states in phases 11 and 32).  49: on path F's 48^3 tables, J2Simo's and J2Log's viscous
    residual and their assemble and matvec viscous with a float32 block,
    viscous and inviscid with a bfloat16 one, against plain on random
    plastic input of the press's law; the full block of J2, J2Linear and
    the hyperelastic materials, every (viscous, bfloat16) pair.  50: path F,
    the reference's cube press (build_contact: the tool from 0.02 above the
    face, pushed 0.01 before each step) with J2Simo and with J2Log (1 warm
    + PRESS_F_TIMED steps, the bfloat16 full block), the path kernels at
    the path state (where it holds inverted elements, a check past its bar
    held against the plain version in float64),
    the next Newton system at full size kernel path vs plain path, a
    profiled step, one step held at 16^3.  51: path G, the 2D two-patch
    press with J2Simo (dense (2, 2), 2 x 512^2), the same, the step held at
    2 x 64^2; on its tables J2Log's viscous kernels and the full block of
    the other materials.  52: the viscous full kernels and the full block
    of the other materials at (2, 3) on 512^2 p = 3 and (3, 2) on 2 x 8^3.
    53: one body-force J2 step at 48^3 with tangent_storage="full" against
    the Cauchy storage's.  Returns the paths' rows of the kernels line."""
    NDS = mt.NearestDistanceToSplines
    rows = []
    t_start = time.perf_counter()
    sf_combos = ((True, False), (True, True), (False, True))
    all_sf = ((False, False), (True, False), (True, True), (False, True))
    dense_combos = ((False, False), (True, False))

    def clock(what):
        say(f"[48-53 clock] {what}: {time.perf_counter() - t_start:.1f} s since phase 48")

    def held_random(prob, names, combos, label, dt):
        for name in names:
            mat = press_finite_material(mt, name)
            mat.setup(prob.dim)
            f, share = plastic_inputs(torch, sweeps, soa, prob, mat, gen, dt, LAW_AMPLITUDE)
            say(f"[{label} random {name}] plastic share of the points {share:.3f}")
            if share < 0.25:
                fail(f"{label} {name}: plastic share {share} < 0.25")
            hold_viscous(torch, sweeps, prob, mat, f, dt, f"{label} random {name}",
                         combos=combos, timed=False)
            del f
            torch.cuda.empty_cache()

    for dim, size, held, tag in ((3, SPANS, CHECK_SPANS, "F"),
                                 (2, PRESS_2D_SUBDIVIDE, PRESS_2D_HELD, "G")):
        step_kw = dict(PRESS_STEP_KW, **({"matvec_dtype": "bf16"} if dim == 3 else {}))
        dt = step_kw["dt"]
        size_s = f"2x{2**size}^2" if dim == 2 else f"{size}^3"
        n_rand, n_drive = ("49", "50") if dim == 3 else ("51", "51")
        # path F: the reference's press (build_contact, the tool 0.02 above the
        # face); path G: path A's mesh and tool, touching
        build_path = ((lambda name, dtype=None: build_contact(mt, size, device, name, dtype))
                      if dim == 3 else
                      (lambda name, dtype=None: press_build(mt, dim, size, device, dtype,
                                                            press_finite_material(mt, name))))
        t0 = time.perf_counter()
        base = build_path("J2Simo")
        torch.cuda.synchronize()
        say(f"[{n_drive}. path {tag} {size_s}] host build {time.perf_counter() - t0:.2f} s: "
            f"n_el {base.n_el}, n_q {base.n_q}, unknowns {base.n_dof * base.dim}, "
            f"{'dense' if base.dense else 'sf'} tables; full block "
            f"{sweeps.n_planes('full', dim) * base.n_q * base.n_el * (2 if dim == 3 else 4) / 1e9:.3f}"
            f" GB ({'bfloat16' if dim == 3 else 'float32'})")
        if base.grid is None:
            scatter_timing(torch, sh, base, gen, f"{n_drive}. path {tag} {size_s}")

        # ---- 49 / 51. the new instantiations on the path's tables, random input -----
        held_random(base, sweeps.FULL_KERNELS, sf_combos if dim == 3 else ((True, False),),
                    f"{n_rand}. {size_s}", dt)
        hold_full_others(torch, mt, sweeps, soa, base, all_sf if dim == 3 else dense_combos, dt,
                         f"{n_rand}. {size_s}", gen, timed=False)
        if dim == 3:  # 48: J2Log's assemble at the golden law on random plastic input
            mat = jc_material(mt, name="J2Log")
            mat.setup(3)
            f, share = plastic_inputs(torch, sweeps, soa, base, mat, gen, STEP_KW["dt"],
                                      LAW_AMPLITUDE)
            tabs, jinv = base.sf["tables"], base.sf["jinv"]
            args = (f["u_el"], f["a_el"], f["state"], tabs, jinv, base.wdet_t, mat,
                    STEP_KW["dt"], 1.0)
            say(f"[48. {size_s} random J2Log, the golden law] plastic share {share:.3f}")
            cap_share(torch, f"48. {size_s} random J2Log, the golden law",
                      lambda: sweeps.residual_sf_plain(*args))
            del f, args
            torch.cuda.empty_cache()
        clock(f"path {tag}'s tables, random input")

        # ---- 50 / 51. the drives ---------------------------------------------------------
        for name in (sweeps.FULL_KERNELS if dim == 3 else ("J2Simo",)):
            prob = with_material(soa, base, press_finite_material(mt, name))
            label = f"{n_drive}. path {tag} {size_s} {name}"
            sweeps.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            carry, step, s_step, launches, sd = drive_press(torch, mt, sweeps, prob, label,
                                                            step_kw, PRESS_F_TIMED,
                                                            engaged_each=dim == 2)
            eqps = carry["state"]["eqps"]
            say(f"[{label}] eqps max {float(eqps.max()):.4e}, share of the points with eqps > 0 "
                f"{float((eqps > 0).float().mean()):.4f}")
            if not float(eqps.max()) > 0.0:
                fail(f"{label}: no point yielded")
            g, _ = sh._gather_scatter(prob)
            fc = prob.facs
            xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
            va = carry["v"] + fc["fac2"] * dt * carry["a"]
            f = {"u_el": g(xa), "a_el": g(carry["a"]), "v_el": g(va), "state": carry["state"],
                 "w_el": torch.randn(*g(xa).shape, generator=gen).to(device, prob.dtype)}
            del xa, va
            J = torch.linalg.det(soa.add_diag(grad_of(sweeps, prob, f["u_el"]), 1.0)
                                 .permute(2, 3, 0, 1))
            inverted = int((J <= 0).sum())
            say(f"[{label}] at the path state: det F min {float(J.min()):.4e}, points with "
                f"det F <= 0 {inverted} of {J.numel()}" + (
                    ": inverted elements, where float32 resolves the stress no better than the "
                    "float64 witness shows" if inverted else ""))
            del J
            # only a state that holds inverted elements holds a check past its
            # bar against the plain version in float64 (witnessed)
            named = {r["name"] for r in rows}  # J2Log's drive runs J2Simo's matvec
            rows += [r for r in hold_viscous(torch, sweeps, prob, prob.material, f, dt,
                                             f"{label} path", launches, combos=((True, dim == 3),),
                                             witness=inverted > 0)
                     if r["name"] not in named]
            del f
            torch.cuda.empty_cache()
            sd_next = NDS.translate_scene_data(sd, PRESS_PUSH[dim])
            prob64 = build_path(name, torch.float64) if inverted else None
            newton_system_parity(torch, mt, prob, carry, sd_next, step_kw,
                                 f"{label} next system", gen, prob64=prob64)
            del prob64
            torch.cuda.empty_cache()
            profile_step(torch, step, carry, s_step, f"{label} profile",
                         contact_scenes=[sd_next])
            del carry, step, prob
            torch.cuda.empty_cache()
            clock(f"path {tag} {name}")

            # one step at a small size, kernel path vs plain path
            hprob = press_build(mt, dim, held, device, mat=press_finite_material(mt, name))
            hsize = f"2x{2**held}^2" if dim == 2 else f"{held}^3"
            hlabel = f"{n_drive}. path {tag} {hsize} {name} step"
            carry0 = mt.initial_carry(hprob)
            sd0 = NDS.translate_scene_data(hprob.contact[0]["scene"], PRESS_PUSH[dim])
            steps = newton_system_parity(torch, mt, hprob, carry0, sd0, step_kw, hlabel, gen)
            out = [s(carry0, contact_scenes=[sd0]) for s in steps]
            err = float((out[0]["u"] - out[1]["u"]).abs().max())
            scale = float(out[1]["u"].abs().max())
            nk, npl = out[0]["newton"], out[1]["newton"]
            say(f"[{hlabel}] the whole step, kernel path vs plain path: max|du| {err:.3e} of "
                f"max|u| {scale:.3e} ({err / scale:.3e}); newton {nk['iters']}/{npl['iters']}, "
                f"gmres {nk['lin_iters']}/{npl['lin_iters']}, drops "
                f"{nk['norm'] / nk['norm0']:.3e}/{npl['norm'] / npl['norm0']:.3e}; plastic "
                f"points {int((out[0]['state']['eqps'] > 0).sum())}/"
                f"{int((out[1]['state']['eqps'] > 0).sum())}; penetrating "
                f"{int(out[0]['contact'][0]['n_penetrating'])}/"
                f"{int(out[1]['contact'][0]['n_penetrating'])}")
            if not (nk["finite"] and npl["finite"]) or int(
                    out[1]["contact"][0]["n_penetrating"]) == 0:
                fail(f"{hlabel}: a non-finite or unengaged step")
            del hprob, carry0, steps, out
            torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()
        clock(f"path {tag}")

    # ---- 52. (2, 3) at 512^2 p = 3 and (3, 2) at 2 x 8^3 -------------------------------------
    for prob, label in (
        (cantilever_of(mt, press_finite_material(mt, "J2Simo"), 2, GOLDEN_SUBDIVIDE, device),
         f"52. {2**GOLDEN_SUBDIVIDE}^2 p=3"),
        (mt.build_problem(TWO_PATCH, 1, 0, press_finite_material(mt, "J2Simo"),
                          [(0, 0), (0, 1), (0, 2)], {1: -5.0}, rho_inf=0.5, device=device,
                          refine_spans=DENSE_CHECK_SPANS), f"52. 2x{DENSE_CHECK_SPANS}^3"),
    ):
        held_random(prob, sweeps.FULL_KERNELS, ((True, False),), label, PRESS_STEP_KW["dt"])
        hold_full_others(torch, mt, sweeps, soa, prob, dense_combos, PATH_DT, label, gen,
                         timed=False)
        del prob
        torch.cuda.empty_cache()
    clock("52")

    # ---- 53. the full block on the body-force J2 cube, one step against cauchy ---------------
    prob = build(mt, SPANS, device)
    carry0 = mt.initial_carry(prob)
    sweeps.reset_launches()
    out = {s: mt.make_step(prob, tangent_storage=s, **STEP_KW)(carry0) for s in ("full", "cauchy")}
    err = float((out["full"]["u"] - out["cauchy"]["u"]).abs().max())
    scale = float(out["cauchy"]["u"].abs().max())
    nf, nc = out["full"]["newton"], out["cauchy"]["newton"]
    say(f"[53. {SPANS}^3 J2 step, full vs cauchy block] max|du| {err:.3e} of max|u| "
        f"{scale:.3e} ({err / scale:.3e}); newton {nf['iters']}/{nc['iters']}, gmres "
        f"{nf['lin_iters']}/{nc['lin_iters']}; launches "
        f"{ {k: n for k, n in sweeps.LAUNCHES.items() if n} }")
    for name in ("assemble_sf[j2,full]", "matvec_sf[full]", "assemble_sf", "matvec_sf"):
        if sweeps.LAUNCHES[name] == 0:
            fail(f"53: kernel {name} was not launched")
    if not err <= max(1e-4 * scale, 1e-7):
        fail(f"53: the full-block step differs from the Cauchy-block step ({err} > 1e-4 * "
             f"{scale})")
    del prob, carry0, out
    torch.cuda.empty_cache()
    clock("53")
    return rows


def main():
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off for matmul and cuDNN (full float32 products)")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device = torch.device("cuda")

    sys.path.insert(0, ROOT)
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.ops import build as kbuild
    from mimi_tpu_torch.ops import fused_neohookean as fused
    from mimi_tpu_torch.ops import sweeps
    from mimi_tpu_torch.parallel import sharding as sh
    from mimi_tpu_torch.solvers.linear import gmres

    # ---- 2. build ----------------------------------------------------------
    t0 = t_main = time.perf_counter()
    kbuild.load()
    build_s = time.perf_counter() - t0
    say(f"kernel build: {build_s:.2f} s (cached={kbuild.BUILD_INFO['cached']}; one nvcc "
        f"per source started together, then one link)")
    for line in kbuild.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    check_sf_ptxas(kbuild)

    gen = torch.Generator().manual_seed(0)

    # ---- 3. kernel vs plain at 16^3 -----------------------------------------
    prob = build(mt, CHECK_SPANS, device)
    E, h = prob.n_el, 1.0 / CHECK_SPANS
    dt_ = prob.dtype
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, dt_)  # noqa: E731
    u_el = 0.06 * h * rnd(3, 27, E)  # strains ~5-10%: past yield, F well-conditioned
    a_el, w_el = rnd(3, 27, E), rnd(3, 27, E)
    state = {k: v.clone() for k, v in prob.state0.items()}
    state["eqps"] = 0.01 * torch.rand(64, E, generator=gen).to(device, dt_)
    state["temperature"] = 20.0 + 100.0 * torch.rand(64, E, generator=gen).to(device, dt_)
    dF = sweeps.sf_grad(u_el, prob.sf["tables"], prob.sf["jinv"])
    *_, active, _ = prob.material._return_map(
        soa.add_diag(dF, 1.0), state, STEP_KW["dt"]
    )
    frac = float(active.float().mean())
    say(f"[16^3 random] plastic fraction of quadrature points: {frac:.3f}")
    if frac < 0.25:
        fail(f"plastic fraction {frac} < 0.25: the check would not exercise the return map")
    compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, state, "16^3 random")

    # ---- 4. one-step parity at 16^3 ------------------------------------------
    carry0 = mt.initial_carry(prob)
    out = {}
    for impl in ("cuda", "torch"):
        out[impl] = mt.make_step(prob, residual_impl=impl, **STEP_KW)(carry0)
    err = float((out["cuda"]["u"] - out["torch"]["u"]).abs().max())
    scale = float(out["torch"]["u"].abs().max())
    say(f"[16^3 step] cuda vs torch: max|du| {err:.3e} max|u| {scale:.3e} "
        f"newton {out['cuda']['newton']['iters']}/{out['torch']['newton']['iters']} "
        f"gmres {out['cuda']['newton']['lin_iters']}/{out['torch']['newton']['lin_iters']}")
    # the bar of the reference package's pallas-vs-soa parity check
    if not err <= max(1e-4 * scale, 1e-7):
        fail(f"one-step parity {err} > 1e-4 * {scale}")
    del prob, carry0, out, u_el, a_el, w_el, state, dF, active
    torch.cuda.empty_cache()

    # ---- 5. the main path at 48^3 -------------------------------------------
    sweeps.reset_launches()
    t0 = time.perf_counter()
    prob = build(mt, SPANS, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    say(f"[48^3] host build {host_s:.2f} s: n_el {prob.n_el}, n_q {prob.n_q}, "
        f"unknowns {prob.n_dof * prob.dim}; basis path: sum-factorized 1D tables "
        "+ per-point jinv and w det J (no dense N/dN tables)")
    carry, step, s_step, launches = drive(torch, mt, sweeps, prob, "48^3", TIMED_STEPS,
                                          [n for n, _ in KERNELS])
    eqps = carry["state"]["eqps"]
    say(f"[48^3] eqps max {float(eqps.max()):.4e}, plastic points {int((eqps > 0).sum())}")

    # ---- 6. kernels vs plain on the main path's inputs at 48^3 --------------
    g, _ = sh._gather_scatter(prob)
    u_el, a_el = g(carry["u"]), g(carry["a"])
    w_el = torch.randn(3, 27, prob.n_el, generator=gen).to(device, prob.dtype)
    errs, C = compare_sweeps(torch, sweeps, prob, u_el, a_el, w_el, carry["state"], "48^3 path")
    tabs, jinv, wq, mat = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.material
    rho, dt = float(mat.density), STEP_KW["dt"]
    fac0 = prob.facs["fac3"] * dt * dt
    st = carry["state"]
    calls = {
        "matvec_sf": (lambda: sweeps.matvec_sf(w_el, tabs, jinv, wq, C, rho, fac0),
                      lambda: twin(sweeps.matvec_sf_plain)(w_el, tabs, jinv, wq, C, rho, fac0)),
        "assemble_sf": (lambda: sweeps.assemble_sf(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho),
                        lambda: twin(sweeps.assemble_sf_plain)(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho)),
        "residual_sf": (lambda: sweeps.residual_sf(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho),
                        lambda: twin(sweeps.residual_sf_plain)(u_el, a_el, st, tabs, jinv, wq, mat, dt, rho)),
    }
    n_pts = prob.n_el * prob.n_q
    el_out = 3 * 27 * prob.n_el * 4
    byts = {  # inputs read once, outputs written once
        "matvec_sf": nbytes(w_el, tabs, jinv, wq, C) + el_out,
        "assemble_sf": nbytes(u_el, a_el, tabs, jinv, wq, st, C) + el_out,
        "residual_sf": nbytes(u_el, a_el, tabs, jinv, wq, st) + el_out,
    }
    rows = []
    for name, replaces in KERNELS:
        kern, plain = calls[name]
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        row = kernel_row(name, SOURCE[0], replaces, launches[name], errs[name], ms,
                         plain_ms, byts[name], n_pts * OPS_PER_POINT[name])
        say(f"[48^3 timing] {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({byts[name] / 1e9:.3f} GB); "
            f"{byts[name] / ms / 1e9:.3f} TB/s")
        rows.append(row)

    # ---- 7. cost of the GMRES loop's per-iteration host sync -----------------
    ns = step.newton_system(carry)
    J_apply, M_apply, r = ns["J_apply"], ns["M_apply"], ns["r"]
    n_it = 1

    def solve():  # one FDM-GMRES solve, reading its Hessenberg column per iteration
        nonlocal n_it
        _, info = gmres(J_apply, r, M_apply=M_apply, rel_tol=STEP_KW["lin_rel_tol"],
                        abs_tol=1e-12, restart=30, max_iter=40, return_info=True)
        n_it = max(int(info["iters"]), 1)

    def device_work():  # the same solve's device work, no host reads
        V = torch.zeros((n_it + 1, r.numel()), dtype=r.dtype, device=device)
        M_apply(r)
        V[0] = M_apply(r - J_apply(torch.zeros_like(r)))
        for j in range(n_it):
            w = M_apply(J_apply(V[j]))
            hh = V[: j + 1] @ w
            w = w - hh @ V[: j + 1]
            V[j + 1] = w / torch.clamp(w.norm(), min=1e-30)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    solve()
    device_work()
    pairs = [(wall_ms(solve), wall_ms(device_work)) for _ in range(7)]
    t_solve = sorted(a for a, _ in pairs)[3]
    t_dev = sorted(b for _, b in pairs)[3]
    say(f"[48^3 gmres] {n_it} iterations, median of 7: {t_solve:.3f} ms with a host "
        f"read per iteration, {t_dev:.3f} ms for the same device work unsynchronized; "
        f"host sync cost {(t_solve - t_dev) / n_it:.4f} ms/iteration "
        f"(per-pair spread {min(a - b for a, b in pairs) / n_it:.4f} to "
        f"{max(a - b for a, b in pairs) / n_it:.4f})")

    # ---- 8. where one step's device time goes (torch.profiler) -------------
    carry = profile_step(torch, step, carry, s_step, "48^3 profile")

    del C, ns, J_apply, M_apply, calls, u_el, a_el, w_el, st
    del prob, carry, step
    torch.cuda.empty_cache()

    say(f"[clock] phases 1-8 done: {time.perf_counter() - t_main:.1f} s since phase 2")
    # ---- 9-12. the contact press ---------------------------------------------
    rows += contact_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 9-12 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 13-18. the dense-table path, the fused kernels on its tables ----------
    rows += dense_phases(torch, mt, sweeps, fused, sh, device, gen)
    say(f"[clock] phases 13-18 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 19-22. the hyperelastic single-patch path ------------------------------
    rows += hyper_phases(torch, mt, sweeps, sh, device, gen)
    say(f"[clock] phases 19-22 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 23-26. finite-strain J2 plasticity with the full tangent -----------------
    rows += finite_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 23-26 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 27-32. the 2D dense-table path, 3D dense J2 --------------------------------
    rows += dense2d_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 27-32 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 33-37. J2Simo and J2Log on dense tables with the full tangent ------------------
    rows += dense_finite_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 33-37 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 38-42. the viscous neo-Hookean contact presses, frozen tangent -----------------
    rows += press_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 38-42 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 43-47. J2Linear and the PowerLaw and Voce laws -----------------------------------
    rows += j2lin_law_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 43-47 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 48-53. the finite-strain presses (paths F and G), the full block --------------------
    rows += finite_press_paths(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 48-53 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    # ---- 54-57. the cubic (p = 3) sweeps: paths H and I --------------------------------------
    _BUILT.clear()  # no p = 2 problem is built again; path I needs the card's memory
    torch.cuda.empty_cache()
    rows += p3_phases(torch, mt, sweeps, soa, sh, device, gen)
    say(f"[clock] phases 54-57 done: {time.perf_counter() - t_main:.1f} s since phase 2")

    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
