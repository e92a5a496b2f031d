"""mimi_tpu_torch: the implicit isogeometric solid-mechanics step of
mimi_tpu, ported to PyTorch with hand-written CUDA kernels for Hopper.

The package imports torch and never jax.  It covers the compiled core's
two benchmark paths: one polynomial 3D NURBS patch, J2 plasticity with
Johnson-Cook hardening (and viscosity), generalized-alpha time stepping
with line-search Newton and FDM-preconditioned GMRES, the three
sum-factorized quadrature sweeps (ops/sweeps.py; CUDA sources in
ops/csrc/), and mortar penalty contact against rigid spline scenes
(contact/).
"""

from .contact.scene import NearestDistanceToSplines  # noqa: F401

from .materials import J2, Material  # noqa: F401
from .materials.hardening import (  # noqa: F401
    Hardening,
    PowerLawHardening,
    VoceHardening,
    JohnsonCookHardening,
    JohnsonCookRateDependentHardening,
    JohnsonCookTemperatureAndRateDependentHardening,
    JohnsonCookViscoConstantTemperatureHardening,
)
from .parallel.sharding import Problem, build_problem, initial_carry, make_step  # noqa: F401
from .splines import NURBS, Bezier, BSpline  # noqa: F401

__all__ = [
    "Material",
    "J2",
    "Hardening",
    "PowerLawHardening",
    "VoceHardening",
    "JohnsonCookHardening",
    "JohnsonCookRateDependentHardening",
    "JohnsonCookTemperatureAndRateDependentHardening",
    "JohnsonCookViscoConstantTemperatureHardening",
    "Problem",
    "build_problem",
    "initial_carry",
    "make_step",
    "NearestDistanceToSplines",
    "Bezier",
    "BSpline",
    "NURBS",
]
