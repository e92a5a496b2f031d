"""mimi_tpu_torch: the implicit isogeometric solid-mechanics step of
mimi_tpu, ported to PyTorch with hand-written CUDA kernels for Hopper.

The package imports torch and never jax.  It covers three paths of the
compiled core: one polynomial 3D NURBS patch with J2 plasticity and
Johnson-Cook hardening (and viscosity) on the three sum-factorized
quadrature sweeps; mortar penalty contact against rigid spline scenes
(contact/); and multi-patch or repeated-knot 3D meshes with the
neo-Hookean material on the three dense-table sweeps with the 45-plane
symmetric tangent (fem/multipatch.py, the additive-Schwarz FDM).  All
step with generalized-alpha, line-search Newton and FDM-preconditioned
GMRES (ops/sweeps.py; CUDA sources in ops/csrc/).  The entry points run
on the CUDA device unless the caller passes device="cpu".
"""

from .contact.scene import NearestDistanceToSplines  # noqa: F401

from .materials import J2, CompressibleOgdenNeoHookean, Material  # noqa: F401
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
    "CompressibleOgdenNeoHookean",
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
