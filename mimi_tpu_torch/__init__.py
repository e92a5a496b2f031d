"""mimi_tpu_torch: the implicit isogeometric solid-mechanics step of
mimi_tpu, ported to PyTorch with hand-written CUDA kernels for Hopper.

The package imports torch and never jax.  It covers five paths of the
compiled core: one polynomial 3D NURBS patch on the three sum-factorized
quadrature sweeps, with small-strain J2 plasticity (J2 with any of the
five hardening laws, J2Linear; and viscosity; the 37-plane Cauchy
tangent), with a hyperelastic material
(neo-Hookean, St. Venant-Kirchhoff; the 45-plane symmetric tangent) or with
finite-strain J2 plasticity (J2Simo, J2Log; the 81-plane full tangent,
which every material also writes on request), each with viscosity and a
bfloat16 tangent block;
mortar penalty contact against rigid spline scenes (contact/); and
multi-patch or repeated-knot 3D meshes with the hyperelastic materials on
the three dense-table sweeps with the symmetric tangent
(fem/multipatch.py, the additive-Schwarz FDM).  All step with
generalized-alpha, line-search Newton and FDM-preconditioned GMRES
(ops/sweeps.py; CUDA sources in ops/csrc/).  ops/fused_neohookean.py
holds the fused neo-Hookean residual and matrix-free tangent apply.  The
entry points run on the CUDA device unless the caller passes device="cpu".
"""

from .contact.scene import NearestDistanceToSplines  # noqa: F401

from .materials import (  # noqa: F401
    J2,
    J2Linear,
    J2Log,
    J2Simo,
    CompressibleOgdenNeoHookean,
    Material,
    StVenantKirchhoff,
)
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
    "J2Linear",
    "J2Simo",
    "J2Log",
    "CompressibleOgdenNeoHookean",
    "StVenantKirchhoff",
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
