"""The element shapes of the port's paths that were driven before every
degree, quadrature order and element shape was ported: sf (p + 1, n_g) at
p = 2 and p = 3; dense (dimension, degree) 2D p = 2 (the examples), 2D p = 3
(the golden cantilever), 3D p = 2 and p = 3; each with its default p + 2
Gauss points per axis.  The kernels build any shape at its first launch;
these are the ones the older tests walk.  Beside them, the dense shapes at
which the host build holds the kernels that run on owner warps and a flux
warp at every shape or at the untiled 3D ones: the fused neo-Hookean
tangent apply, and 3D J2's residual and assemble."""

SF_SHAPES = ((3, 4), (4, 5))
DENSE_SHAPES = ((2, 2), (2, 3), (3, 2), (3, 3))
# (dim, nd, n_q): the 3D dense cell's, 3D p = 1, 2D p = 2 at 3 Gauss points
# per axis, path L's 2D p = 4 and 3D p = 4
FUSED_APPLY_SHAPES = ((3, 27, 64), (3, 8, 27), (2, 9, 9), (2, 25, 36), (3, 125, 216))
# the 3D dense cells' and path J's 3D p = 2, and 3D p = 1
J2_UNTILED_3D_SHAPES = ((3, 27, 64), (3, 8, 27))
