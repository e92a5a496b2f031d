"""The element shapes of the port's paths that were driven before every
degree, quadrature order and element shape was ported: sf (p + 1, n_g) at
p = 2 and p = 3; dense (dimension, degree) 2D p = 2 (the examples), 2D p = 3
(the golden cantilever), 3D p = 2 and p = 3; each with its default p + 2
Gauss points per axis.  The kernels build any shape at its first launch;
these are the ones the older tests walk."""

SF_SHAPES = ((3, 4), (4, 5))
DENSE_SHAPES = ((2, 2), (2, 3), (3, 2), (3, 3))
