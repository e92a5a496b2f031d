// The p = 3 instantiations of sweeps_sf.cu, for sm_90a: the same kernels and C
// entry points at SfShape<4, 5> (4 nodes and 5 Gauss points per axis: 64
// dofs and 125 points per element), the entry points named with the suffix
// _p3.  A translation unit of its own, so that ops/build.py compiles it
// beside the p = 2 one.

#define MIMI_SF_P1 4
#define MIMI_SF_NG 5
#define MIMI_SF_ENTRY(name) name##_p3

#include "sweeps_sf.cu"
