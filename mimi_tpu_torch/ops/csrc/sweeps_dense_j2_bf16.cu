// The bfloat16 instantiations of sweeps_dense_j2.cu, for sm_90a: the
// assemble of J2 (each hardening law) and J2Linear writing the Cauchy (or
// full) block in bfloat16 from the float32 tables, and the Cauchy matvec
// reading that block with the bfloat16 copies of dN and N, at the
// shape of the build, viscous or not; the C entry points named
// with the suffix _bf16.  A translation unit of its own, so that
// ops/build.py compiles it beside the float32 one.

#define MIMI_DENSE_BF16

#include "sweeps_dense_j2.cu"
