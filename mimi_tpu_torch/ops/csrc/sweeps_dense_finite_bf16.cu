// The bfloat16 instantiations of sweeps_dense_finite.cu, for sm_90a: the
// assemble of J2Simo and J2Log writing the full block in bfloat16 from the
// float32 tables, and the full matvec (every material's full block)
// reading it with the bfloat16 copies of dN and N, at the shape of
// the build, viscous or not; the C entry points named with the
// suffix _bf16.  Built with -fmad=false, as its float32 twin
// (ops/build.py NO_FMAD).

#define MIMI_DENSE_BF16

#include "sweeps_dense_finite.cu"
