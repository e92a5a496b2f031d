// The bfloat16 instantiations of sweeps_dense.cu, for sm_90a: the assemble
// writing the symmetric (or full) block of the hyperelastic materials in
// bfloat16 from the float32 tables, and the symmetric matvec reading that
// block with the bfloat16 copies of dN and N, at the shape of
// the build, viscous or not; the C entry points named with the
// suffix _bf16.  A translation unit of its own, so that ops/build.py
// compiles it beside the float32 one.

#define MIMI_DENSE_BF16

#include "sweeps_dense.cu"
