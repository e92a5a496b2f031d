// The finite-strain material bodies of ops/csrc/finite.cuh at given points,
// one thread a point, for scripts/probe_finite_strain.py: J2Log's float pass
// (P, the return map) and its DIM^2 dual passes (the 81 planes), to find
// where a plane turns NaN.  Built by the script with nvcc, with and without
// fused multiply-adds.
#include <cuda_runtime.h>
#include "finite.cuh"

template <class Mat>
__global__ void probe_kernel(Mat mat, const float* F, float* P, float* C, float* rm, int n) {
  const int k = blockIdx.x * 128 + threadIdx.x;
  if (k >= n) return;
  float Fk[3][3], Pk[3][3];
  for (int i = 0; i < 9; ++i) Fk[i / 3][i % 3] = F[i * n + k];
  typename Mat::Point pt;
  mat.template eval<true>(Fk, k, n, Pk, pt);
  for (int i = 0; i < 9; ++i) P[i * n + k] = Pk[i / 3][i % 3];
  rm[0 * n + k] = pt.rm.active;
  rm[1 * n + k] = pt.rm.log_bad;
  rm[2 * n + k] = pt.rm.dstar;
  rm[3 * n + k] = pt.rm.fprime;
  for (int b = 0; b < 9; ++b) {
    float col[9];
    mat.column(pt, k, n, b, col);
    for (int a = 0; a < 9; ++a) C[(a * 9 + b) * n + k] = col[a];
  }
}

extern "C" int probe_j2log(const J2Params* p, const float* fp_inv, const float* eqps,
                           const float* temp, const float* F, float* P, float* C, float* rm,
                           int n, int deep) {
  J2LogMat<3> m;
  m.p = *p;
  m.fp_inv = fp_inv;
  m.eqps = eqps;
  m.temp = temp;
  m.deep = deep;
  probe_kernel<<<(n + 127) / 128, 128, 0, 0>>>(m, F, P, C, rm, n);
  return (int)cudaGetLastError();
}
