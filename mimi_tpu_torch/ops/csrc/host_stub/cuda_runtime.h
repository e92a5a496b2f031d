// Host stand-ins for the CUDA runtime names that the kernel sources of
// ops/csrc use, so that a C++ compiler builds them for the CPU
// (tests/test_torch_csrc_host.py).  Not used by the nvcc build.
//
// The qualifiers compile away; __shared__ arrays become locals of each
// kernel call (each thread of the dense kernels owns one column of them, so
// one call per thread computes what the block does); blockIdx and
// threadIdx are globals that a serial loop over blocks and threads sets
// before each call (the test rewrites `kernel<<<grid, block, ...>>>(args)`
// into that loop).  The single-rounding intrinsics are plain IEEE float
// operations, exact as long as the compiler contracts no FMA
// (-ffp-contract=off).

#pragma once

#include <float.h>
#include <math.h>
#include <string.h>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct mimi_host_index {
  unsigned x, y, z;
};
inline mimi_host_index blockIdx{0, 0, 0};
inline mimi_host_index threadIdx{0, 0, 0};

typedef struct mimi_host_stream* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }

inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

// torch's pow(x, -0.5) on the card (rsqrt); here 1 / sqrt
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
