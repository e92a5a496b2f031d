// Dynamic shared memory of the sweep kernels, for sm_90a: a block's tile
// past the 48 KB that a static __shared__ allocation may hold (the p = 3
// sf tile, 67.7 KB and 92.2 KB viscous; the dense (3, 3) columns, 96 KB),
// two helpers of the tiled dense matvec (an L1 prefetch hint, an opaque
// value) and the asynchronous copies of dense_ring_kernel.  The host stand-in (host_stub/cuda_runtime.h) defines
// MIMI_DYNAMIC_SHARED first, as the launch's buffer shared by the block's
// threads, and MIMI_HOST_STUB with stand-ins of the two helpers.

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#ifndef MIMI_DYNAMIC_SHARED
// `T* name`: the launch's dynamic shared memory, 16-byte aligned
#define MIMI_DYNAMIC_SHARED(T, name)                                  \
  extern __shared__ __align__(16) unsigned char name##_bytes[];       \
  T* name = reinterpret_cast<T*>(name##_bytes)
#endif

namespace {

#ifndef MIMI_HOST_STUB
// A hint that brings the line holding `p` into L1 ahead of its load: no
// register is written and nothing waits.  The host stand-in
// (host_stub/cuda_runtime.h) does nothing.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}
// x, as a value the compiler cannot see through: what is computed from it
// inside a loop is computed there (the tiled matvec's row addresses, one
// multiply-add each, instead of a register pair per row kept across its
// loop over the points)
__device__ __forceinline__ long long opaque(long long x) {
  asm volatile("" : "+l"(x));
  return x;
}
// An asynchronous copy of one float from device to shared memory
// (cp.async, cached in L1), the close of the thread's group of copies
// issued since the last, and the wait until at most N of its groups are in
// flight.  The host stand-in copies at once.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
#endif

constexpr size_t STATIC_SMEM = 48 * 1024;
// the dynamic shared memory one block may have on sm_90
constexpr size_t BLOCK_SMEM_MAX = 227 * 1024;

// Allow the kernel K `bytes` of dynamic shared memory on the current
// device before its first launch there (a launch asking more than 48 KB
// is refused otherwise); once per kernel and device.
template <auto K>
int allow_dynamic_smem(size_t bytes) {
  if (bytes <= STATIC_SMEM) return 0;
  static unsigned long long done = 0;  // one bit per device
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev < 64 && (done >> dev & 1ull)) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return (int)err;
}

}  // namespace
