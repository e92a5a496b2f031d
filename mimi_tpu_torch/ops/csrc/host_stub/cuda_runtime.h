// Host stand-ins for the CUDA runtime names that the kernel sources of
// ops/csrc use, so that a C++20 compiler builds them for the CPU
// (tests/test_torch_csrc_host.py).  Not used by the nvcc build.
//
// The qualifiers compile away.  A launch runs as on the card, one block
// at a time: mimi_host_launch starts one host thread per thread of the
// block, and each runs the kernel for every block in turn, with a barrier
// between blocks (the test rewrites `kernel<<<grid, block, ...>>>(args)`
// into that call).  threadIdx and blockIdx are thread_local; a __shared__
// variable is a static local of the kernel, so the block's threads share
// it and the next block finds it as the last one left it; the launch's
// dynamic shared memory (MIMI_DYNAMIC_SHARED, launch.cuh) is one buffer of
// the launch's `shared` bytes, allocated once and shared in the same way;
// __syncthreads() is a barrier of the block's threads.  The limits of an
// sm_90 launch hold as on the card: a block of more than 1024 threads, or
// of more dynamic shared memory than the 227 KB a block may have, does not
// run and leaves its error for cudaGetLastError, and
// cudaFuncSetAttribute refuses more than 227 KB.  The single-rounding intrinsics are
// plain IEEE float operations, exact as long as the compiler contracts no
// FMA (-ffp-contract=off).

#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <atomic>
#include <barrier>
#include <cstddef>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct mimi_host_index {
  unsigned x, y, z;
};
inline thread_local mimi_host_index blockIdx{0, 0, 0};
inline thread_local mimi_host_index threadIdx{0, 0, 0};

// the barrier of the block that runs now (one launch at a time)
inline std::barrier<>* mimi_host_block_barrier = nullptr;
inline void __syncthreads() { mimi_host_block_barrier->arrive_and_wait(); }

// the cache prefetch hint, the opaque value and the asynchronous copies of
// launch.cuh: nothing to do on the host but the copy
#define MIMI_HOST_STUB
inline void prefetch_l1(const void*) {}
inline long long opaque(long long x) { return x; }
// launch.cuh's asynchronous copy to shared memory: the host copies at once
inline void cp_async4(float* smem, const float* gmem) { *smem = *gmem; }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

// the dynamic shared memory of the launch that runs now
inline unsigned char* mimi_host_dynamic_shared = nullptr;
#define MIMI_DYNAMIC_SHARED(T, name) T* name = reinterpret_cast<T*>(mimi_host_dynamic_shared)

typedef struct mimi_host_stream* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
// the error of the last launch, until cudaGetLastError reads it
inline cudaError_t mimi_host_last_error = cudaSuccess;
constexpr size_t MIMI_HOST_BLOCK_THREADS = 1024, MIMI_HOST_BLOCK_SMEM = 227 * 1024;

// run `kernel()` as a grid of `grid` blocks of `block` threads with
// `shared` bytes of dynamic shared memory
template <class K>
inline void mimi_host_launch(unsigned grid, unsigned block, size_t shared, const K& kernel) {
  if (block == 0 || block > MIMI_HOST_BLOCK_THREADS || shared > MIMI_HOST_BLOCK_SMEM) {
    mimi_host_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  std::vector<std::max_align_t> smem((shared + sizeof(std::max_align_t) - 1) /
                                     sizeof(std::max_align_t));
  mimi_host_dynamic_shared = reinterpret_cast<unsigned char*>(smem.data());
  std::barrier<> sync(block);
  mimi_host_block_barrier = &sync;
  std::vector<std::thread> threads;
  threads.reserve(block);
  for (unsigned t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      threadIdx = {t, 0, 0};
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx = {b, 0, 0};
        kernel();
        sync.arrive_and_wait();  // the block's shared memory passes to the next block
      }
    });
  for (std::thread& th : threads) th.join();
  mimi_host_block_barrier = nullptr;
  mimi_host_dynamic_shared = nullptr;
}

inline cudaError_t cudaGetLastError() {
  const cudaError_t err = mimi_host_last_error;
  mimi_host_last_error = cudaSuccess;
  return err;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
  return bytes < 0 || (size_t)bytes > MIMI_HOST_BLOCK_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// a __device__ variable is a host variable: its address, a copy from it,
// a fill of it (on no stream: at once), atomic updates from the block's
// threads
template <class T>
inline cudaError_t cudaGetSymbolAddress(void** ptr, T& symbol) {
  *ptr = (void*)&symbol;
  return cudaSuccess;
}
enum cudaMemcpyKind { cudaMemcpyDeviceToHost = 2 };
inline cudaError_t cudaMemcpy(void* dst, const void* src, size_t bytes, cudaMemcpyKind) {
  memcpy(dst, src, bytes);
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* ptr, int value, size_t bytes, cudaStream_t) {
  memset(ptr, value, bytes);
  return cudaSuccess;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
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
