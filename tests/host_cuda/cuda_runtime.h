// Host stand-in for the CUDA runtime: a launch runs its blocks one after
// another on one std::thread per thread of a block; __syncthreads is a
// std::barrier of the block (__syncthreads_or also ORs the predicates),
// threadIdx is thread_local and __shared__ storage is static (one block
// runs at a time).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx;
static dim3 blockIdx, blockDim, gridDim;
static std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// the barrier with the OR of every thread's predicate
inline int __syncthreads_or(int predicate) {
  static std::atomic<int> any{0};
  if (predicate) any.fetch_or(1);
  __syncthreads();
  const int got = any.load();
  __syncthreads();
  if (threadIdx.x == 0) any.store(0);
  __syncthreads();
  return got;
}
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  void* attrs;
  unsigned numAttrs;
};
template <typename T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return static_cast<unsigned long long>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
}
// A warp shuffle as an exchange across the block: every thread of the
// block must call it, as the kernels' shuffles are, and each reads the
// value of thread threadIdx.x ^ lane_mask (lane_mask < 32: the same warp).
template <typename T>
inline T __shfl_xor_sync(unsigned, T value, int lane_mask) {
  static T slots[1024];
  slots[threadIdx.x] = value;
  __syncthreads();
  const T got = slots[threadIdx.x ^ lane_mask];
  __syncthreads();
  return got;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// the device an H100 SXM is: 132 SMs, unless the build names another
// count (-DHOST_CUDA_SMS=1: a card whose launch plans take a thread more
// than one unit of work at a few blocks' size)
#ifndef HOST_CUDA_SMS
#define HOST_CUDA_SMS 132
#endif
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = HOST_CUDA_SMS;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K,
                                                          int threads,
                                                          size_t) {
  *blocks = 2048 / threads;
  return cudaSuccess;
}
template <typename... E, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  // one std::thread per thread of a block, reused block after block: the
  // host sets blockIdx between two steps of `step`
  const unsigned threads = cfg->blockDim.x, blocks = cfg->gridDim.x;
  blockDim = cfg->blockDim;
  gridDim = cfg->gridDim;
  std::barrier<> bar(threads), step(threads + 1);
  block_barrier = &bar;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < blocks; ++b) {
        step.arrive_and_wait();
        kernel(args...);
        step.arrive_and_wait();
      }
    });
  }
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx = dim3(b);
    step.arrive_and_wait();
    step.arrive_and_wait();
  }
  for (auto& th : pool) th.join();
  return cudaSuccess;
}
