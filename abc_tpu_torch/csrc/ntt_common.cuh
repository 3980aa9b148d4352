// Helpers shared by the NTT kernels (ntt.cu) and the NTT ablation kernels
// (ntt_ablation.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a*w mod q up to one q: for any 32-bit a, w < q and wsh = floor(w*2^32/q),
// a*w - floor(a*wsh/2^32)*q lies in [0, 2q); uint32 wraparound is exact.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// Dynamic shared memory above 48 KB must be opted into per kernel; without
// it a launch at n >= 16384 is refused.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int threads_for(int n) { return (n >> 1) < 1024 ? (n >> 1) : 1024; }

}  // namespace
