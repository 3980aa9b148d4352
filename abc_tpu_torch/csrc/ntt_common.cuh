// The lazy Shoup product, shared by every kernel of ntt.cu, ntt_ablation.cu
// and, through rns_common.cuh, behz.cu and keyswitch.cu (ntt_passes.cuh holds
// the forward transform's skeleton).
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

}  // namespace
