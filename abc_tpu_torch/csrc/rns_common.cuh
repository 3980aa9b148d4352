// Loads, stores and the modular steps of the RNS kernels (behz.cu,
// keyswitch.cu, rlwe.cu, elementwise.cu): residues are uint32 below 2^30,
// read and written four coefficients at a time with one 16-byte access.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

__device__ __forceinline__ uint32_t ld(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint64_t ld64(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Where a thread of a kernel with a thread a quad (keyswitch.cu, rlwe.cu)
// works: `line` counts the output rows before it (every axis but the last,
// flattened), c is its first coefficient.
struct At {
  long long line;
  size_t c;
};

__device__ __forceinline__ At at_of(long long t, int logn) {
  const int qlog = logn - 2;
  return {t >> qlog, static_cast<size_t>(t & ((1LL << qlog) - 1)) * 4};
}

// x mod q for any 64-bit x, ratio = floor(2^64 / q): the quotient estimate
// floor(x * ratio / 2^64) is floor(x / q) or one less, so the remainder is
// below 2q (< 2^31) and one subtraction makes it canonical.
__device__ __forceinline__ uint32_t reduce64(uint64_t x, uint32_t q,
                                             uint64_t ratio) {
  const uint64_t quot = __umul64hi(x, ratio);
  const uint32_t r =
      static_cast<uint32_t>(x) - static_cast<uint32_t>(quot) * q;
  return r >= q ? r - q : r;
}

// a * w mod q, canonical, for a fixed w < q with companion wsh.
__device__ __forceinline__ uint32_t mul_const(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  const uint32_t r = shoup_lazy(a, w, wsh, q);
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

// -a mod q, 0 kept 0
__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t q) {
  return a == 0 ? 0 : q - a;
}

// a * b mod q for residues, ratio = floor(2^64 / q)
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t q, uint64_t ratio) {
  return reduce64(static_cast<uint64_t>(a) * b, q, ratio);
}

// ------------------------------------------ indices without 64-bit division

// x / d for 0 <= x < 2^31 and 1 <= d < 2^31 by one 32 x 32 -> 64-bit product
// and a shift (Granlund and Montgomery): with l = ceil(log2 d) and m =
// ceil(2^(31 + l) / d), m d - 2^(31 + l) < d <= 2^l, so floor(x m / 2^(31 +
// l)) = floor(x / d), and m < 2^32. The host makes it (div_by); a kernel
// whose indices stay below 2^31 then splits them with no division routine.
struct Div {
  uint32_t d, m, s;
};

inline Div div_by(uint32_t d) {
  int l = 0;
  while (l < 31 && (uint32_t(1) << l) < d) ++l;
  const uint64_t top = uint64_t(1) << (31 + l);
  return {d, static_cast<uint32_t>((top + d - 1) / d),
          static_cast<uint32_t>(31 + l)};
}

__device__ __forceinline__ uint32_t quot(uint32_t x, const Div& v) {
  return static_cast<uint32_t>((static_cast<uint64_t>(x) * v.m) >> v.s);
}

// The SMs of the current device, asked until a query succeeds, with the
// query's error.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> known{0};
  int n = known.load();
  if (n < 1) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    known.store(n);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace
