// BEHZ full-RNS BFV multiplication kernels for Hopper (sm_90a): K3 of the
// port, the four elementwise chains of abc_tpu_torch/crypto/behz.py.
//
// On the TPU these chains were never Pallas kernels: the reference runs
// abc_tpu/crypto/behz.py under jax.jit, and XLA fused each chain of the jx32
// engine (abc_tpu/ops/modarith.py) into TPU kernels of its own. Replaces:
//   behz_to_bsk      <- BehzContext._to_bsk     (abc_tpu/crypto/behz.py:133,
//                       with _fastconv :117), exact base extension q -> Bsk
//   behz_tensor      <- the tensor product in BehzContext.multiply (:241),
//                       in base q and in base Bsk; also CkksContext.multiply's
//   behz_fast_floor  <- BehzContext._fast_floor (:161), floor(t*e/q) in Bsk
//   behz_from_bsk    <- BehzContext._from_bsk   (:172), Shenoy-Kumaresan
//                       Bsk -> q with the m_sk correction
//
// Data: row-major [rows, limbs, n] uint32 residues (the port stores them as
// int32; every modulus is below 2^30), n = 2^logn; `rows` flattens every
// leading axis (batch, ciphertext component, a mesh's shard axis). One
// thread owns one coefficient of one row: it reads its K source residues
// into registers (y[KMAX], KMAX in {8, 16, 32, 64} chosen by the host from
// K, so no array is sized for one parameter set) and loops over the D
// destination moduli, writing D words. Neighbouring threads own neighbouring
// coefficients, so every load and store of a warp is one contiguous run.
//
// Tables. Each conversion reads one packed uint32 table that the context
// builds once from host bigints (abc_tpu_torch/ops/behz_kernels.py:
// to_bsk_words, fast_floor_words, from_bsk_words) and passes by device
// pointer, so that two contexts' graphs can replay in turns: nothing is kept
// in __constant__ memory.
//   [0, 8)                 header (per kernel, below)
//   [8, 8 + 4K)            one record of 4 words per source modulus
//   [8 + 4K, 8 + 4K + 8D)  one record of 8 words per destination modulus
//   [.., + K*D)            the conversion table T[i*D + d]
// A destination record starts (modulus, ratio lo, ratio hi): ratio =
// floor(2^64 / modulus) for reduce64. Every lane of a warp reads the same
// table word, so each table load is one broadcast from L1.
//
// Arithmetic. Products with a constant are Shoup products (ntt_common.cuh:
// shoup_lazy, then one conditional subtraction). The conversion sums
// y_i * T[i][d] in 64 bits: each product is below 2^60, so 16 of them fit;
// the sum is reduced after every 16 terms, which covers any K (from_bsk sums
// L + 1 terms: 28 at n=32768's 27 data primes). reduce64 reduces any 64-bit
// value with one high product. The residue mod m~ = 2^16 wraps in 32 bits
// exactly as the reference's u32 product does (only its low 16 bits are
// kept). Every word written is canonical in [0, modulus): the same words as
// the plain torch versions (exact int64 `%`) and the reference.
//
// What bounds them on this card. At the main path's shapes (n=8192, L=6,
// Bsk of 8 primes) each conversion reads K and writes D words per
// coefficient: 56-88 bytes against 144-185 integer multiply-adds a
// coefficient (K*D wide products, a reduce64 per destination, the Shoup
// products; chip_smoke.py:behz_imads counts them), so bytes bound them. The
// products grow as K*D: at n=32768's L = 27 they bound to_bsk and from_bsk.
// The design answers with one pass over the data per chain, where the plain
// version makes 15-35 passes of int64 tensors. The tensor product reads 4
// and writes 3 words per coefficient: bytes again. Not done yet: fusing
// fast_floor into from_bsk, wider per-thread loads, TMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHeader = 8;
constexpr int kSrcWords = 4;
constexpr int kDstWords = 8;
constexpr uint32_t kMTilde = 1u << 16;
constexpr uint32_t kMask = kMTilde - 1;

__device__ __forceinline__ uint32_t ld(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint64_t ratio_of(const uint32_t* rec) {
  return static_cast<uint64_t>(ld(rec + 1)) |
         (static_cast<uint64_t>(ld(rec + 2)) << 32);
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

// sum_i y[i] * T[i*D + d] mod q over the K <= KMAX sources.
template <int KMAX>
__device__ __forceinline__ uint32_t convert(const uint32_t (&y)[KMAX], int K,
                                            const uint32_t* T, int D, int d,
                                            uint32_t q, uint64_t ratio) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) acc += static_cast<uint64_t>(y[i]) * ld(T + i * D + d);
    // below q < 2^30 after a reduction: 16 more products still fit
    if ((i & 15) == 15 && i + 1 < K) acc = reduce64(acc, q, ratio);
  }
  return reduce64(acc, q, ratio);
}

// Exact base extension q -> Bsk of rows of K = L limbs into D = L + 2.
// Header: word 0 = -q^-1 mod m~. Source record: (q_i, m~ * qhat_i^-1 mod
// q_i, its Shoup companion, qhat_i mod m~). Destination record: (b_d, ratio,
// q mod b_d, m~^-1 mod b_d, its companion). T = qhat_i mod b_d.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
behz_to_bsk_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tab, long long cols, int K,
                   int D, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= cols) return;
  const size_t n = size_t(1) << logn;
  const size_t row = static_cast<size_t>(t >> logn);
  const size_t c = static_cast<size_t>(t) & (n - 1);
  const uint32_t* x = in + row * K * n + c;
  uint32_t* o = out + row * D * n + c;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;

  uint32_t y[KMAX];
  uint32_t sum_mt = 0;        // sum_i y_i * (qhat_i mod m~), mod 2^32
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      const uint32_t* rec = src + kSrcWords * i;
      y[i] = mul_const(x[i * n], ld(rec + 1), ld(rec + 2), ld(rec));
      sum_mt += (y[i] & kMask) * ld(rec + 3);
    }
  }
  const uint32_t r = ((sum_mt & kMask) * ld(tab)) & kMask;
  for (int d = 0; d < D; ++d) {
    const uint32_t* rec = dst + kDstWords * d;
    const uint32_t b = ld(rec);
    const uint64_t ratio = ratio_of(rec);
    const uint32_t r_b = r >= (kMTilde >> 1) ? r + b - kMTilde : r;  // centred
    const uint32_t conv = convert<KMAX>(y, K, T, D, d, b, ratio);
    const uint32_t v =
        reduce64(conv + static_cast<uint64_t>(ld(rec + 3)) * r_b, b, ratio);
    o[d * n] = mul_const(v, ld(rec + 4), ld(rec + 5), b);
  }
}

// floor(t * e / q) in Bsk from e over q (rows of K = L limbs) and over Bsk
// (rows of D = L + 2). No header. Source record: (q_i, t * qhat_i^-1 mod
// q_i, its companion). Destination record: (b_d, ratio, t mod b_d, its
// companion, q^-1 mod b_d, its companion). T = qhat_i mod b_d.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
behz_fast_floor_kernel(const uint32_t* __restrict__ e_q,
                       const uint32_t* __restrict__ e_bsk,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ tab, long long cols, int K,
                       int D, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= cols) return;
  const size_t n = size_t(1) << logn;
  const size_t row = static_cast<size_t>(t >> logn);
  const size_t c = static_cast<size_t>(t) & (n - 1);
  const uint32_t* xq = e_q + row * K * n + c;
  const uint32_t* xb = e_bsk + row * D * n + c;
  uint32_t* o = out + row * D * n + c;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;

  uint32_t y[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      const uint32_t* rec = src + kSrcWords * i;
      y[i] = mul_const(xq[i * n], ld(rec + 1), ld(rec + 2), ld(rec));
    }
  }
  for (int d = 0; d < D; ++d) {
    const uint32_t* rec = dst + kDstWords * d;
    const uint32_t b = ld(rec);
    const uint32_t conv = convert<KMAX>(y, K, T, D, d, b, ratio_of(rec));
    const uint32_t tb = mul_const(xb[d * n], ld(rec + 3), ld(rec + 4), b);
    o[d * n] = mul_const(sub_mod(tb, conv, b), ld(rec + 5), ld(rec + 6), b);
  }
}

// Shenoy-Kumaresan Bsk -> q of rows of K + 1 limbs (the K = L + 1 B primes,
// then m_sk) into D = L. Header: (m_sk, its ratio, B^-1 mod m_sk, its
// companion, m_sk >> 1). Source record: (b_i, bhat_i^-1 mod b_i, its
// companion, bhat_i mod m_sk). Destination record: (q_j, ratio, B mod q_j,
// m_sk mod q_j). T = bhat_i mod q_j.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
behz_from_bsk_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ tab, long long cols, int K,
                     int D, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= cols) return;
  const size_t n = size_t(1) << logn;
  const size_t row = static_cast<size_t>(t >> logn);
  const size_t c = static_cast<size_t>(t) & (n - 1);
  const uint32_t* x = in + row * (K + 1) * n + c;
  uint32_t* o = out + row * D * n + c;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;
  const uint32_t msk = ld(tab);
  const uint64_t msk_ratio = ratio_of(tab);

  uint32_t y[KMAX];
  uint64_t acc = 0;           // sum_i y_i * (bhat_i mod m_sk)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      const uint32_t* rec = src + kSrcWords * i;
      y[i] = mul_const(x[i * n], ld(rec + 1), ld(rec + 2), ld(rec));
      acc += static_cast<uint64_t>(y[i]) * ld(rec + 3);
    }
    if ((i & 15) == 15 && i + 1 < K) acc = reduce64(acc, msk, msk_ratio);
  }
  const uint32_t conv_msk = reduce64(acc, msk, msk_ratio);
  const uint32_t alpha = mul_const(sub_mod(conv_msk, x[K * n], msk),
                                   ld(tab + 3), ld(tab + 4), msk);
  const bool neg = alpha > ld(tab + 5);
  for (int j = 0; j < D; ++j) {
    const uint32_t* rec = dst + kDstWords * j;
    const uint32_t q = ld(rec);
    const uint64_t ratio = ratio_of(rec);
    const uint32_t conv = convert<KMAX>(y, K, T, D, j, q, ratio);
    // centred alpha mod q_j: alpha < m_sk < 2 q_j, then minus m_sk if
    // alpha > m_sk / 2 (the plain version's steps, word for word)
    uint32_t a = alpha >= q ? alpha - q : alpha;
    if (neg) a = sub_mod(a, ld(rec + 4), q);
    const uint32_t corr = reduce64(static_cast<uint64_t>(ld(rec + 3)) * a, q,
                                   ratio);
    o[j * n] = sub_mod(conv, corr, q);
  }
}

// (a0, a1) x (b0, b1) -> (a0 b0, a0 b1 + a1 b0, a1 b1) mod q_d, pointwise
// (the NTT domain), over rows of [2, D, n] into rows of [3, D, n]. An
// operand of one row is broadcast over the other's rows.
__global__ void __launch_bounds__(kThreads)
behz_tensor_kernel(const uint32_t* __restrict__ f1,
                   const uint32_t* __restrict__ f2, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ qs,
                   const uint64_t* __restrict__ ratios, long long cols,
                   long long rows1, long long rows2, int D, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= cols) return;
  const size_t n = size_t(1) << logn;
  const size_t c = static_cast<size_t>(t) & (n - 1);
  const size_t limb_row = static_cast<size_t>(t >> logn);
  const int d = static_cast<int>(limb_row % D);
  const size_t row = limb_row / D;
  const size_t plane = static_cast<size_t>(D) << logn;
  const size_t at = (static_cast<size_t>(d) << logn) + c;
  const uint32_t* a = f1 + (rows1 == 1 ? 0 : row) * 2 * plane + at;
  const uint32_t* b = f2 + (rows2 == 1 ? 0 : row) * 2 * plane + at;
  uint32_t* o = out + row * 3 * plane + at;
  const uint32_t q = ld(qs + d);
  const uint64_t ratio = __ldg(reinterpret_cast<const unsigned long long*>(
      ratios + d));
  const uint64_t a0 = a[0], a1 = a[plane], b0 = b[0], b1 = b[plane];
  o[0] = reduce64(a0 * b0, q, ratio);
  o[plane] = reduce64(a0 * b1 + a1 * b0, q, ratio);     // < 2^61
  o[2 * plane] = reduce64(a1 * b1, q, ratio);
}

template <typename Kernel, typename... Args>
cudaError_t launch_1d(Kernel kernel, long long threads, void* stream,
                      Args... args) {
  if (threads <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((threads + kThreads - 1) /
                                           kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The conversions instantiated for KMAX = 8, 16, 32, 64 sources in
// registers: the smallest that holds K. Larger K is refused.
template <template <int> class Pick, typename... Args>
int by_sources(int K, long long threads, void* stream, Args... args) {
  if (K < 1) return cudaErrorInvalidValue;
  if (K <= 8) return launch_1d(Pick<8>::kernel, threads, stream, args...);
  if (K <= 16) return launch_1d(Pick<16>::kernel, threads, stream, args...);
  if (K <= 32) return launch_1d(Pick<32>::kernel, threads, stream, args...);
  if (K <= 64) return launch_1d(Pick<64>::kernel, threads, stream, args...);
  return cudaErrorInvalidValue;
}

template <int KMAX>
struct ToBsk {
  static constexpr auto kernel = behz_to_bsk_kernel<KMAX>;
};
template <int KMAX>
struct FastFloor {
  static constexpr auto kernel = behz_fast_floor_kernel<KMAX>;
};
template <int KMAX>
struct FromBsk {
  static constexpr auto kernel = behz_from_bsk_kernel<KMAX>;
};

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t; n = 2^logn;
// `rows` counts the leading rows (every axis before the limb axis). Each
// returns the cudaError_t of its launch (0 on success); K outside [1, 64]
// returns cudaErrorInvalidValue.
int abc_behz_to_bsk(const void* in, void* out, const void* tab,
                    long long rows, int K, int D, int logn, void* stream) {
  const long long cols = rows << logn;
  return by_sources<ToBsk>(K, cols, stream, static_cast<const uint32_t*>(in),
                           static_cast<uint32_t*>(out),
                           static_cast<const uint32_t*>(tab), cols, K, D,
                           logn);
}

int abc_behz_fast_floor(const void* e_q, const void* e_bsk, void* out,
                        const void* tab, long long rows, int K, int D,
                        int logn, void* stream) {
  const long long cols = rows << logn;
  return by_sources<FastFloor>(
      K, cols, stream, static_cast<const uint32_t*>(e_q),
      static_cast<const uint32_t*>(e_bsk), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tab), cols, K, D, logn);
}

int abc_behz_from_bsk(const void* in, void* out, const void* tab,
                      long long rows, int K, int D, int logn, void* stream) {
  const long long cols = rows << logn;
  return by_sources<FromBsk>(K, cols, stream,
                             static_cast<const uint32_t*>(in),
                             static_cast<uint32_t*>(out),
                             static_cast<const uint32_t*>(tab), cols, K, D,
                             logn);
}

// rows = max(rows1, rows2); an operand of 1 row is broadcast.
int abc_behz_tensor(const void* f1, const void* f2, void* out, const void* q,
                    const void* ratio, long long rows1, long long rows2,
                    int D, int logn, void* stream) {
  const long long rows = rows1 > rows2 ? rows1 : rows2;
  const long long cols = (rows * D) << logn;
  return static_cast<int>(launch_1d(
      behz_tensor_kernel, cols, stream, static_cast<const uint32_t*>(f1),
      static_cast<const uint32_t*>(f2), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(ratio),
      cols, rows1, rows2, D, logn));
}

}  // extern "C"
