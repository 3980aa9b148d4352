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
// leading axis (batch, ciphertext component, a mesh's shard axis).
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
// floor(2^64 / modulus) for reduce64.
//
// Arithmetic. Products with a constant are Shoup products (ntt_common.cuh:
// shoup_lazy, then one conditional subtraction). A conversion sums
// y_i * T[i][d] in 64 bits: each product is below 2^60, so 16 of them fit;
// the sum is reduced after every 16 terms, which covers any K. reduce64
// reduces any 64-bit value with one high product. The residue mod m~ = 2^16
// wraps in 32 bits exactly as the reference's u32 product does (only its
// low 16 bits are kept). Every word written is canonical in [0, modulus):
// the same words as the plain torch versions (exact int64 `%`) and the
// reference.
//
// behz_to_bsk and behz_from_bsk work on tiles: kTile = 128 consecutive
// coefficients of the flattened [rows * n] axis with every destination (a
// tile spans whole rows where n < 128; a quad of 4 coefficients always lies
// in one row, since n >= 4), a lane of a warp on each quad. Two ways:
// * A block a tile (convert_tile), the rule:
//   stage 1 (stage_sources): the block's threads load the tile's source
//     limbs with 16-byte loads, a warp on one source row (512 contiguous
//     bytes), apply the per-source Shoup product (y_i = x_i * m~ qhat_i^-1,
//     or x_b * bhat_i^-1) and store y in shared memory, ys[source][quad];
//   stage 2, after one barrier: a destination warp owns ND destinations; a
//     thread sums its K products from the shared tile (one 16-byte shared
//     load serves 4 x ND products; T[i][d] is one address across the warp),
//     applies the epilogue and writes one 16-byte store per destination
//     row. One more warp, the scalar warp, computes the per-coefficient
//     scalar once: to_bsk's r (the wrapping u32 sum mod m~, times -q^-1) or
//     from_bsk's alpha (the conversion into m_sk, minus x_msk, times B^-1),
//     and leaves it in shared memory for the epilogues, after a second
//     barrier.
//   Sources come in chunks of KC (16 where K <= 16, else 32): the partial
//   sums stay in registers across chunks, so any K works in at most 16 KB of
//   shared memory. ND = 1, 2 or 4 destinations a thread, at most 15
//   destination warps (512 threads with the scalar warp); a D larger than 60
//   takes more passes over the sources. The chain behind each output word
//   is K products, where a thread of the first design (one coefficient,
//   every destination in turn) ran D x K; at one ciphertext of the main path
//   128 / 192 blocks (that design: 64 / 96 on 132 SMs).
// * A warp a tile (convert_warp_tile), where K <= 16 and there are 2048
//   tiles or more (at n=8192: to_bsk's 2 rows a ciphertext from a batch of
//   16, from_bsk's 3 from 11; from_bsk reads the same either way at 11 and
//   12, PERF.md): a lane loads its quad of all K sources at once, keeps the
//   y's in registers, computes the scalar itself and then the destinations
//   in turn. No barrier: in a block
//   each tile's load, products and stores come one after the other, and at
//   36-45 warps an SM (40-43 registers) too little else covers the loads'
//   wait; a warp alone keeps K independent 16-byte loads in flight and
//   starts on its tile when they land. With few tiles its D-long chain is
//   the longer wait, so the block-a-tile way keeps them.
// The epilogue takes (q mod b_d) * r_b, or (B mod q_j) * (q_j - a), as one
// more term of the sum: one reduce64 a word.
//
// What bounds them on this card. At the main path's shapes (n=8192, L=6,
// Bsk of 8 primes) a conversion reads K and writes D words per coefficient,
// 56-88 bytes against 48-56 products: bytes bound them, so there is no use
// for tensor cores. At n=32768's L = 27 (27 x 29 products a coefficient)
// the integer multiply-adds bound them, and the product loop takes most of
// the time (PERF.md); an int8 tensor-core split of the products is a
// question for later.
//
// behz_fast_floor (a thread per coefficient, its K residues in registers,
// y[KMAX] with KMAX in {8, 16, 32, 64} picked from K, the D destinations in
// turn; past 64 sources it recomputes y chunk by chunk for each destination,
// carrying the 64-bit sum) and behz_tensor (a thread per coefficient and
// limb) keep their first design. Stage 1 of from_bsk is where fast_floor
// can be folded in (x_b computed from e_q and e_bsk instead of loaded).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;     // fast_floor, tensor: a thread per word
constexpr int kHeader = 8;
constexpr int kSrcWords = 4;
constexpr int kDstWords = 8;
constexpr uint32_t kMTilde = 1u << 16;
constexpr uint32_t kMask = kMTilde - 1;
// to_bsk / from_bsk: coefficients of a tile, quads of 4 (a warp's lanes),
// destination warps at most, threads at most (with the scalar warp)
constexpr int kTile = 128;
constexpr int kQuads = kTile / 4;
constexpr int kMaxGroups = 15;
constexpr int kTileThreads = 32 * (kMaxGroups + 1);
// A warp takes a tile alone where it can keep the K sources in registers
// and there are tiles enough to fill the card many times over: threads a
// block of such warps
constexpr int kWarpSources = 16;
constexpr long long kWarpTiles = 2048;
constexpr int kWarpTileThreads = 128;

__device__ __forceinline__ uint32_t ld(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

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

// ------------------------------------------------ to_bsk / from_bsk tiles

enum Conv { kToBsk, kFromBsk };

// Where a thread's quad (4 coefficients) of a tile lies.
struct Quad {
  bool live;            // inside the rows * n coefficients
  size_t row, c;        // its row and first coefficient
};

__device__ __forceinline__ Quad quad_of(long long tile, long long cols,
                                        int logn, int q) {
  const long long col = tile * kTile + 4 * q;
  Quad at;
  at.live = col < cols;
  at.row = static_cast<size_t>(col >> logn);
  at.c = static_cast<size_t>(col) & ((size_t(1) << logn) - 1);
  return at;
}

// Stage 1: y_i = x_i * w_i mod m_i (source record i: m_i, w_i, its
// companion) of the tile's sources [k0, k0 + kc) into ys[i - k0][quad];
// `in` has `stride` limbs a row; quads past the data get 0. A later kernel
// can compute its sources here instead of loading them (fast_floor's x_b
// from e_q and e_bsk, folded into from_bsk).
template <int KC>
__device__ __forceinline__ void stage_sources(
    uint4 (&ys)[KC][kQuads], const uint32_t* __restrict__ in, int stride,
    const uint32_t* src, int k0, int kc, long long cols, int logn) {
  for (int idx = threadIdx.x; idx < kc * kQuads; idx += blockDim.x) {
    const int i = idx / kQuads, q = idx % kQuads;
    const Quad at = quad_of(blockIdx.x, cols, logn, q);
    uint4 y = make_uint4(0, 0, 0, 0);
    if (at.live) {
      const uint4 x =
          ld4(in + ((at.row * stride + k0 + i) << logn) + at.c);
      const uint32_t* rec = src + kSrcWords * (k0 + i);
      const uint32_t m = ld(rec), w = ld(rec + 1), wsh = ld(rec + 2);
      y = make_uint4(mul_const(x.x, w, wsh, m), mul_const(x.y, w, wsh, m),
                     mul_const(x.z, w, wsh, m), mul_const(x.w, w, wsh, m));
    }
    ys[i][q] = y;
  }
}

// Stage 2: acc[j][e] += sum over the chunk [k0, k0 + kc) of
// y_i[e] * T[i * tstride + d[j]], reduced mod m[j] after every 16 sources
// while more of the K follow.
template <int ND, int KC>
__device__ __forceinline__ void accumulate(
    uint64_t (&acc)[ND][4], const uint4 (&ys)[KC][kQuads], int q,
    const uint32_t* T, int tstride, const int (&d)[ND],
    const uint32_t (&m)[ND], const uint64_t (&ratio)[ND], int k0, int kc,
    int K) {
  for (int i0 = 0; i0 < kc; i0 += 16) {
    const int i1 = min(kc, i0 + 16);
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const uint4 y = ys[i][q];
      const uint32_t* row = T + (k0 + i) * tstride;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const uint32_t t = ld(row + d[j]);
        acc[j][0] += static_cast<uint64_t>(y.x) * t;
        acc[j][1] += static_cast<uint64_t>(y.y) * t;
        acc[j][2] += static_cast<uint64_t>(y.z) * t;
        acc[j][3] += static_cast<uint64_t>(y.w) * t;
      }
    }
    if (k0 + i1 < K) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = reduce64(acc[j][e], m[j],
                                                         ratio[j]);
      }
    }
  }
}

// The sum of K products plus one more term below 2^60, reduced mod m: the
// last group of products leaves room for one more unless it holds 16.
__device__ __forceinline__ uint32_t finish(uint64_t acc, uint64_t term,
                                           int K, uint32_t m,
                                           uint64_t ratio) {
  if (K % 16 == 0) acc = reduce64(acc, m, ratio);
  return reduce64(acc + term, m, ratio);
}

// The scalar of 4 coefficients from its sums: to_bsk's r = (sum mod m~) *
// (-q^-1) mod m~ (the wrapping u32 sum in the low 32 bits of acc);
// from_bsk's alpha = (sum mod m_sk - x_msk) * B^-1 mod m_sk.
template <int KIND>
__device__ __forceinline__ uint4 scalar_of(const uint64_t (&acc)[4],
                                           const uint4& x_msk,
                                           const uint32_t* tab) {
  uint32_t v[4];
  if (KIND == kToBsk) {
    const uint32_t nq = ld(tab);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = ((static_cast<uint32_t>(acc[e]) & kMask) * nq) & kMask;
    }
  } else {
    const uint32_t msk = ld(tab), binv = ld(tab + 3), binv_sh = ld(tab + 4);
    const uint64_t ratio = ratio_of(tab);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t conv = reduce64(acc[e], msk, ratio);
      v[e] = mul_const(sub_mod(conv, lane_of(x_msk, e), msk), binv, binv_sh,
                       msk);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One destination's words of 4 coefficients from its sums of K products
// (acc), the scalar (s4) and its record `rec` (modulus b, ratio).
template <int KIND>
__device__ __forceinline__ uint4 epilogue(const uint64_t (&acc)[4],
                                          const uint4& s4,
                                          const uint32_t* rec, uint32_t b,
                                          uint64_t ratio, int K,
                                          const uint32_t* tab) {
  const uint32_t w3 = ld(rec + 3);
  uint32_t o[4];
  if (KIND == kToBsk) {
    const uint32_t mi = ld(rec + 4), mish = ld(rec + 5);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t r = lane_of(s4, e);
      const uint32_t r_b = r >= (kMTilde >> 1) ? r + b - kMTilde : r;
      const uint32_t v =
          finish(acc[e], static_cast<uint64_t>(w3) * r_b, K, b, ratio);
      o[e] = mul_const(v, mi, mish, b);
    }
  } else {
    const uint32_t half = ld(tab + 5), msk_q = ld(rec + 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // centred alpha mod q_j: alpha < m_sk < 2 q_j, then minus m_sk if
      // alpha > m_sk / 2 (the plain version's steps, word for word)
      const uint32_t alpha = lane_of(s4, e);
      uint32_t a = alpha >= b ? alpha - b : alpha;
      if (alpha > half) a = sub_mod(a, msk_q, b);
      o[e] = finish(acc[e], static_cast<uint64_t>(w3) * (b - a), K, b, ratio);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One tile of behz_to_bsk (KIND kToBsk): exact base extension q -> Bsk of
// rows of K = L limbs into D = L + 2. Header: word 0 = -q^-1 mod m~. Source
// record: (q_i, m~ * qhat_i^-1 mod q_i, its Shoup companion, qhat_i mod
// m~). Destination record: (b_d, ratio, q mod b_d, m~^-1 mod b_d, its
// companion). T = qhat_i mod b_d. The scalar: r = (sum_i y_i * (qhat_i mod
// m~)) * (-q^-1) mod m~, centred per destination; out = (sum_i y_i T[i][d]
// + (q mod b_d) * r_b) * m~^-1 mod b_d.
//
// Or of behz_from_bsk (kFromBsk): Shenoy-Kumaresan Bsk -> q of rows of
// K + 1 limbs (the K = L + 1 B primes, then m_sk) into D = L. Header:
// (m_sk, its ratio, B^-1 mod m_sk, its companion, m_sk >> 1). Source
// record: (b_i, bhat_i^-1 mod b_i, its companion, bhat_i mod m_sk).
// Destination record: (q_j, ratio, B mod q_j, m_sk mod q_j). T = bhat_i mod
// q_j. The scalar: alpha = (sum_i y_i * (bhat_i mod m_sk) - x_msk) * B^-1
// mod m_sk; out = sum_i y_i T[i][j] - (B mod q_j) * a mod q_j, a the
// centred alpha mod q_j, computed as the sum plus (B mod q_j) * (q_j - a).
template <int KIND, int ND, int KC>
__device__ __forceinline__ void convert_tile(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tab, long long cols, int K, int D,
    int logn) {
  __shared__ uint4 ys[KC][kQuads];
  __shared__ uint4 scal[kQuads];      // x_msk, then r or alpha
  const int stride = KIND == kToBsk ? K : K + 1;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;
  const int groups = blockDim.x / 32 - 1;
  const int g = threadIdx.x / 32, q = threadIdx.x % 32;
  const bool scalar = g == groups;
  const Quad at = quad_of(blockIdx.x, cols, logn, q);
  for (int d0 = 0; d0 < D; d0 += groups * ND) {
    // a destination warp's destinations; the scalar warp's sum is acc[0]:
    // into m_sk (from_bsk), or the wrapping sum mod m~ in its low 32 bits
    // (to_bsk)
    int d[ND];
    uint32_t m[ND];
    uint64_t ratio[ND], acc[ND][4] = {};
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      d[j] = min(d0 + g * ND + j, D - 1);   // past D: computed, not kept
      const uint32_t* rec = scalar ? tab : dst + kDstWords * d[j];
      m[j] = ld(rec);
      ratio[j] = ratio_of(rec);
    }
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      if (k0 > 0 || d0 > 0) __syncthreads();   // the chunk before is read
      stage_sources<KC>(ys, in, stride, src, k0, kc, cols, logn);
      if (KIND == kFromBsk && scalar && k0 == 0 && d0 == 0) {
        scal[q] = at.live ? ld4(in + ((at.row * stride + K) << logn) + at.c)
                          : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
      if (!scalar) {
        accumulate<ND, KC>(acc, ys, q, T, D, d, m, ratio, k0, kc, K);
      } else if (d0 == 0 && KIND == kToBsk) {
#pragma unroll 4
        for (int i = 0; i < kc; ++i) {
          const uint4 y = ys[i][q];
          const uint32_t w = ld(src + kSrcWords * (k0 + i) + 3);
          acc[0][0] += (y.x & kMask) * w;
          acc[0][1] += (y.y & kMask) * w;
          acc[0][2] += (y.z & kMask) * w;
          acc[0][3] += (y.w & kMask) * w;
        }
      } else if (d0 == 0) {
        const int col[1] = {0};
        accumulate<1, KC>(reinterpret_cast<uint64_t (&)[1][4]>(acc), ys, q,
                          src + 3, kSrcWords, col,
                          reinterpret_cast<const uint32_t (&)[1]>(m),
                          reinterpret_cast<const uint64_t (&)[1]>(ratio), k0,
                          kc, K);
      }
    }
    if (scalar && d0 == 0) {
      scal[q] = scalar_of<KIND>(acc[0], scal[q], tab);
    }
    __syncthreads();                  // the scalar is in shared memory
    if (scalar || !at.live) continue;
    const uint4 s4 = scal[q];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (d0 + g * ND + j >= D) break;
      st4(out + ((at.row * D + d[j]) << logn) + at.c,
          epilogue<KIND>(acc[j], s4, dst + kDstWords * d[j], m[j], ratio[j],
                         K, tab));
    }
  }
}

template <int ND, int KC>
__global__ void __launch_bounds__(kTileThreads)
behz_to_bsk_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tab, long long cols, int K,
                   int D, int logn) {
  convert_tile<kToBsk, ND, KC>(in, out, tab, cols, K, D, logn);
}

template <int ND, int KC>
__global__ void __launch_bounds__(kTileThreads)
behz_from_bsk_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ tab, long long cols, int K,
                     int D, int logn) {
  convert_tile<kFromBsk, ND, KC>(in, out, tab, cols, K, D, logn);
}

// One tile of behz_to_bsk or behz_from_bsk (as convert_tile) for K <= KW
// sources, a warp's work alone: a lane loads its quad of every source
// with independent 16-byte loads, keeps the K y's in registers, computes
// the scalar itself and then each destination in turn. No barrier and no
// shared memory, so nothing holds a warp back but its own loads.
template <int KIND, int KW>
__device__ __forceinline__ void convert_warp_tile(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tab, long long cols, int K, int D,
    int logn) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
      threadIdx.x / 32;
  const Quad at = quad_of(tile, cols, logn, threadIdx.x % 32);
  if (!at.live) return;
  const int stride = KIND == kToBsk ? K : K + 1;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;
  const size_t n = size_t(1) << logn;
  const uint32_t* x = in + ((at.row * stride) << logn) + at.c;
  uint4 y[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (i < K) y[i] = ld4(x + i * n);
  }
  const uint4 x_msk =
      KIND == kFromBsk ? ld4(x + K * n) : make_uint4(0, 0, 0, 0);
  uint64_t acc[4] = {0, 0, 0, 0};     // the scalar's sum
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (i < K) {
      const uint32_t* rec = src + kSrcWords * i;
      const uint32_t m = ld(rec), w = ld(rec + 1), wsh = ld(rec + 2),
                     w3 = ld(rec + 3);
      y[i] = make_uint4(mul_const(y[i].x, w, wsh, m),
                        mul_const(y[i].y, w, wsh, m),
                        mul_const(y[i].z, w, wsh, m),
                        mul_const(y[i].w, w, wsh, m));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t ye = lane_of(y[i], e);
        acc[e] += KIND == kToBsk ? (ye & kMask) * w3
                                 : static_cast<uint64_t>(ye) * w3;
      }
    }
  }
  const uint4 s4 = scalar_of<KIND>(acc, x_msk, tab);
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    const uint32_t* rec = dst + kDstWords * d;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      if (i < K) {
        const uint32_t t = ld(T + i * D + d);
        acc[0] += static_cast<uint64_t>(y[i].x) * t;
        acc[1] += static_cast<uint64_t>(y[i].y) * t;
        acc[2] += static_cast<uint64_t>(y[i].z) * t;
        acc[3] += static_cast<uint64_t>(y[i].w) * t;
      }
    }
    st4(out + ((at.row * D + d) << logn) + at.c,
        epilogue<KIND>(acc, s4, rec, ld(rec), ratio_of(rec), K, tab));
  }
}

template <int KW>
__global__ void __launch_bounds__(kWarpTileThreads)
behz_to_bsk_warp_kernel(const uint32_t* __restrict__ in,
                        uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tab, long long cols,
                        int K, int D, int logn) {
  convert_warp_tile<kToBsk, KW>(in, out, tab, cols, K, D, logn);
}

template <int KW>
__global__ void __launch_bounds__(kWarpTileThreads)
behz_from_bsk_warp_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ tab, long long cols,
                          int K, int D, int logn) {
  convert_warp_tile<kFromBsk, KW>(in, out, tab, cols, K, D, logn);
}

// ------------------------------------------ fast_floor: a thread per word

// acc + sum over the sources [k0, k0 + KMAX) ∩ [0, K) of y[i - k0] *
// T[i*D + d], reduced mod q after every 16 sources while more follow.
template <int KMAX>
__device__ __forceinline__ uint64_t sum_into(uint64_t acc,
                                             const uint32_t (&y)[KMAX], int k0,
                                             int K, const uint32_t* T, int D,
                                             int d, uint32_t q,
                                             uint64_t ratio) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (k0 + i < K) acc += static_cast<uint64_t>(y[i]) *
                           ld(T + (k0 + i) * D + d);
    // below q < 2^30 after a reduction: 16 more products still fit
    if ((i & 15) == 15 && k0 + i + 1 < K) acc = reduce64(acc, q, ratio);
  }
  return acc;
}

// y_i = t * qhat_i^-1 * e_i mod q_i of the sources [k0, k0 + KMAX) ∩ [0, K)
template <int KMAX>
__device__ __forceinline__ void load_sources(uint32_t (&y)[KMAX],
                                             const uint32_t* xq, size_t n,
                                             const uint32_t* src, int k0,
                                             int K) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (k0 + i < K) {
      const uint32_t* rec = src + kSrcWords * (k0 + i);
      y[i] = mul_const(xq[(k0 + i) * n], ld(rec + 1), ld(rec + 2), ld(rec));
    }
  }
}

// floor(t * e / q) in Bsk from e over q (rows of K = L limbs) and over Bsk
// (rows of D = L + 2). No header. Source record: (q_i, t * qhat_i^-1 mod
// q_i, its companion). Destination record: (b_d, ratio, t mod b_d, its
// companion, q^-1 mod b_d, its companion). T = qhat_i mod b_d. CHUNKED
// (K > KMAX = 64): y is recomputed chunk by chunk for each destination.
template <int KMAX, bool CHUNKED>
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
  if (!CHUNKED) load_sources<KMAX>(y, xq, n, src, 0, K);
  for (int d = 0; d < D; ++d) {
    const uint32_t* rec = dst + kDstWords * d;
    const uint32_t b = ld(rec);
    const uint64_t ratio = ratio_of(rec);
    uint64_t acc = 0;
    for (int k0 = 0; k0 < (CHUNKED ? K : 1); k0 += KMAX) {
      if (CHUNKED) load_sources<KMAX>(y, xq, n, src, k0, K);
      acc = sum_into<KMAX>(acc, y, k0, K, T, D, d, b, ratio);
    }
    const uint32_t conv = reduce64(acc, b, ratio);
    const uint32_t tb = mul_const(xb[d * n], ld(rec + 3), ld(rec + 4), b);
    o[d * n] = mul_const(sub_mod(tb, conv, b), ld(rec + 5), ld(rec + 6), b);
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

// ------------------------------------------------------------- launching

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long blocks, int threads, void* stream,
                   Args... args) {
  if (blocks <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A launch's shape: the kernel's template arguments (ND and KC of a tile
// kernel, 0 and KW of a warp-tile kernel; KMAX and CHUNKED of fast_floor),
// threads a block, blocks.
struct Shape {
  int a, b, threads;
  long long blocks;
};

// to_bsk / from_bsk. At K <= kWarpSources over kWarpTiles tiles or more,
// a warp a tile (ND 0, KW = 8 or 16 sources in registers), 4 a block. Else
// a block a tile: the fewest destinations a thread (ND = 1, 2 or 4) that
// keep the destination warps at most kMaxGroups, a pass over as many
// destinations as those warps hold, chunks of KC = 16 sources where K <=
// 16, else 32.
Shape tile_shape(int K, int D, long long cols) {
  const long long tiles = (cols + kTile - 1) / kTile;
  if (K <= kWarpSources && tiles >= kWarpTiles) {
    const int warps = kWarpTileThreads / 32;
    return {0, K <= 8 ? 8 : 16, kWarpTileThreads,
            (tiles + warps - 1) / warps};
  }
  const int nd = D <= kMaxGroups ? 1 : D <= 2 * kMaxGroups ? 2 : 4;
  const int groups_needed = (D + nd - 1) / nd;
  const int groups = groups_needed < kMaxGroups ? groups_needed : kMaxGroups;
  return {nd, K <= 16 ? 16 : 32, 32 * (groups + 1), tiles};
}

// fast_floor: KMAX = 8, 16, 32 or 64 sources in registers, the smallest
// that holds K; past 64 the chunked kernel.
Shape word_shape(int K, long long cols) {
  const int kmax = K <= 8 ? 8 : K <= 16 ? 16 : K <= 32 ? 32 : 64;
  return {kmax, K > 64 ? 1 : 0, kThreads, (cols + kThreads - 1) / kThreads};
}

template <int ND, int KC>
struct ToBsk {
  static constexpr auto kernel = behz_to_bsk_kernel<ND, KC>;
};
template <int KW>
struct ToBsk<0, KW> {
  static constexpr auto kernel = behz_to_bsk_warp_kernel<KW>;
};
template <int ND, int KC>
struct FromBsk {
  static constexpr auto kernel = behz_from_bsk_kernel<ND, KC>;
};
template <int KW>
struct FromBsk<0, KW> {
  static constexpr auto kernel = behz_from_bsk_warp_kernel<KW>;
};

// Pick<ND, KC>::kernel for a tile_shape, passed to `go`.
template <template <int, int> class Pick, typename Go>
cudaError_t by_tile(const Shape& s, Go go) {
  const bool small = s.b == 16;
  switch (s.a) {
    case 0: return s.b == 8 ? go(Pick<0, 8>::kernel) : go(Pick<0, 16>::kernel);
    case 1: return small ? go(Pick<1, 16>::kernel) : go(Pick<1, 32>::kernel);
    case 2: return small ? go(Pick<2, 16>::kernel) : go(Pick<2, 32>::kernel);
    default: return small ? go(Pick<4, 16>::kernel) : go(Pick<4, 32>::kernel);
  }
}

template <typename Go>
cudaError_t by_word(const Shape& s, Go go) {
  if (s.b) return go(behz_fast_floor_kernel<64, true>);
  switch (s.a) {
    case 8: return go(behz_fast_floor_kernel<8, false>);
    case 16: return go(behz_fast_floor_kernel<16, false>);
    case 32: return go(behz_fast_floor_kernel<32, false>);
    default: return go(behz_fast_floor_kernel<64, false>);
  }
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       threads, 0);
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t; n = 2^logn;
// `rows` counts the leading rows (every axis before the limb axis). Each
// returns the cudaError_t of its launch (0 on success); K or D below 1
// returns cudaErrorInvalidValue. to_bsk and from_bsk take n >= 4 and
// 16-byte aligned rows.
int abc_behz_to_bsk(const void* in, void* out, const void* tab,
                    long long rows, int K, int D, int logn, void* stream) {
  if (K < 1 || D < 1 || logn < 2) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  const Shape s = tile_shape(K, D, cols);
  return by_tile<ToBsk>(s, [&](auto kernel) {
    return launch(kernel, s.blocks, s.threads, stream,
                  static_cast<const uint32_t*>(in),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(tab), cols, K, D, logn);
  });
}

int abc_behz_fast_floor(const void* e_q, const void* e_bsk, void* out,
                        const void* tab, long long rows, int K, int D,
                        int logn, void* stream) {
  if (K < 1 || D < 1) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  const Shape s = word_shape(K, cols);
  return by_word(s, [&](auto kernel) {
    return launch(kernel, s.blocks, s.threads, stream,
                  static_cast<const uint32_t*>(e_q),
                  static_cast<const uint32_t*>(e_bsk),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(tab), cols, K, D, logn);
  });
}

int abc_behz_from_bsk(const void* in, void* out, const void* tab,
                      long long rows, int K, int D, int logn, void* stream) {
  if (K < 1 || D < 1 || logn < 2) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  const Shape s = tile_shape(K, D, cols);
  return by_tile<FromBsk>(s, [&](auto kernel) {
    return launch(kernel, s.blocks, s.threads, stream,
                  static_cast<const uint32_t*>(in),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(tab), cols, K, D, logn);
  });
}

// rows = max(rows1, rows2); an operand of 1 row is broadcast.
int abc_behz_tensor(const void* f1, const void* f2, void* out, const void* q,
                    const void* ratio, long long rows1, long long rows2,
                    int D, int logn, void* stream) {
  const long long rows = rows1 > rows2 ? rows1 : rows2;
  const long long cols = (rows * D) << logn;
  return static_cast<int>(launch(
      behz_tensor_kernel, (cols + kThreads - 1) / kThreads, kThreads, stream,
      static_cast<const uint32_t*>(f1), static_cast<const uint32_t*>(f2),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(q),
      static_cast<const uint64_t*>(ratio), cols, rows1, rows2, D, logn));
}

// The launch that abc_behz_<kernel> makes for K sources, D destinations
// and `rows` rows of n = 2^logn (kernel: 0 to_bsk, 1 fast_floor, 2
// from_bsk, 3 tensor), into info[6]: its two template arguments (ND, KC of
// to_bsk / from_bsk, or 0, KW where a warp takes a tile; KMAX, CHUNKED of
// fast_floor; 0, 0 for tensor), threads
// a block, blocks, and the kernel's theoretical occupancy,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: blocks and warps an SM.
// Returns the cudaError_t of the query.
int abc_behz_launch_info(int kernel, int K, int D, long long rows, int logn,
                         long long* info) {
  if (K < 1 || D < 1) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  Shape s{0, 0, kThreads, (cols * D + kThreads - 1) / kThreads};
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  auto query = [&](auto k) { return occupancy(k, s.threads, &per_sm); };
  switch (kernel) {
    case 0:
      s = tile_shape(K, D, cols);
      err = by_tile<ToBsk>(s, query);
      break;
    case 1:
      s = word_shape(K, cols);
      err = by_word(s, query);
      break;
    case 2:
      s = tile_shape(K, D, cols);
      err = by_tile<FromBsk>(s, query);
      break;
    case 3:
      err = occupancy(behz_tensor_kernel, s.threads, &per_sm);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  info[0] = s.a;
  info[1] = s.b;
  info[2] = s.threads;
  info[3] = s.blocks;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (s.threads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
