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
// The three conversions are kinds (Conv) of one tile code: K source limbs
// in, y_i = a per-source Shoup product, a sum of K products y_i * T[i][d]
// per destination, an epilogue. A tile is kTile = 128 consecutive
// coefficients of the flattened [rows * n] axis with every destination (it
// spans whole rows where n < 128; a quad of 4 coefficients always lies in
// one row, since n >= 4), a lane of a warp on each quad. Two ways:
// * A block a tile (convert_tile), the rule:
//   stage 1 (stage_sources): the block loads the tile's source limbs with
//     16-byte loads, a warp on one source row (512 contiguous bytes),
//     applies the Shoup product and stores y in shared memory;
//   stage 2, after one barrier: a destination warp owns ND destinations; a
//     thread sums its K products from the shared tile (one 16-byte shared
//     load serves 4 x ND products; T[i][d] is one address across the warp),
//     applies the epilogue and writes one 16-byte store a destination row.
//     to_bsk and from_bsk have one more warp, the scalar warp: it computes
//     the per-coefficient scalar (to_bsk's r, from_bsk's alpha) once and
//     leaves it in shared memory, after a second barrier. fast_floor has no
//     scalar: each destination warp loads its own e_bsk quads before stage
//     1, so that their wait hides behind the sources'.
//   Sources come in chunks of KC (16 where K <= 16, else 32), the partial
//   sums in registers across chunks, so any K works in at most 16 KB of
//   shared memory. ND = 1, 2 or 4 destinations a thread, at most 15
//   destination warps; a D larger than 60 takes more passes. The chain
//   behind each word is K products (a thread of the first design, one
//   coefficient and every destination in turn, ran D x K).
// * A warp a tile (convert_warp_tile), where K <= 16 and there are 2048
//   tiles or more, fast_floor 3072 (at n=8192: to_bsk's 2 rows a
//   ciphertext from a batch of 16, from_bsk's 3 from 11, fast_floor's 3
//   from 16; PERF.md has each kind's readings both ways): a lane loads its
//   quad of all K sources at once, keeps the y's in registers, computes the
//   scalar itself and then the destinations in turn (fast_floor loads each
//   destination's e_bsk one destination ahead). No barrier: a warp keeps K
//   independent 16-byte loads in flight and starts on its tile when they
//   land, where a block's stages take turns. With few tiles its D-long
//   chain is the longer wait, so the block-a-tile way keeps them.
// The epilogue takes (q mod b_d) * r_b, (B mod q_j) * (q_j - a), or (t mod
// b_d) * e_bsk as one more term of the sum: one reduce64 a word.
//
// What bounds them on this card. At the main path's shapes (n=8192, L=6,
// Bsk of 8 primes) a conversion moves 56-88 bytes a coefficient against
// 48-56 products: bytes bound them, so there is no use for tensor cores. At
// n=32768's L = 27 (27 x 29 products a coefficient) the integer
// multiply-adds do, and the product loop takes most of the time (PERF.md).
//
// behz_tensor takes both bases of a BFV multiply (q and Bsk) in one launch,
// a thread a quad of one limb (four 16-byte loads, three stores): bytes
// bound it (28 a coefficient against 7 products), and one launch instead of
// two saves a launch's fixed cost at one ciphertext.

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kHeader = 8;
constexpr int kSrcWords = 4;
constexpr int kDstWords = 8;
constexpr uint32_t kMTilde = 1u << 16;
constexpr uint32_t kMask = kMTilde - 1;
// the conversions: coefficients of a tile, quads of 4 (a warp's lanes),
// destination warps at most, threads at most (with a scalar warp)
constexpr int kTile = 128;
constexpr int kQuads = kTile / 4;
constexpr int kMaxGroups = 15;
constexpr int kTileThreads = 32 * (kMaxGroups + 1);
// A warp takes a tile alone where it can keep the K sources in registers
// and there are tiles enough to fill the card many times over (fast_floor's
// warp loads one more row a destination, and needs more: PERF.md); threads
// a block of such warps
constexpr int kWarpSources = 16;
constexpr long long kWarpTiles = 2048;
constexpr long long kFastFloorWarpTiles = 3072;
constexpr int kWarpTileThreads = 128;
// tensor: threads a block, a quad each
constexpr int kTensorThreads = 128;

__device__ __forceinline__ uint64_t ratio_of(const uint32_t* rec) {
  return static_cast<uint64_t>(ld(rec + 1)) |
         (static_cast<uint64_t>(ld(rec + 2)) << 32);
}

// ------------------------------------------------------- conversion tiles

enum Conv { kToBsk, kFromBsk, kFastFloor };

// Whether a kind has a per-coefficient scalar (and a scalar warp).
__host__ __device__ constexpr bool has_scalar(int kind) {
  return kind != kFastFloor;
}

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
// (acc), s4 (the scalar; fast_floor: the destination's e_bsk quad) and its
// record `rec` (modulus b, ratio).
template <int KIND>
__device__ __forceinline__ uint4 epilogue(const uint64_t (&acc)[4],
                                          const uint4& s4,
                                          const uint32_t* rec, uint32_t b,
                                          uint64_t ratio, int K,
                                          const uint32_t* tab) {
  const uint32_t w3 = ld(rec + 3);
  uint32_t o[4];
  if (KIND == kFromBsk) {
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
  } else {
    // to_bsk: (sum + (q mod b) * r_b) * m~^-1; fast_floor: (sum + (t mod b)
    // * e_bsk) * q^-1, its sum already the negated conversion
    const uint32_t mi = ld(rec + 4), mish = ld(rec + 5);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t f = lane_of(s4, e);
      if (KIND == kToBsk && f >= (kMTilde >> 1)) f = f + b - kMTilde;
      const uint32_t v =
          finish(acc[e], static_cast<uint64_t>(w3) * f, K, b, ratio);
      o[e] = mul_const(v, mi, mish, b);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One tile of a conversion from rows of K source limbs (`in`) into rows of
// D destination limbs (`out`):
//
// behz_to_bsk (KIND kToBsk): exact base extension q -> Bsk, K = L, D = L +
// 2. Header: word 0 = -q^-1 mod m~. Source record: (q_i, m~ * qhat_i^-1 mod
// q_i, its Shoup companion, qhat_i mod m~). Destination record: (b_d,
// ratio, q mod b_d, m~^-1 mod b_d, its companion). T = qhat_i mod b_d. The
// scalar: r = (sum_i y_i * (qhat_i mod m~)) * (-q^-1) mod m~, centred per
// destination; out = (sum_i y_i T[i][d] + (q mod b_d) * r_b) * m~^-1 mod
// b_d.
//
// behz_from_bsk (kFromBsk): Shenoy-Kumaresan Bsk -> q of rows of K + 1
// limbs (the K = L + 1 B primes, then m_sk) into D = L. Header: (m_sk, its
// ratio, B^-1 mod m_sk, its companion, m_sk >> 1). Source record: (b_i,
// bhat_i^-1 mod b_i, its companion, bhat_i mod m_sk). Destination record:
// (q_j, ratio, B mod q_j, m_sk mod q_j). T = bhat_i mod q_j. The scalar:
// alpha = (sum_i y_i * (bhat_i mod m_sk) - x_msk) * B^-1 mod m_sk; out =
// sum_i y_i T[i][j] + (B mod q_j) * (q_j - a) mod q_j, a the centred alpha.
//
// behz_fast_floor (kFastFloor): floor(t * e / q) in Bsk from e over q (`in`,
// rows of K = L limbs) and over Bsk (`in2`, rows of D = L + 2). No header.
// Source record: (q_i, t * qhat_i^-1 mod q_i, its companion). Destination
// record: (b_d, ratio, t mod b_d, q^-1 mod b_d, its companion). T = -qhat_i
// mod b_d. No scalar; out = (sum_i y_i T[i][d] + (t mod b_d) * e_bsk[d]) *
// q^-1 mod b_d.
template <int KIND, int ND, int KC>
__device__ __forceinline__ void convert_tile(
    const uint32_t* __restrict__ in, const uint32_t* __restrict__ in2,
    uint32_t* __restrict__ out, const uint32_t* __restrict__ tab,
    long long cols, int K, int D, int logn) {
  __shared__ uint4 ys[KC][kQuads];
  __shared__ uint4 scal[kQuads];      // x_msk, then r or alpha
  const int stride = KIND == kFromBsk ? K + 1 : K;
  const uint32_t* src = tab + kHeader;
  const uint32_t* dst = src + kSrcWords * K;
  const uint32_t* T = dst + kDstWords * D;
  const int groups = blockDim.x / 32 - (has_scalar(KIND) ? 1 : 0);
  const int g = threadIdx.x / 32, q = threadIdx.x % 32;
  const bool scalar = has_scalar(KIND) && g == groups;
  const Quad at = quad_of(blockIdx.x, cols, logn, q);
  for (int d0 = 0; d0 < D; d0 += groups * ND) {
    // a destination warp's destinations; the scalar warp's sum is acc[0]:
    // into m_sk (from_bsk), or the wrapping sum mod m~ in its low 32 bits
    // (to_bsk)
    int d[ND];
    uint32_t m[ND];
    uint64_t ratio[ND], acc[ND][4] = {};
    uint4 eb[ND];                     // fast_floor: e_bsk of each destination
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      d[j] = min(d0 + g * ND + j, D - 1);   // past D: computed, not kept
      const uint32_t* rec = scalar ? tab : dst + kDstWords * d[j];
      m[j] = ld(rec);
      ratio[j] = ratio_of(rec);
      eb[j] = KIND == kFastFloor && at.live
                  ? ld4(in2 + ((at.row * D + d[j]) << logn) + at.c)
                  : make_uint4(0, 0, 0, 0);
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
    if (has_scalar(KIND)) {
      if (scalar && d0 == 0) scal[q] = scalar_of<KIND>(acc[0], scal[q], tab);
      __syncthreads();                // the scalar is in shared memory
    }
    if (scalar || !at.live) continue;
    const uint4 s4 = has_scalar(KIND) ? scal[q] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (d0 + g * ND + j >= D) break;
      st4(out + ((at.row * D + d[j]) << logn) + at.c,
          epilogue<KIND>(acc[j], KIND == kFastFloor ? eb[j] : s4,
                         dst + kDstWords * d[j], m[j], ratio[j], K, tab));
    }
  }
}

// The kernels of each kind take the same arguments: `in2` is fast_floor's
// e_bsk (nullptr for the others).
#define BEHZ_CONVERT_ARGS                                                 \
  const uint32_t *__restrict__ in, const uint32_t *__restrict__ in2,     \
      uint32_t *__restrict__ out, const uint32_t *__restrict__ tab,      \
      long long cols, int K, int D, int logn

template <int ND, int KC>
__global__ void __launch_bounds__(kTileThreads)
behz_to_bsk_kernel(BEHZ_CONVERT_ARGS) {
  convert_tile<kToBsk, ND, KC>(in, in2, out, tab, cols, K, D, logn);
}

template <int ND, int KC>
__global__ void __launch_bounds__(kTileThreads)
behz_from_bsk_kernel(BEHZ_CONVERT_ARGS) {
  convert_tile<kFromBsk, ND, KC>(in, in2, out, tab, cols, K, D, logn);
}

template <int ND, int KC>
__global__ void __launch_bounds__(kTileThreads)
behz_fast_floor_kernel(BEHZ_CONVERT_ARGS) {
  convert_tile<kFastFloor, ND, KC>(in, in2, out, tab, cols, K, D, logn);
}

// One tile of a conversion (as convert_tile) for K <= KW sources, a warp's
// work alone: a lane loads its quad of every source with independent
// 16-byte loads, keeps the K y's in registers, computes the scalar itself
// and then each destination in turn. No barrier and no shared memory, so
// nothing holds a warp back but its own loads.
template <int KIND, int KW>
__device__ __forceinline__ void convert_warp_tile(
    const uint32_t* __restrict__ in, const uint32_t* __restrict__ in2,
    uint32_t* __restrict__ out, const uint32_t* __restrict__ tab,
    long long cols, int K, int D, int logn) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
      threadIdx.x / 32;
  const Quad at = quad_of(tile, cols, logn, threadIdx.x % 32);
  if (!at.live) return;
  const int stride = KIND == kFromBsk ? K + 1 : K;
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
  // fast_floor: e_bsk of the next destination, loaded one ahead
  const uint32_t* xb =
      KIND == kFastFloor ? in2 + ((at.row * D) << logn) + at.c : nullptr;
  uint4 eb = KIND == kFastFloor ? ld4(xb) : make_uint4(0, 0, 0, 0);
  uint64_t acc[4] = {0, 0, 0, 0};     // the scalar's sum
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (i < K) {
      const uint32_t* rec = src + kSrcWords * i;
      const uint32_t m = ld(rec), w = ld(rec + 1), wsh = ld(rec + 2);
      y[i] = make_uint4(mul_const(y[i].x, w, wsh, m),
                        mul_const(y[i].y, w, wsh, m),
                        mul_const(y[i].z, w, wsh, m),
                        mul_const(y[i].w, w, wsh, m));
      if (has_scalar(KIND)) {
        const uint32_t w3 = ld(rec + 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t ye = lane_of(y[i], e);
          acc[e] += KIND == kToBsk ? (ye & kMask) * w3
                                   : static_cast<uint64_t>(ye) * w3;
        }
      }
    }
  }
  const uint4 s4 = has_scalar(KIND) ? scalar_of<KIND>(acc, x_msk, tab)
                                    : make_uint4(0, 0, 0, 0);
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    const uint32_t* rec = dst + kDstWords * d;
    uint4 s = s4;
    if (KIND == kFastFloor) {
      s = eb;
      if (d + 1 < D) eb = ld4(xb + (d + 1) * n);
    }
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
        epilogue<KIND>(acc, s, rec, ld(rec), ratio_of(rec), K, tab));
  }
}

template <int KW>
__global__ void __launch_bounds__(kWarpTileThreads)
behz_to_bsk_warp_kernel(BEHZ_CONVERT_ARGS) {
  convert_warp_tile<kToBsk, KW>(in, in2, out, tab, cols, K, D, logn);
}

template <int KW>
__global__ void __launch_bounds__(kWarpTileThreads)
behz_from_bsk_warp_kernel(BEHZ_CONVERT_ARGS) {
  convert_warp_tile<kFromBsk, KW>(in, in2, out, tab, cols, K, D, logn);
}

template <int KW>
__global__ void __launch_bounds__(kWarpTileThreads)
behz_fast_floor_warp_kernel(BEHZ_CONVERT_ARGS) {
  convert_warp_tile<kFastFloor, KW>(in, in2, out, tab, cols, K, D, logn);
}

// ------------------------------------------------------------ tensor product

// One base of behz_tensor: operands of rows1 and rows2 rows of [2, D, n]
// (a row count of 1 broadcasts over the other's rows), the product's rows
// of [3, D, n], the base's D moduli and their ratios, and its quads of 4
// coefficients (rows * D * n / 4).
struct TensorBase {
  const uint32_t *f1, *f2;
  uint32_t* out;
  const uint32_t* qs;
  const uint64_t* ratios;
  long long rows1, rows2, quads;
  int D;
};

// (a0, a1) x (b0, b1) -> (a0 b0, a0 b1 + a1 b0, a1 b1) mod q_d, pointwise
// (the NTT domain), over up to two bases in one launch: the first `blocks0`
// blocks take base b0, the rest b1; a thread takes a quad of one limb.
__global__ void __launch_bounds__(kTensorThreads)
behz_tensor_kernel(TensorBase b0, TensorBase b1, long long blocks0,
                   int logn) {
  const bool first = blockIdx.x < blocks0;
  const TensorBase s = first ? b0 : b1;
  const long long t =
      (static_cast<long long>(blockIdx.x) - (first ? 0 : blocks0)) *
          blockDim.x + threadIdx.x;
  if (t >= s.quads) return;
  const size_t col = static_cast<size_t>(t) * 4;
  const size_t c = col & ((size_t(1) << logn) - 1);
  const size_t limb_row = col >> logn;
  const int d = static_cast<int>(limb_row % s.D);
  const size_t row = limb_row / s.D;
  const size_t plane = static_cast<size_t>(s.D) << logn;
  const size_t at = (static_cast<size_t>(d) << logn) + c;
  const uint32_t* a = s.f1 + (s.rows1 == 1 ? 0 : row) * 2 * plane + at;
  const uint32_t* b = s.f2 + (s.rows2 == 1 ? 0 : row) * 2 * plane + at;
  uint32_t* o = s.out + row * 3 * plane + at;
  const uint32_t q = ld(s.qs + d);
  const uint64_t ratio = __ldg(reinterpret_cast<const unsigned long long*>(
      s.ratios + d));
  const uint4 a0 = ld4(a), a1 = ld4(a + plane), c0 = ld4(b),
              c1 = ld4(b + plane);
  uint32_t e0[4], e1[4], e2[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint64_t x0 = lane_of(a0, e), x1 = lane_of(a1, e),
                   y0 = lane_of(c0, e), y1 = lane_of(c1, e);
    e0[e] = reduce64(x0 * y0, q, ratio);
    e1[e] = reduce64(x0 * y1 + x1 * y0, q, ratio);     // < 2^61
    e2[e] = reduce64(x1 * y1, q, ratio);
  }
  st4(o, make_uint4(e0[0], e0[1], e0[2], e0[3]));
  st4(o + plane, make_uint4(e1[0], e1[1], e1[2], e1[3]));
  st4(o + 2 * plane, make_uint4(e2[0], e2[1], e2[2], e2[3]));
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
// kernel, 0 and KW of a warp-tile kernel, 0 and 0 of tensor), threads a
// block, blocks.
struct Shape {
  int a, b, threads;
  long long blocks;
};

// A conversion of kind KIND. At K <= kWarpSources over kWarpTiles tiles
// (fast_floor: kFastFloorWarpTiles) or more, a warp a tile (ND 0, KW = 8 or 16 sources in registers), 4 a
// block. Else a block a tile: the fewest destinations a thread (ND = 1, 2
// or 4) that keep the destination warps at most kMaxGroups, a pass over as
// many destinations as those warps hold, chunks of KC = 16 sources where K
// <= 16, else 32, and the scalar warp of a kind that has one.
Shape tile_shape(int kind, int K, int D, long long cols) {
  const long long tiles = (cols + kTile - 1) / kTile;
  if (K <= kWarpSources &&
      tiles >= (kind == kFastFloor ? kFastFloorWarpTiles : kWarpTiles)) {
    const int warps = kWarpTileThreads / 32;
    return {0, K <= 8 ? 8 : 16, kWarpTileThreads,
            (tiles + warps - 1) / warps};
  }
  const int nd = D <= kMaxGroups ? 1 : D <= 2 * kMaxGroups ? 2 : 4;
  const int groups_needed = (D + nd - 1) / nd;
  const int groups = groups_needed < kMaxGroups ? groups_needed : kMaxGroups;
  return {nd, K <= 16 ? 16 : 32, 32 * (groups + (has_scalar(kind) ? 1 : 0)),
          tiles};
}

// The tensor product: a block per kTensorThreads quads of a base.
long long tensor_blocks(long long quads) {
  return (quads + kTensorThreads - 1) / kTensorThreads;
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
template <int ND, int KC>
struct FastFloor {
  static constexpr auto kernel = behz_fast_floor_kernel<ND, KC>;
};
template <int KW>
struct FastFloor<0, KW> {
  static constexpr auto kernel = behz_fast_floor_warp_kernel<KW>;
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

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       threads, 0);
}

// One conversion launch of kind KIND (Pick its kernels).
template <int KIND, template <int, int> class Pick>
int convert(const void* in, const void* in2, void* out, const void* tab,
            long long rows, int K, int D, int logn, void* stream) {
  if (K < 1 || D < 1 || logn < 2) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  const Shape s = tile_shape(KIND, K, D, cols);
  return by_tile<Pick>(s, [&](auto kernel) {
    return launch(kernel, s.blocks, s.threads, stream,
                  static_cast<const uint32_t*>(in),
                  static_cast<const uint32_t*>(in2),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(tab), cols, K, D, logn);
  });
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t; n = 2^logn;
// `rows` counts the leading rows (every axis before the limb axis). Each
// returns the cudaError_t of its launch (0 on success); K or D below 1, or
// n below 4, returns cudaErrorInvalidValue. Every operand takes 16-byte
// aligned rows.
int abc_behz_to_bsk(const void* in, void* out, const void* tab,
                    long long rows, int K, int D, int logn, void* stream) {
  return convert<kToBsk, ToBsk>(in, nullptr, out, tab, rows, K, D, logn,
                                stream);
}

// e_q: rows of K limbs, e_bsk and out: rows of D.
int abc_behz_fast_floor(const void* e_q, const void* e_bsk, void* out,
                        const void* tab, long long rows, int K, int D,
                        int logn, void* stream) {
  return convert<kFastFloor, FastFloor>(e_q, e_bsk, out, tab, rows, K, D,
                                        logn, stream);
}

int abc_behz_from_bsk(const void* in, void* out, const void* tab,
                      long long rows, int K, int D, int logn, void* stream) {
  return convert<kFromBsk, FromBsk>(in, nullptr, out, tab, rows, K, D, logn,
                                    stream);
}

// The tensor product over one or two bases in one launch: per base its
// operands f1, f2 ([rows1 or rows2, 2, D, n]; an operand of 1 row is
// broadcast), its product out ([max(rows1, rows2), 3, D, n]), its moduli q
// ([D] uint32) and ratios ([D] uint64). D2 = 0: the first base alone.
int abc_behz_tensor_bases(const void* f1, const void* f2, void* out,
                          const void* q, const void* ratio, long long rows1,
                          long long rows2, int D, const void* f1b,
                          const void* f2b, void* outb, const void* qb,
                          const void* ratiob, long long rows1b,
                          long long rows2b, int D2, int logn, void* stream) {
  if (D < 1 || D2 < 0 || logn < 2) return cudaErrorInvalidValue;
  const auto base = [&](const void* a, const void* b, void* o, const void* m,
                        const void* r, long long r1, long long r2, int d) {
    const long long rows = r1 > r2 ? r1 : r2;
    return TensorBase{static_cast<const uint32_t*>(a),
                      static_cast<const uint32_t*>(b),
                      static_cast<uint32_t*>(o),
                      static_cast<const uint32_t*>(m),
                      static_cast<const uint64_t*>(r), r1, r2,
                      ((rows * d) << logn) / 4, d};
  };
  const TensorBase b0 = base(f1, f2, out, q, ratio, rows1, rows2, D);
  const TensorBase b1 =
      base(f1b, f2b, outb, qb, ratiob, rows1b, rows2b, D2);
  const long long blocks0 = tensor_blocks(b0.quads);
  return static_cast<int>(launch(behz_tensor_kernel,
                                 blocks0 + tensor_blocks(b1.quads),
                                 kTensorThreads, stream, b0, b1, blocks0,
                                 logn));
}

// The launch that abc_behz_<kernel> makes for K sources, D destinations
// and `rows` rows of n = 2^logn (kernel: 0 to_bsk, 1 fast_floor, 2
// from_bsk, 3 tensor over two bases of K and D limbs), into
// info[6]: its two template arguments (ND, KC of a block a tile, or 0, KW
// where a warp takes a tile; 0, 0 for tensor), threads a block, blocks,
// and the kernel's theoretical occupancy,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: blocks and warps an SM.
// Returns the cudaError_t of the query.
int abc_behz_launch_info(int kernel, int K, int D, long long rows, int logn,
                         long long* info) {
  if (K < 1 || D < 1) return cudaErrorInvalidValue;
  const long long cols = rows << logn;
  Shape s{};
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  auto query = [&](auto k) { return occupancy(k, s.threads, &per_sm); };
  switch (kernel) {
    case 0:
      s = tile_shape(kToBsk, K, D, cols);
      err = by_tile<ToBsk>(s, query);
      break;
    case 1:
      s = tile_shape(kFastFloor, K, D, cols);
      err = by_tile<FastFloor>(s, query);
      break;
    case 2:
      s = tile_shape(kFromBsk, K, D, cols);
      err = by_tile<FromBsk>(s, query);
      break;
    case 3:
      s = {0, 0, kTensorThreads,
           tensor_blocks((rows * K << logn) / 4) +
               tensor_blocks((rows * D << logn) / 4)};
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
