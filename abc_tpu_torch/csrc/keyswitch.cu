// Hybrid key-switching and rescaling kernels for Hopper (sm_90a): K4 of the
// port, the elementwise chains of a key switch in abc_tpu_torch/crypto/bfv.py
// and crypto/ckks.py around the NTTs.
//
// On the TPU these chains were never Pallas kernels: the reference runs
// abc_tpu/crypto/bfv.py and ckks.py under jax.jit, and XLA fused each chain
// of the jx32 engine (abc_tpu/ops/modarith.py) into TPU kernels of its own.
// Replaces:
//   ks_decompose  <- the digit lift of BfvContext._decompose_ntt
//                    (abc_tpu/crypto/bfv.py:941) and of
//                    CkksContext._decompose_ntt (abc_tpu/crypto/ckks.py:848)
//   ks_contract   <- the contraction of BfvContext._ks_inner (bfv.py:979) and
//                    of CkksContext._ks_inner (ckks.py:880), the Galois
//                    permutation of a hoisted rotation folded into its loads
//   ks_mod_down   <- BfvContext._mod_switch_down (bfv.py:1026),
//                    CkksContext._mod_switch_down (ckks.py:902) and
//                    CkksContext.rescale (ckks.py:775): exact centred
//                    division by one prime or more
//   ks_mod_down_relin, ks_mod_down_rotate (K9a)
//                 <- the same division with the tail of a relinearization
//                    (bfv.py:904-907, ckks.py:771-774: the two adds and the
//                    stack) or of a rotation (bfv.py:1117-1121, :1165;
//                    ckks.py:993, :1021: the signed coefficient gather of
//                    c0, its add, the stack) in its epilogue
//
// Data: row-major [rows, ..., n] uint32 residues (the port stores them as
// int32; every modulus is below 2^30), n = 2^logn >= 4; `rows` flattens every
// leading axis (batch, ciphertext component, a mesh's shard axis). The
// digit lift and the mod switch down read their rows at a stride of their
// own (`d_stride`, `x_stride` words), so that one component of a batch of
// ciphertexts ([B, 3, L, n][:, 2]) or a level's limbs of a wider
// ciphertext is read where it lies, with no copy. A thread (in a small
// contraction, a few lanes) takes a quad of 4 coefficients, so that loads
// and stores are 16-byte accesses coalesced along n; how a launch splits
// its work follows from its shape (abc_ks_plan, abc_ks_mod_down_plan).
// The mod switch down's indices are 32-bit, split by a multiply and a
// shift where they are not powers of two (rns_common.cuh: Div). Tables come
// by device pointer (a context's or a level's), never from __constant__
// memory, so that graphs of two contexts can replay in turns.
//
// Every word written is canonical in [0, q) and equal to the plain torch
// versions (abc_tpu_torch/ops/keyswitch_kernels.py), which copy the
// reference's arithmetic: sums of products are summed in 64 bits and
// reduced once per 16 products (each below 2^60, so 16 of them and one
// residue fit) and at their end (rns_common.cuh: reduce64); products with
// a table constant are Shoup products.

#include <atomic>
#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kThreads = 128;
// ks_mod_down keeps the special rows' running values in registers: at most
// this many special primes (the instantiations take 1, 2, 4 or 16)
constexpr int kMaxSpecials = 16;
// words of one record of the mod-down table (module note of abc_ks_mod_down)
constexpr int kRec = 4;

// ----------------------------------------------------------- digit lift

// ks_decompose's table, with q and ratio, is staged in shared memory when
// it fits in this many words (A K (4 + R) + 3 R: 142 at CKKS (32768, 8 + 2,
// k = 2)); a larger one is read where it lies
constexpr int kStageWords = 2048;

// K4c. d: rows of [L_in, n] coefficient-domain residues over the data
// primes, d_stride words apart; out: rows of [A, R, n], digit j of d lifted
// to the R columns of the extended base (q_r, its ratio: q[r], ratio[r]).
//
// K = 1 (KMAX 1, tab null): digit j is data row j, its lift the conditional
// subtract x >= q_r ? x - q_r : x (the primes are of one size, so x < 2 q_r).
// K >= 2: digit j's K sources, record (row index, q_src, (Q_j/q_i)^-1 mod
// q_src, its companion) at tab + 4 (j K + i); y_i = x_i (Q_j/q_i)^-1 mod
// q_src, out = sum_i y_i T[j][i][r] mod q_r with T[j][i][r] = Q_j/q_i mod q_r
// at tab + 4 A K + (j K + i) R + r. A short digit pads with records of
// (Q_j/q_i)^-1 = 0, whose terms are exactly 0. The lift is uncentred, as in
// the reference.
//
// A thread takes one quad of one digit (row, j) and a group of `cols` of
// its R columns (column group cg of `groups`): it loads the digit's source
// quads once, all before its first product, computes the y_i once, and
// writes the quad of each of its columns. A thread a column would read
// each input quad R times (k = 1) and each digit's records, sources and
// y_i R times in 2K dependent round trips (k >= 2). Here the table comes
// from DRAM in one round trip a block, behind one barrier, and a thread's
// sources in one more. The host picks `cols` (decompose_plan): two for the
// k = 1 lift, else as many as leave half a wave of threads. KMAX bounds the sources held in registers; K > 16 runs in
// chunks of 16, each chunk's sum added to the residue the thread stored
// for the chunks before it.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
ks_decompose_kernel(const uint32_t* __restrict__ d, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ q,
                    const uint64_t* __restrict__ ratio,
                    const uint32_t* __restrict__ tab, long long threads,
                    long long d_stride, int A, int R, int K, int cols,
                    int groups, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int qlog = logn - 2;
  const size_t c = static_cast<size_t>(t & ((1LL << qlog) - 1)) * 4;
  long long rest = t >> qlog;                   // (row A + j) groups + cg
  const int cg = static_cast<int>(rest % groups);
  rest /= groups;
  const int j = static_cast<int>(rest % A);
  const long long row = rest / A;
  const int r0 = cg * cols, r1 = min(R, r0 + cols);
  const uint32_t* rows_in = d + static_cast<size_t>(row * d_stride) + c;
  uint32_t* o = out + (static_cast<size_t>(row * A + j) * R << logn) + c;
  if constexpr (KMAX == 1) {
    if (t >= threads) return;
    const uint4 x = ld4(rows_in + (static_cast<size_t>(j) << logn));
    for (int r = r0; r < r1; ++r) {
      const uint32_t m = ld(q + r);
      st4(o + (static_cast<size_t>(r) << logn),
          make_uint4(x.x >= m ? x.x - m : x.x, x.y >= m ? x.y - m : x.y,
                     x.z >= m ? x.z - m : x.z, x.w >= m ? x.w - m : x.w));
    }
  } else {
    // the table, then q and ratio (as words), staged by the whole block:
    // every thread reaches the barrier, those past the end return after it
    __shared__ uint32_t stage[kStageWords];
    const int tab_words = A * K * (kRec + R);
    const bool staged = tab_words + 3 * R <= kStageWords;
    if (staged) {
      const uint32_t* ratio_w = reinterpret_cast<const uint32_t*>(ratio);
      for (int w = threadIdx.x; w < tab_words + 3 * R; w += blockDim.x) {
        stage[w] = w < tab_words       ? ld(tab + w)
                   : w < tab_words + R ? ld(q + (w - tab_words))
                                       : ld(ratio_w + (w - tab_words - R));
      }
    }
    __syncthreads();
    if (t >= threads) return;
    const uint32_t* tb = staged ? stage : tab;
    const uint32_t* recs = tb + kRec * static_cast<size_t>(j) * K;
    const uint32_t* T = tb + kRec * static_cast<size_t>(A) * K +
                        static_cast<size_t>(j) * K * R;
    for (int i0 = 0; i0 < K; i0 += KMAX) {
      uint4 y[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {          // every source load first
        if (i0 + i < K) {
          y[i] = ld4(rows_in + (static_cast<size_t>(recs[kRec * (i0 + i)])
                                << logn));
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {          // y_i, once a digit quad
        if (i0 + i < K) {
          const uint32_t* rec = recs + kRec * (i0 + i);
          const uint32_t qs = rec[1], w = rec[2], wsh = rec[3];
          y[i] = make_uint4(mul_const(y[i].x, w, wsh, qs),
                            mul_const(y[i].y, w, wsh, qs),
                            mul_const(y[i].z, w, wsh, qs),
                            mul_const(y[i].w, w, wsh, qs));
        }
      }
      for (int r = r0; r < r1; ++r) {
        const int rw = tab_words + R + 2 * r;
        const uint32_t m = staged ? stage[tab_words + r] : ld(q + r);
        const uint64_t ra =
            staged ? (static_cast<uint64_t>(stage[rw + 1]) << 32 | stage[rw])
                   : ld64(ratio + r);
        uint32_t* orow = o + (static_cast<size_t>(r) << logn);
        uint64_t acc[4] = {0, 0, 0, 0};
        if (i0 > 0) {                           // the chunks before, a residue
          const uint4 prev = *reinterpret_cast<const uint4*>(orow);
          acc[0] = prev.x, acc[1] = prev.y, acc[2] = prev.z, acc[3] = prev.w;
        }
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i0 + i < K) {
            const uint64_t f = T[static_cast<size_t>(i0 + i) * R + r];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] += lane_of(y[i], e) * f;
          }
        }
        st4(orow, make_uint4(reduce64(acc[0], m, ra), reduce64(acc[1], m, ra),
                             reduce64(acc[2], m, ra),
                             reduce64(acc[3], m, ra)));
      }
    }
  }
}

// ------------------------------------------------------------ contraction

// digits a lane loads together before its first product
constexpr int kLaneDigits = 4;

// The sums of a group of lanes (lane g = threadIdx.x mod G, G a power of
// two dividing 32), W 64-bit words a lane, scattered over the group: each
// exchange halves the words a lane keeps (the upper half where its bit
// MASK is set) until one is left, then sums it over the remaining bits. So
// lane g ends with the group's sum of words [(g / DUP) P, + P), P = max(W /
// G, 1) and DUP = max(G / W, 1) lanes holding each. Every lane of the warp
// must reach it.
template <int MASK, int LIVE, int W>
__device__ __forceinline__ void scatter_sum(uint64_t (&v)[W], int g) {
  if constexpr (MASK > 0) {
    if constexpr (LIVE > 1) {
      const bool hi = (g & MASK) != 0;
#pragma unroll
      for (int i = 0; i < LIVE / 2; ++i) {
        const unsigned long long send = hi ? v[i] : v[i + LIVE / 2];
        const uint64_t keep = hi ? v[i + LIVE / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, MASK);
      }
      scatter_sum<MASK / 2, LIVE / 2>(v, g);
    } else {
      v[0] += __shfl_xor_sync(0xFFFFFFFFu,
                              static_cast<unsigned long long>(v[0]), MASK);
      scatter_sum<MASK / 2, 1>(v, g);
    }
  }
}

// K4a. D: rows of [A, R, n] (the NTT-domain digits), kb and ka: krows of
// [A, R, n] (the switching key's halves; row `row` of D reads key row row %
// krows, so a key without leading axes has krows 1 and a key sharded like
// D carries D's last leading axes); out: rows of [2, R, n], the sums over
// the A digits of D kb and D ka mod q_r; with ka null (H = 1), rows of [1,
// R, n], the sum of D kb alone (a decryption's dot product with [1, s, s^2,
// ...]). With perm ([n] int64), output column c reads D at column perm[c]
// (a Galois automorphism in the NTT domain) and the key at c.
//
// On a launch of fewer than kSplitBelow quads an SM (one ciphertext of
// (8192, 6)), G lanes share one output quad (2, 4 or 8: the fewest that
// leave a lane at most kLaneDigits digits; lanes_arg); lane g takes digits
// g, g + G, ... and issues all its D and key loads before its first
// product, so that a call's bytes are asked for in about one round trip
// (a thread a quad walking the digits makes A dependent round trips). Its
// products are summed in 64 bits: the group's A <= 16 products fit, and
// past 16 digits each lane first reduces its own sum. The group's sums
// meet by shuffles (scatter_sum), the lanes share the stores, and each
// reduces only the words it stores. Past kLaneDigits G digits (A >
// 32) a lane loads the rest one digit at a time. A lane past the last quad
// reads quad 0 and stores nothing, so that every lane reaches every
// shuffle.
template <int G, int H>
__global__ void __launch_bounds__(kThreads)
ks_contract_kernel(const uint32_t* __restrict__ D,
                   const uint32_t* __restrict__ kb,
                   const uint32_t* __restrict__ ka,
                   uint32_t* __restrict__ out,
                   const long long* __restrict__ perm,
                   const uint32_t* __restrict__ q,
                   const uint64_t* __restrict__ ratio, long long quads,
                   long long krows, int A, int R, int logn) {
  constexpr int W = 4 * H;                  // words of a quad's sums
  constexpr int P = W >= G ? W / G : 1;     // words a lane stores
  constexpr int DUP = W >= G ? 1 : G / W;   // lanes that hold the same words
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int g = static_cast<int>(threadIdx.x) & (G - 1);
  const bool live = t / G < quads;
  const At at = at_of(live ? t / G : 0, logn);  // line = row R + r
  const int r = static_cast<int>(at.line % R);
  const long long row = at.line / R;
  const size_t plane = static_cast<size_t>(R) << logn;
  const size_t rn = static_cast<size_t>(r) << logn;
  const uint32_t* dp = D + static_cast<size_t>(row) * A * plane + rn;
  const size_t kofs = static_cast<size_t>(row % krows) * A * plane + rn +
                      at.c;
  const uint32_t* bp = kb + kofs;
  const uint32_t* ap = ka + (H == 2 ? kofs : 0);
  const uint32_t m = ld(q + r);
  const uint64_t ra = ld64(ratio + r);
  size_t p[4] = {at.c, at.c + 1, at.c + 2, at.c + 3};
  if (perm != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = static_cast<size_t>(__ldg(perm + at.c + e));
    }
  }
  const auto load_x = [&](int i) {
    const uint32_t* di = dp + i * plane;
    return perm == nullptr ? ld4(di + at.c)
                           : make_uint4(ld(di + p[0]), ld(di + p[1]),
                                        ld(di + p[2]), ld(di + p[3]));
  };
  const auto mac = [&](uint64_t (&acc)[W], const uint4& x, const uint4& b,
                       const uint4& a) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] += static_cast<uint64_t>(lane_of(x, e)) * lane_of(b, e);
      if constexpr (H == 2) {
        acc[4 + e] += static_cast<uint64_t>(lane_of(x, e)) * lane_of(a, e);
      }
    }
  };
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 x[kLaneDigits], b[kLaneDigits], a[kLaneDigits];
#pragma unroll
  for (int s = 0; s < kLaneDigits; ++s) {       // every load, then products
    const int i = g + s * G;
    x[s] = i < A ? load_x(i) : zero;
    b[s] = i < A ? ld4(bp + i * plane) : zero;
    a[s] = H == 2 && i < A ? ld4(ap + i * plane) : zero;
  }
  uint64_t acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0;
#pragma unroll
  for (int s = 0; s < kLaneDigits; ++s) mac(acc, x[s], b[s], a[s]);
  // digits past kLaneDigits G (A > 32), one a lane at a time
  for (int i = g + kLaneDigits * G, done = kLaneDigits; i - g < A;
       i += G, ++done) {
    if (done % 16 == 0) {                       // 16 products a lane
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = reduce64(acc[w], m, ra);
    }
    if (i < A) {
      mac(acc, load_x(i), ld4(bp + i * plane),
          H == 2 ? ld4(ap + i * plane) : zero);
    }
  }
  if (A > 16) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = reduce64(acc[w], m, ra);
  }
  scatter_sum<G / 2, W>(acc, g);
  if (live && g % DUP == 0) {
    const int w0 = g / DUP * P;
    uint32_t* base = out + static_cast<size_t>(row) * H * plane + rn + at.c;
    if constexpr (P >= 4) {
#pragma unroll
      for (int h = 0; h < P / 4; ++h) {
        st4(base + (w0 / 4 + h) * plane,
            make_uint4(reduce64(acc[4 * h], m, ra),
                       reduce64(acc[4 * h + 1], m, ra),
                       reduce64(acc[4 * h + 2], m, ra),
                       reduce64(acc[4 * h + 3], m, ra)));
      }
    } else {
      uint32_t* wp = base + (w0 / 4) * plane + w0 % 4;
#pragma unroll
      for (int w = 0; w < P; ++w) wp[w] = reduce64(acc[w], m, ra);
    }
  }
}

// K4a on a launch that fills the card (lanes_arg): a thread a quad of one
// output row walking the A digits, each digit's D and key loads 16
// contiguous bytes of a plane, the key read again for every row from the
// L2. On such a launch every SM already holds enough loads in
// flight, and this kept the memory busiest of the designs measured:
// holding the key over a run of batch rows in registers or in shared
// memory, or issuing two or more digits' loads together, cost occupancy
// and read slower, and sharing it through the L1 among a block's rows
// gained 2% at B=64 before its index arithmetic took that back
// (scripts/ks_ab.py; PERF.md §6). Same operands and words as
// ks_contract_kernel.
__global__ void __launch_bounds__(kThreads)
ks_contract_stream_kernel(const uint32_t* __restrict__ D,
                          const uint32_t* __restrict__ kb,
                          const uint32_t* __restrict__ ka,
                          uint32_t* __restrict__ out,
                          const long long* __restrict__ perm,
                          const uint32_t* __restrict__ q,
                          const uint64_t* __restrict__ ratio,
                          long long quads, long long krows, int A, int R,
                          int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = row R + r
  const int r = static_cast<int>(at.line % R);
  const long long row = at.line / R;
  const size_t plane = static_cast<size_t>(R) << logn;
  const size_t rn = static_cast<size_t>(r) << logn;
  const uint32_t* dp = D + static_cast<size_t>(row) * A * plane + rn;
  const size_t kofs = static_cast<size_t>(row % krows) * A * plane + rn +
                      at.c;
  const bool two = ka != nullptr;
  const uint32_t* bp = kb + kofs;
  const uint32_t* ap = two ? ka + kofs : nullptr;
  const uint32_t m = ld(q + r);
  const uint64_t ra = ld64(ratio + r);
  size_t p[4] = {at.c, at.c + 1, at.c + 2, at.c + 3};
  if (perm != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = static_cast<size_t>(__ldg(perm + at.c + e));
    }
  }
  uint64_t acc_b[4] = {0, 0, 0, 0}, acc_a[4] = {0, 0, 0, 0};
  for (int i = 0; i < A; ++i) {
    const uint32_t* di = dp + i * plane;
    const uint4 x = perm == nullptr
                        ? ld4(di + at.c)
                        : make_uint4(ld(di + p[0]), ld(di + p[1]),
                                     ld(di + p[2]), ld(di + p[3]));
    const uint4 b = ld4(bp + i * plane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_b[e] += static_cast<uint64_t>(lane_of(x, e)) * lane_of(b, e);
    }
    if (two) {
      const uint4 a = ld4(ap + i * plane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_a[e] += static_cast<uint64_t>(lane_of(x, e)) * lane_of(a, e);
      }
    }
    if ((i & 15) == 15 && i + 1 < A) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_b[e] = reduce64(acc_b[e], m, ra);
        acc_a[e] = reduce64(acc_a[e], m, ra);
      }
    }
  }
  uint32_t* o = out + static_cast<size_t>(row) * (two ? 2 : 1) * plane +
                rn + at.c;
  st4(o, make_uint4(reduce64(acc_b[0], m, ra), reduce64(acc_b[1], m, ra),
                    reduce64(acc_b[2], m, ra), reduce64(acc_b[3], m, ra)));
  if (!two) return;
  st4(o + plane,
      make_uint4(reduce64(acc_a[0], m, ra), reduce64(acc_a[1], m, ra),
                 reduce64(acc_a[2], m, ra), reduce64(acc_a[3], m, ra)));
}

// ------------------------------------------------------------ mod switch

// One exact centred division step of a word x of row t by the prime p whose
// running residue is v: (x - centred([v]_p) mod q_t) * p^-1 mod q_t, with the
// reference's steps word for word: v reduced mod q_t by one conditional
// subtraction (p < 2 q_t), and the centring test on the unreduced v against
// half = p >> 1. r: the row's record (q_t, p mod q_t, p^-1 mod q_t, its
// companion).
__device__ __forceinline__ uint32_t divide_step(uint32_t x, uint32_t v,
                                                uint32_t half,
                                                const uint4& r) {
  const uint32_t red = v >= r.x ? v - r.x : v;
  const uint32_t corr = v > half ? sub_mod(red, r.y, r.x) : red;
  return mul_const(sub_mod(x, corr, r.x), r.z, r.w, r.x);
}

__device__ __forceinline__ uint4 divide_step4(const uint4& x, const uint4& v,
                                              uint32_t half, const uint4& r) {
  return make_uint4(divide_step(x.x, v.x, half, r),
                    divide_step(x.y, v.y, half, r),
                    divide_step(x.z, v.z, half, r),
                    divide_step(x.w, v.w, half, r));
}

// What ks_mod_down adds to a kept row before it stores it (K9a). The output
// rows are [..., 2, Lo, n], the two halves (h = row & 1) of a key switch of
// ciphertext b = row >> 1; c holds the ciphertext's components, b's at
// c + b c_stride, component h at + h c_comp, rows of n words apart.
//   kNoTail: nothing, the halves (k0, k1) themselves;
//   kRelin:  out[h] = k_h + c[h] mod q, c the size-3 product (h = 0, 1);
//   kRotate: out[0] = k0 + c0^g mod q, out[1] = k1: column j of c0^g, the
//            image of c0 under x -> x^g, is c0[s] for s = j g^-1 mod 2n
//            below n, and -c0[s - n] above (g odd: j = s g mod 2n, and x^n
//            = -1). No table: the host passes g^-1 mod 2n (ginv).
enum Tail { kNoTail, kRelin, kRotate };

struct TailArgs {
  const uint32_t* c;
  long long c_stride, c_comp;
  uint32_t ginv;
};

struct ModDownArgs {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tab;
  uint32_t quads;                 // rows groups n / 4 < 2^31
  long long x_stride;
  Div groups;                     // groups of G kept rows a half, Lo / G up
  int Lo, k, logn;
  TailArgs tail;
};

// ks_mod_down holds its table's records in registers, and takes two kept
// rows a thread, for at most this many special primes (the instantiations
// of 1 and 2: the main paths' k); past them it reads each record where it
// lies, at the division step that needs it (held there, the rotation's
// instantiation for 4 spilled 4 bytes)
constexpr int kHeldSpecials = 2;

// K4b. x: rows of [Lo + k, n] (Lo rows kept, then the k primes divided
// out), x_stride words apart; out: rows of [Lo, n]. Step s (s = k-1 down to
// 0) divides every row below Lo + s by the prime of row Lo + s, so a thread
// carries the k special rows' running values through the steps (the
// specials below s are divided at step s too) and applies the k steps to
// its own rows. Step s's table: word 0 = half, then a record (divide_step)
// per row t < Lo + s, at tab + s (4 + 4 (Lo + k)); every record 16-byte
// aligned. The row's modulus for the tail is the first word of its record
// at step 0.
//
// What bounds it: bytes (x read once, out written once) but, at one
// ciphertext, one launch's latency; a thread a kept row read each special
// quad Lo times and divided the specials Lo times over, and a rotation's
// tail waited for an index and a sign table before it could load c0. The
// design: a thread takes one column quad of G kept rows of one half (G =
// 1 or 2, the host's choice by the launch's size: rows_arg), loads and
// divides the specials once for them, and computes the rotation's sources
// from g^-1. In order: 32-bit indices (Div), a rotation's c0 words
// (scattered 4-byte loads, issued first), the k special and G kept quads of
// x, the records its steps need (16-byte loads into registers), a
// relinearization's c_h quads: all in flight before the first division.
// Measured on an H100 (PERF.md, K9a), cold: the records issued before x
// read up to 0.4 us slower at one ciphertext, a relinearization's quads
// before x up to 0.4 us slower, a rotation's words after x up to 0.1 us
// slower. A programmatic dependent launch (the records and the tail read
// while the launch before drains) was measured and is not used
// (elementwise.cu).
template <int KMAX, int G, Tail T>
__device__ __forceinline__ void mod_down_body(const ModDownArgs& a) {
  constexpr bool kHeld = KMAX <= kHeldSpecials;
  const int qlog = a.logn - 2;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.quads) return;
  const uint32_t line = t >> qlog;              // row groups + group
  const uint32_t row = quot(line, a.groups);
  const int tr0 = static_cast<int>(line - row * a.groups.d) * G;
  const uint32_t col = (t & ((1u << qlog) - 1)) * 4;
  const size_t n = size_t(1) << a.logn;
  const int Lo = a.Lo, k = a.k, h = static_cast<int>(row & 1);
  const int stride = kRec + kRec * (Lo + k);
  // row r's record at step s
  const auto rec_at = [&](int s, int r) {
    return ld4(a.tab + s * stride + kRec * (1 + r));
  };
  // the tail's addends: a relinearization's c_h quads, a rotation's (half
  // 0) 4 words of c0 at the sources of its 4 columns, negated where flip
  const uint32_t* cb =
      T == kNoTail ? nullptr
                   : a.tail.c + static_cast<size_t>(row >> 1) *
                                    a.tail.c_stride;
  uint32_t src[4] = {0, 0, 0, 0};
  bool flip[4] = {false, false, false, false};
  if (T == kRotate) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t s = ((col + e) * a.tail.ginv) & ((2u << a.logn) - 1);
      src[e] = s & static_cast<uint32_t>(n - 1);
      flip[e] = (s >> a.logn) != 0;
    }
  }
  const bool adds = T == kRelin || (T == kRotate && h == 0);
  uint4 y[G];
  if (T == kRotate && adds) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (tr0 + i >= Lo) continue;
      const uint32_t* ci = cb + (static_cast<size_t>(tr0 + i) << a.logn);
      y[i] = make_uint4(ld(ci + src[0]), ld(ci + src[1]), ld(ci + src[2]),
                        ld(ci + src[3]));
    }
  }
  const uint32_t* in = a.x + static_cast<size_t>(row) * a.x_stride + col;
  uint4 v[KMAX], own[G];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) v[s] = ld4(in + (Lo + s) * n);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (tr0 + i < Lo) own[i] = ld4(in + (tr0 + i) * n);
  }
  // the records: own_rec[s][i] row tr0 + i's at step s, chain_rec[s][s2]
  // special s2's at step s, half[s]
  uint4 own_rec[kHeld ? KMAX : 1][G];
  uint4 chain_rec[kHeld ? KMAX : 1][kHeld ? KMAX : 1];
  uint32_t half[kHeld ? KMAX : 1];
  if constexpr (kHeld) {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s >= k) continue;
      half[s] = ld(a.tab + s * stride);
#pragma unroll
      for (int s2 = 0; s2 < s; ++s2) chain_rec[s][s2] = rec_at(s, Lo + s2);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (tr0 + i < Lo) own_rec[s][i] = rec_at(s, tr0 + i);
      }
    }
  }
  if (T == kRelin) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (tr0 + i >= Lo) continue;
      y[i] = ld4(cb + (static_cast<size_t>(tr0 + i) << a.logn) +
                 h * a.tail.c_comp + col);
    }
  }
#pragma unroll
  for (int s = KMAX - 1; s >= 0; --s) {
    if (s >= k) continue;
    const uint32_t hs = kHeld ? half[kHeld ? s : 0]
                              : ld(a.tab + s * stride);
#pragma unroll
    for (int s2 = 0; s2 < s; ++s2) {
      v[s2] = divide_step4(v[s2], v[s], hs,
                           kHeld ? chain_rec[kHeld ? s : 0][kHeld ? s2 : 0]
                                 : rec_at(s, Lo + s2));
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (tr0 + i < Lo) {
        own[i] = divide_step4(own[i], v[s], hs,
                              kHeld ? own_rec[kHeld ? s : 0][i]
                                    : rec_at(s, tr0 + i));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int tr = tr0 + i;
    if (tr >= Lo) continue;
    uint4 o = own[i];
    if (adds) {
      const uint32_t m = kHeld ? own_rec[0][i].x : ld(a.tab + kRec * (1 + tr));
      uint4 c = y[i];
      if (T == kRotate) {
        c = make_uint4(flip[0] ? neg_mod(c.x, m) : c.x,
                       flip[1] ? neg_mod(c.y, m) : c.y,
                       flip[2] ? neg_mod(c.z, m) : c.z,
                       flip[3] ? neg_mod(c.w, m) : c.w);
      }
      o = make_uint4(add_mod(o.x, c.x, m), add_mod(o.y, c.y, m),
                     add_mod(o.z, c.z, m), add_mod(o.w, c.w, m));
    }
    st4(a.out + (static_cast<size_t>(row * Lo + tr) << a.logn) + col, o);
  }
}

// K4b: ks_mod_down
template <int KMAX, int G>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_kernel(const ModDownArgs a) {
  mod_down_body<KMAX, G, kNoTail>(a);
}

// K9a: ks_mod_down with the relinearization's tail
template <int KMAX, int G>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_relin_kernel(const ModDownArgs a) {
  mod_down_body<KMAX, G, kRelin>(a);
}

// K9a: ks_mod_down with the rotation's tail
template <int KMAX, int G>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_rotate_kernel(const ModDownArgs a) {
  mod_down_body<KMAX, G, kRotate>(a);
}

// ------------------------------------------------------------- launching

// A launch of `threads` threads, kThreads a block.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long threads, void* stream,
                   Args... args) {
  if (threads <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation of ks_mod_down with tail T for k special primes and G
// kept rows a thread, passed to `go`.
template <int KMAX, int G, typename Go>
cudaError_t by_tail(Tail tail, Go go) {
  return tail == kRelin    ? go(ks_mod_down_relin_kernel<KMAX, G>)
         : tail == kRotate ? go(ks_mod_down_rotate_kernel<KMAX, G>)
                           : go(ks_mod_down_kernel<KMAX, G>);
}

template <int KMAX, typename Go>
cudaError_t by_rows(int G, Tail tail, Go go) {
  if constexpr (KMAX > kHeldSpecials) {
    return by_tail<KMAX, 1>(tail, go);
  } else {
    return G == 2 ? by_tail<KMAX, 2>(tail, go) : by_tail<KMAX, 1>(tail, go);
  }
}

template <typename Go>
cudaError_t by_specials(int k, int G, Tail tail, Go go) {
  if (k == 1) return by_rows<1>(G, tail, go);
  if (k == 2) return by_rows<2>(G, tail, go);
  if (k <= 4) return by_rows<4>(G, tail, go);
  return by_rows<kMaxSpecials>(G, tail, go);
}

int specials_arg(int k) {
  return k == 1 ? 1 : k == 2 ? 2 : k <= 4 ? 4 : kMaxSpecials;
}

// threads an SM holds of the mod-down kernels (128-thread blocks)
constexpr long long kModDownResident = 2048;

// ks_mod_down's kept rows a thread (G) for `rows` halves of Lo kept rows
// of n = 2^logn, k special primes, on `sms` SMs: 2 where a thread a kept
// row would fill the card (every SM holding kModDownResident threads), at
// most kHeldSpecials specials (past them their running values and records
// fill the registers) and Lo >= 2, else 1. Measured on an H100 (PERF.md,
// K9a): 2 at B=64 of (8192, 6) read fastest at k = 1 and 2, 4 slower; 1
// at one ciphertext.
int rows_arg(long long rows, int Lo, int k, int logn, int sms) {
  const long long quads = ((rows * Lo) << logn) / 4;
  return k <= kHeldSpecials && Lo >= 2 && quads >= sms * kModDownResident
             ? 2
             : 1;
}

// What a ks_mod_down launch does, by its shape: the instantiation (special
// primes held, kept rows a thread), the groups of G kept rows a half, and
// the threads.
struct ModDownPlan {
  int kmax, G;
  long long groups, threads;
};

cudaError_t mod_down_plan(long long rows, int Lo, int k, int logn,
                          ModDownPlan* plan) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  plan->kmax = specials_arg(k);
  plan->G = rows_arg(rows, Lo, k, logn, sms);
  plan->groups = (Lo + plan->G - 1) / plan->G;
  plan->threads = ((rows * plan->groups) << logn) / 4;
  return cudaSuccess;
}

// Blocks of kThreads that an SM holds of `kernel` (its theoretical
// occupancy), asked once a kernel, with the query's error.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int* blocks) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> known;
  const void* key = reinterpret_cast<const void*>(kernel);
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : known) {
    if (e.first == key) {
      *blocks = e.second;
      return cudaSuccess;
    }
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads,
                                                    0);
  if (err == cudaSuccess) known.emplace_back(key, *blocks);
  return err;
}

// ks_decompose's instantiation for digits of K sources: the most sources
// it holds in registers (1: the k = 1 lift)
int sources_arg(int K) { return K == 1 ? 1 : K == 2 ? 2 : K <= 4 ? 4 : 16; }

template <typename Go>
cudaError_t by_sources(int K, Go go) {
  switch (sources_arg(K)) {
    case 1: return go(ks_decompose_kernel<1>);
    case 2: return go(ks_decompose_kernel<2>);
    case 4: return go(ks_decompose_kernel<4>);
    default: return go(ks_decompose_kernel<16>);
  }
}

// A contraction whose thread-a-quad launch has fewer quads than this for
// each SM is latency-bound (a few hundred bytes in flight an SM): it
// splits its digits over lanes (ks_contract_kernel). Any larger one keeps
// the card's memory busy a thread a quad (ks_contract_stream_kernel).
constexpr long long kSplitBelow = 256;

// ks_contract's lanes a quad for A digits of `quads` thread-a-quad work on
// `sms` SMs: 1 (ks_contract_stream_kernel) for one digit or a launch that
// fills the card, else the fewest of 2, 4 and 8 that leave a lane at most
// kLaneDigits digits
int lanes_arg(int A, long long quads, int sms) {
  return A == 1 || quads >= kSplitBelow * sms ? 1
         : A <= 2 * kLaneDigits                ? 2
         : A <= 4 * kLaneDigits                ? 4
                                               : 8;
}

template <int H, typename Go>
cudaError_t by_lanes_of(int G, Go go) {
  switch (G) {
    case 1: return go(ks_contract_stream_kernel);
    case 2: return go(ks_contract_kernel<2, H>);
    case 4: return go(ks_contract_kernel<4, H>);
    default: return go(ks_contract_kernel<8, H>);
  }
}

// The kernel for G lanes a quad (1: the streaming kernel) and H halves,
// passed to `go`.
template <typename Go>
cudaError_t by_lanes(int G, int H, Go go) {
  return H == 1 ? by_lanes_of<1>(G, go) : by_lanes_of<2>(G, go);
}

// What a ks_decompose or ks_contract launch does, by its shape: the
// instantiation (arg0: sources held, or lanes a quad; arg1: 0, or halves),
// the lift's split (arg2: columns a thread; arg3: column groups) and the
// threads.
struct Plan {
  long long arg[4];
  long long threads;
};

// The k = 1 lift's columns a thread: its stores, not its one load, bound
// it, and two columns a thread read fastest on the card at every timed
// k = 1 shape, beside the 1, 3, 4 or 7 measured there (PERF.md §6)
constexpr int kLiftCols = 2;

// ks_decompose over rows of [L_in, n] into A digits of K sources lifted to
// R columns: kLiftCols columns a thread for K = 1 and, for K >= 2, the
// fewest column groups that make half a wave of threads (a thread a column
// where even that does not: one ciphertext of (8192, 6)), since each
// column a thread adds spares the K Shoup products and the source loads of
// another thread.
cudaError_t decompose_plan(long long rows, int A, int R, int K, int logn,
                           Plan* plan) {
  const long long digit_quads = ((rows * A) << logn) / 4;
  int cols = kLiftCols;
  if (K > 1) {
    int sms = 0, per_sm = 0;
    cudaError_t err = sm_count(&sms);
    if (err == cudaSuccess) {
      err = by_sources(K, [&](auto kernel) {
        return blocks_per_sm(kernel, &per_sm);
      });
    }
    if (err != cudaSuccess) return err;
    const long long fill = static_cast<long long>(sms) *
                           (per_sm > 0 ? per_sm : 1) * kThreads / 2;
    long long groups = digit_quads > 0 ? (fill + digit_quads - 1) /
                                             digit_quads : 1;
    groups = groups < 1 ? 1 : groups > R ? R : groups;
    cols = static_cast<int>((R + groups - 1) / groups);
  }
  cols = cols > R ? R : cols;
  plan->arg[0] = sources_arg(K);
  plan->arg[1] = 0;
  plan->arg[2] = cols;
  plan->arg[3] = (R + cols - 1) / cols;
  plan->threads = digit_quads * plan->arg[3];
  return cudaSuccess;
}

// ks_contract of rows of [A, R, n] with H halves: lanes_arg's lanes a quad,
// a thread a lane.
cudaError_t contract_plan(long long rows, int A, int R, int H, int logn,
                          Plan* plan) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long quads = ((rows * R) << logn) / 4;
  const int G = lanes_arg(A, quads, sms);
  plan->arg[0] = G;
  plan->arg[1] = H;
  plan->arg[2] = 0;
  plan->arg[3] = 0;
  plan->threads = quads * G;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t; n = 2^logn
// (logn >= 2); `rows` counts the leading rows (every axis before the last
// two or three). Each returns the cudaError_t of its launch (0 on success);
// a shape the kernel does not take returns cudaErrorInvalidValue. Every
// operand takes 16-byte aligned rows.

// K4c: d [rows, L_in, n], rows d_stride words apart (a multiple of 4, at
// least L_in n) -> out [rows, A, R, n]; q [R] uint32 and ratio [R] uint64
// the columns' moduli; tab null for K = 1 (A = L_in), else the digit table
// of ks_decompose_kernel for digits of K sources. The launch's split:
// abc_ks_plan.
int abc_ks_decompose(const void* d, void* out, const void* q,
                     const void* ratio, const void* tab, long long rows,
                     long long d_stride, int L_in, int A, int R, int K,
                     int logn, void* stream) {
  if (logn < 2 || rows < 0 || L_in < 1 || A < 1 || R < 1 || K < 1 ||
      (tab == nullptr) != (K == 1) || (K == 1 && A != L_in) ||
      d_stride < (static_cast<long long>(L_in) << logn) || d_stride % 4) {
    return cudaErrorInvalidValue;
  }
  Plan plan = {};
  const cudaError_t err = decompose_plan(rows, A, R, K, logn, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_sources(K, [&](auto kernel) {
    return launch(kernel, plan.threads, stream,
                  static_cast<const uint32_t*>(d), static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(q),
                  static_cast<const uint64_t*>(ratio),
                  static_cast<const uint32_t*>(tab), plan.threads, d_stride,
                  A, R, K, static_cast<int>(plan.arg[2]),
                  static_cast<int>(plan.arg[3]), logn);
  }));
}

// K4a: D [rows, A, R, n], kb and ka [krows, A, R, n] (rows a multiple of
// krows; ka may be null), perm [n] int64 or null, q [R] uint32 and ratio
// [R] uint64 -> out [rows, 2, R, n] ([rows, 1, R, n] without ka). The
// launch's kernel: abc_ks_plan.
int abc_ks_contract(const void* D, const void* kb, const void* ka, void* out,
                    const void* perm, const void* q, const void* ratio,
                    long long rows, long long krows, int A, int R, int logn,
                    void* stream) {
  if (logn < 2 || rows < 0 || krows < 1 || rows % krows != 0 || A < 1 ||
      R < 1) {
    return cudaErrorInvalidValue;
  }
  const int H = ka == nullptr ? 1 : 2;
  Plan plan = {};
  const cudaError_t err = contract_plan(rows, A, R, H, logn, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long G = plan.arg[0];
  return static_cast<int>(by_lanes(static_cast<int>(G), H, [&](auto kernel) {
    return launch(kernel, plan.threads, stream,
                  static_cast<const uint32_t*>(D),
                  static_cast<const uint32_t*>(kb),
                  static_cast<const uint32_t*>(ka),
                  static_cast<uint32_t*>(out),
                  static_cast<const long long*>(perm),
                  static_cast<const uint32_t*>(q),
                  static_cast<const uint64_t*>(ratio),
                  plan.threads / G, krows, A, R, logn);
  }));
}

// K9a: abc_ks_mod_down with a tail (1 relin, 2 rotate; 0 none) over rows
// = 2 B rows, the two halves of B key switches: c the ciphertexts'
// components ([B, C, Lo, n] rows of n words; ciphertext b at c + b
// c_stride, component h at + h c_comp, both multiples of 4); the rotation
// by g reads component 0 at the sources of x -> x^g, from ginv = g^-1 mod
// 2n (odd).
int abc_ks_mod_down_tail(const void* x, void* out, const void* tab,
                         long long rows, long long x_stride, int Lo, int k,
                         int logn, int tail, const void* c,
                         long long c_stride, long long c_comp, long long ginv,
                         void* stream) {
  if (logn < 2 || logn > 30 || rows < 0 || Lo < 1 || k < 1 ||
      k > kMaxSpecials ||
      x_stride < (static_cast<long long>(Lo + k) << logn) || x_stride % 4 ||
      tail < kNoTail || tail > kRotate ||
      rows * Lo >= (1LL << 31) || ((rows * Lo) << logn) / 4 >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (tail != kNoTail &&
      (c == nullptr || rows % 2 || c_stride % 4 || c_comp % 4 ||
       (tail == kRotate &&
        (ginv < 1 || ginv >= (2LL << logn) || ginv % 2 == 0)))) {
    return cudaErrorInvalidValue;
  }
  ModDownPlan plan = {};
  const cudaError_t err = mod_down_plan(rows, Lo, k, logn, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.threads == 0) return cudaSuccess;
  ModDownArgs args = {};
  args.x = static_cast<const uint32_t*>(x);
  args.out = static_cast<uint32_t*>(out);
  args.tab = static_cast<const uint32_t*>(tab);
  args.quads = static_cast<uint32_t>(plan.threads);
  args.x_stride = x_stride;
  args.groups = div_by(static_cast<uint32_t>(plan.groups));
  args.Lo = Lo;
  args.k = k;
  args.logn = logn;
  args.tail = {static_cast<const uint32_t*>(c), c_stride, c_comp,
               static_cast<uint32_t>(tail == kRotate ? ginv : 0)};
  return static_cast<int>(by_specials(
      k, plan.G, static_cast<Tail>(tail), [&](auto kernel) {
        return launch(kernel, plan.threads, stream, args);
      }));
}

// K4b: x [rows, Lo + k, n], rows x_stride words apart (a multiple of 4,
// at least (Lo + k) n) -> out [rows, Lo, n], tab the table of
// ks_mod_down_kernel (k steps of 4 + 4 (Lo + k) words), 1 <= k <= 16.
int abc_ks_mod_down(const void* x, void* out, const void* tab, long long rows,
                    long long x_stride, int Lo, int k, int logn,
                    void* stream) {
  return abc_ks_mod_down_tail(x, out, tab, rows, x_stride, Lo, k, logn,
                              kNoTail, nullptr, 0, 0, 0, stream);
}

// The launch that abc_ks_mod_down makes (tail 0; 1 and 2 with the relin
// and the rotate tail) over `rows` rows of Lo kept rows of n = 2^logn and k
// special primes, into info[8]: the instantiation (special primes held,
// kept rows a thread G), threads a block, blocks, the instantiation's
// theoretical occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// blocks and warps an SM), threads and the card's SMs. ks_decompose and
// ks_contract launch by their whole shape: abc_ks_plan. Returns the
// cudaError_t of the queries, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int abc_ks_mod_down_plan(int tail, long long rows, int Lo, int k, int logn,
                         long long* info) {
  if (logn < 2 || logn > 30 || rows < 0 || Lo < 1 || k < 1 ||
      k > kMaxSpecials || tail < kNoTail || tail > kRotate) {
    return cudaErrorInvalidValue;
  }
  ModDownPlan plan = {};
  int per_sm = 0, sms = 0;
  cudaError_t err = mod_down_plan(rows, Lo, k, logn, &plan);
  if (err == cudaSuccess) {
    err = by_specials(k, plan.G, static_cast<Tail>(tail), [&](auto kern) {
      return blocks_per_sm(kern, &per_sm);
    });
  }
  if (err == cudaSuccess) err = sm_count(&sms);
  info[0] = plan.kmax;
  info[1] = plan.G;
  info[2] = kThreads;
  info[3] = (plan.threads + kThreads - 1) / kThreads;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  info[6] = plan.threads;
  info[7] = sms;
  return static_cast<int>(err);
}

// The launch that abc_ks_decompose (kernel 0: rows of d, A digits of K
// sources, R columns) or abc_ks_contract (kernel 1: rows of D, A digits, R
// columns, `halves` 1 or 2) makes, into info[10]: the instantiation
// (sources held in registers, 0; or lanes a quad, halves), the lift's
// split (columns a thread, column groups; 0, 0 for the contraction),
// threads a block, blocks, blocks and warps an SM (the instantiation's
// theoretical occupancy), threads and the card's SMs. Returns the
// cudaError_t of the queries, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int abc_ks_plan(int kernel, long long rows, int A, int R, int K, int halves,
                int logn, long long* info) {
  if (logn < 2 || rows < 0 || A < 1 || R < 1 || K < 1 || halves < 1 ||
      halves > 2 || kernel < 0 || kernel > 1) {
    return cudaErrorInvalidValue;
  }
  Plan plan = {};
  int per_sm = 0, sms = 0;
  const auto query = [&](auto kern) { return blocks_per_sm(kern, &per_sm); };
  cudaError_t err = kernel == 0
                        ? decompose_plan(rows, A, R, K, logn, &plan)
                        : contract_plan(rows, A, R, halves, logn, &plan);
  if (err == cudaSuccess) {
    err = kernel == 0 ? by_sources(K, query)
                      : by_lanes(static_cast<int>(plan.arg[0]), halves,
                                 query);
  }
  if (err == cudaSuccess) err = sm_count(&sms);
  for (int i = 0; i < 4; ++i) info[i] = plan.arg[i];
  info[4] = kThreads;
  info[5] = (plan.threads + kThreads - 1) / kThreads;
  info[6] = per_sm;
  info[7] = static_cast<long long>(per_sm) * (kThreads / 32);
  info[8] = plan.threads;
  info[9] = sms;
  return static_cast<int>(err);
}

}  // extern "C"
