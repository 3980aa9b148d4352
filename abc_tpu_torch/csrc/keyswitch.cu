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
// ciphertext is read where it lies, with no copy. Every
// kernel takes a thread per quad of 4 coefficients of one output row, so
// that loads and stores are 16-byte accesses coalesced along n. Tables come
// by device pointer (a context's or a level's), never from __constant__
// memory, so that graphs of two contexts can replay in turns.
//
// Every word written is canonical in [0, q) and equal to the plain torch
// versions (abc_tpu_torch/ops/keyswitch_kernels.py), which copy the
// reference's arithmetic: sums of products are summed in 64 bits and
// reduced once per 16 products (each below 2^60, so 16 of them and one
// residue fit) and at their end (rns_common.cuh: reduce64); products with
// a table constant are Shoup products.

#include <cstdint>
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

// K4c. d: rows of [L_in, n] coefficient-domain residues over the data
// primes, d_stride words apart; out: rows of [A, R, n], digit j of d lifted to the R columns of
// the extended base (q_r, its ratio: q[r], ratio[r]).
//
// K = 1 (tab null): digit j is data row j, its lift the conditional
// subtract x >= q_r ? x - q_r : x (the primes are of one size, so x < 2 q_r).
// K >= 2: digit j's K sources, record (row index, q_src, (Q_j/q_i)^-1 mod
// q_src, its companion) at tab + 4 (j K + i); y_i = x_i (Q_j/q_i)^-1 mod
// q_src, out = sum_i y_i T[j][i][r] mod q_r with T[j][i][r] = Q_j/q_i mod q_r
// at tab + 4 A K + (j K + i) R + r. A short digit pads with records of
// (Q_j/q_i)^-1 = 0, whose terms are exactly 0. The lift is uncentred, as in
// the reference.
__global__ void __launch_bounds__(kThreads)
ks_decompose_kernel(const uint32_t* __restrict__ d,
                    uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ q,
                    const uint64_t* __restrict__ ratio,
                    const uint32_t* __restrict__ tab, long long quads,
                    long long d_stride, int L_in, int A, int R, int K,
                    int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = (row A + j) R + r
  const int r = static_cast<int>(at.line % R);
  const long long rj = at.line / R;
  const int j = static_cast<int>(rj % A);
  const long long row = rj / A;
  const uint32_t m = ld(q + r);
  uint32_t* o = out + (static_cast<size_t>(at.line) << logn) + at.c;
  const uint32_t* rows_in = d + static_cast<size_t>(row * d_stride) + at.c;
  if (tab == nullptr) {
    const uint4 x = ld4(rows_in + (static_cast<size_t>(j) << logn));
    st4(o, make_uint4(x.x >= m ? x.x - m : x.x, x.y >= m ? x.y - m : x.y,
                      x.z >= m ? x.z - m : x.z, x.w >= m ? x.w - m : x.w));
    return;
  }
  const uint64_t ra = ld64(ratio + r);
  const uint32_t* src = tab + kRec * static_cast<size_t>(j) * K;
  const uint32_t* T = tab + kRec * static_cast<size_t>(A) * K +
                      static_cast<size_t>(j) * K * R + r;
  uint64_t acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < K; ++i) {
    const uint32_t* rec = src + kRec * i;
    const uint32_t g = ld(rec), qs = ld(rec + 1), w = ld(rec + 2),
                   wsh = ld(rec + 3);
    const uint4 x = ld4(rows_in + (static_cast<size_t>(g) << logn));
    const uint64_t f = ld(T + static_cast<size_t>(i) * R);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] += mul_const(lane_of(x, e), w, wsh, qs) * f;
    }
    if ((i & 15) == 15 && i + 1 < K) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = reduce64(acc[e], m, ra);
    }
  }
  st4(o, make_uint4(reduce64(acc[0], m, ra), reduce64(acc[1], m, ra),
                    reduce64(acc[2], m, ra), reduce64(acc[3], m, ra)));
}

// ------------------------------------------------------------ contraction

// K4a. D: rows of [A, R, n] (the NTT-domain digits), kb and ka: krows of
// [A, R, n] (the switching key's halves; row `row` of D reads key row row %
// krows, so a key without leading axes has krows 1 and a key sharded like
// D carries D's last leading axes); out: rows of [2, R, n], the sums over
// the A digits of D kb and D ka mod q_r; with ka null, rows of [1, R, n],
// the sum of D kb alone (a decryption's dot product with [1, s, s^2, ...]).
// With perm ([n] int64), output column c reads D at column perm[c] (a
// Galois automorphism in the NTT domain) and the key at c.
__global__ void __launch_bounds__(kThreads)
ks_contract_kernel(const uint32_t* __restrict__ D,
                   const uint32_t* __restrict__ kb,
                   const uint32_t* __restrict__ ka,
                   uint32_t* __restrict__ out,
                   const long long* __restrict__ perm,
                   const uint32_t* __restrict__ q,
                   const uint64_t* __restrict__ ratio, long long quads,
                   long long krows, int A, int R, int logn) {
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
// half = p >> 1. rec: (q_t, p mod q_t, p^-1 mod q_t, its companion).
__device__ __forceinline__ uint32_t divide_step(uint32_t x, uint32_t v,
                                                uint32_t half,
                                                const uint32_t* rec) {
  const uint32_t m = ld(rec), p_mod = ld(rec + 1), w = ld(rec + 2),
                 wsh = ld(rec + 3);
  const uint32_t red = v >= m ? v - m : v;
  const uint32_t corr = v > half ? sub_mod(red, p_mod, m) : red;
  return mul_const(sub_mod(x, corr, m), w, wsh, m);
}

__device__ __forceinline__ uint4 divide_step4(const uint4& x, const uint4& v,
                                              uint32_t half,
                                              const uint32_t* rec) {
  return make_uint4(divide_step(x.x, v.x, half, rec),
                    divide_step(x.y, v.y, half, rec),
                    divide_step(x.z, v.z, half, rec),
                    divide_step(x.w, v.w, half, rec));
}

// What ks_mod_down adds to a kept row before it stores it (K9a). The output
// rows are [..., 2, Lo, n], the two halves (h = row & 1) of a key switch of
// ciphertext b = row >> 1; c holds the ciphertext's components, b's at
// c + b c_stride, component h at + h c_comp, rows of n words apart.
//   kNoTail: nothing, the halves (k0, k1) themselves;
//   kRelin:  out[h] = k_h + c[h] mod q, c the size-3 product (h = 0, 1);
//   kRotate: out[0] = k0 + (sign[j] ? c0[gather[j]] : -c0[gather[j]]) mod
//            q at column j, the signed coefficient gather of x -> x^g
//            (gather [n] int64, sign [n] bytes), out[1] = k1.
enum Tail { kNoTail, kRelin, kRotate };

struct TailArgs {
  const uint32_t* c;
  long long c_stride, c_comp;
  const long long* gather;
  const uint8_t* sign;
};

// K4b. x: rows of [Lo + k, n] (Lo rows kept, then the k primes divided
// out), x_stride words apart; out: rows of [Lo, n]. Step s (s = k-1 down to 0) divides every row
// below Lo + s by the prime of row Lo + s, so a thread carries the k
// special rows' running values through the steps (the specials below s are
// divided at step s too) and applies the k steps to its own row. Step s's
// table: word 0 = half, then a record (rec above) per row t < Lo + s, at
// tab + s (4 + 4 (Lo + k)). The row's modulus for the tail is the first
// word of its record at step 0.
template <int KMAX, Tail T>
__device__ __forceinline__ void mod_down_body(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tab, long long quads, long long x_stride,
    int Lo, int k, int logn, const TailArgs& tail) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = row Lo + tr
  const int tr = static_cast<int>(at.line % Lo);
  const long long row = at.line / Lo;
  const size_t n = size_t(1) << logn;
  const uint32_t* in = x + static_cast<size_t>(row * x_stride) + at.c;
  const int stride = kRec + kRec * (Lo + k);
  uint4 v[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) v[s] = ld4(in + (Lo + s) * n);
  }
  uint4 own = ld4(in + tr * n);
  // the tail's addend, loaded beside x so that its latency overlaps the
  // divisions (0 where the tail adds nothing: k1 of a rotation)
  uint4 y = make_uint4(0, 0, 0, 0);
  uint32_t m = 0;
  if (T != kNoTail) {
    m = ld(tab + kRec * (1 + tr));
    const int h = static_cast<int>(row & 1);
    const uint32_t* c = tail.c + static_cast<size_t>((row >> 1) *
                                                     tail.c_stride) +
                        (static_cast<size_t>(tr) << logn);
    if (T == kRelin) {
      y = ld4(c + h * tail.c_comp + at.c);
    } else if (h == 0) {
      uint32_t g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t j = at.c + e;
        const uint32_t w = ld(c + __ldg(tail.gather + j));
        g[e] = __ldg(tail.sign + j) ? w : neg_mod(w, m);
      }
      y = make_uint4(g[0], g[1], g[2], g[3]);
    }
  }
#pragma unroll
  for (int s = KMAX - 1; s >= 0; --s) {
    if (s >= k) continue;
    const uint32_t* step = tab + static_cast<size_t>(s) * stride;
    const uint32_t half = ld(step);
#pragma unroll
    for (int s2 = 0; s2 < s; ++s2) {
      v[s2] = divide_step4(v[s2], v[s], half, step + kRec * (1 + Lo + s2));
    }
    own = divide_step4(own, v[s], half, step + kRec * (1 + tr));
  }
  if (T != kNoTail) {
    own = make_uint4(add_mod(own.x, y.x, m), add_mod(own.y, y.y, m),
                     add_mod(own.z, y.z, m), add_mod(own.w, y.w, m));
  }
  st4(out + (static_cast<size_t>(at.line) << logn) + at.c, own);
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tab, long long quads,
                   long long x_stride, int Lo, int k, int logn,
                   TailArgs tail) {
  mod_down_body<KMAX, kNoTail>(x, out, tab, quads, x_stride, Lo, k, logn,
                               tail);
}

// K9a: ks_mod_down with the relinearization's tail
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_relin_kernel(const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ tab, long long quads,
                         long long x_stride, int Lo, int k, int logn,
                         TailArgs tail) {
  mod_down_body<KMAX, kRelin>(x, out, tab, quads, x_stride, Lo, k, logn,
                              tail);
}

// K9a: ks_mod_down with the rotation's tail
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
ks_mod_down_rotate_kernel(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ tab, long long quads,
                          long long x_stride, int Lo, int k, int logn,
                          TailArgs tail) {
  mod_down_body<KMAX, kRotate>(x, out, tab, quads, x_stride, Lo, k, logn,
                               tail);
}

// ------------------------------------------------------------- launching

// A launch of a thread a quad: `quads` threads, kThreads a block.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long quads, void* stream,
                   Args... args) {
  if (quads <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((quads + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation of ks_mod_down with tail T for k special primes,
// passed to `go`.
template <int KMAX>
auto mod_down_kernel(Tail tail) {
  return tail == kRelin    ? ks_mod_down_relin_kernel<KMAX>
         : tail == kRotate ? ks_mod_down_rotate_kernel<KMAX>
                           : ks_mod_down_kernel<KMAX>;
}

template <typename Go>
cudaError_t by_specials(int k, Tail tail, Go go) {
  if (k == 1) return go(mod_down_kernel<1>(tail));
  if (k == 2) return go(mod_down_kernel<2>(tail));
  if (k <= 4) return go(mod_down_kernel<4>(tail));
  return go(mod_down_kernel<kMaxSpecials>(tail));
}

int specials_arg(int k) {
  return k == 1 ? 1 : k == 2 ? 2 : k <= 4 ? 4 : kMaxSpecials;
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
// of ks_decompose_kernel for digits of K sources.
int abc_ks_decompose(const void* d, void* out, const void* q,
                     const void* ratio, const void* tab, long long rows,
                     long long d_stride, int L_in, int A, int R, int K,
                     int logn, void* stream) {
  if (logn < 2 || rows < 0 || L_in < 1 || A < 1 || R < 1 || K < 1 ||
      (tab == nullptr) != (K == 1) || (K == 1 && A != L_in) ||
      d_stride < (static_cast<long long>(L_in) << logn) || d_stride % 4) {
    return cudaErrorInvalidValue;
  }
  const long long quads = ((rows * A * R) << logn) / 4;
  return static_cast<int>(launch(
      ks_decompose_kernel, quads, stream, static_cast<const uint32_t*>(d),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(q),
      static_cast<const uint64_t*>(ratio), static_cast<const uint32_t*>(tab),
      quads, d_stride, L_in, A, R, K, logn));
}

// K4a: D [rows, A, R, n], kb and ka [krows, A, R, n] (rows a multiple of
// krows; ka may be null), perm [n] int64 or null, q [R] uint32 and ratio
// [R] uint64 -> out [rows, 2, R, n] ([rows, 1, R, n] without ka).
int abc_ks_contract(const void* D, const void* kb, const void* ka, void* out,
                    const void* perm, const void* q, const void* ratio,
                    long long rows, long long krows, int A, int R, int logn,
                    void* stream) {
  if (logn < 2 || rows < 0 || krows < 1 || rows % krows != 0 || A < 1 ||
      R < 1) {
    return cudaErrorInvalidValue;
  }
  const long long quads = ((rows * R) << logn) / 4;
  return static_cast<int>(launch(
      ks_contract_kernel, quads, stream, static_cast<const uint32_t*>(D),
      static_cast<const uint32_t*>(kb), static_cast<const uint32_t*>(ka),
      static_cast<uint32_t*>(out), static_cast<const long long*>(perm),
      static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(ratio),
      quads, krows, A, R, logn));
}

// K9a: abc_ks_mod_down with a tail (1 relin, 2 rotate; 0 none) over rows
// = 2 B rows, the two halves of B key switches: c the ciphertexts'
// components ([B, C, Lo, n] rows of n words; ciphertext b at c + b
// c_stride, component h at + h c_comp, both multiples of 4); the rotation
// reads component 0 at gather [n] int64 with keep-sign bytes sign [n].
int abc_ks_mod_down_tail(const void* x, void* out, const void* tab,
                         long long rows, long long x_stride, int Lo, int k,
                         int logn, int tail, const void* c,
                         long long c_stride, long long c_comp,
                         const void* gather, const void* sign,
                         void* stream) {
  if (logn < 2 || rows < 0 || Lo < 1 || k < 1 || k > kMaxSpecials ||
      x_stride < (static_cast<long long>(Lo + k) << logn) || x_stride % 4 ||
      tail < kNoTail || tail > kRotate) {
    return cudaErrorInvalidValue;
  }
  if (tail != kNoTail &&
      (c == nullptr || rows % 2 || c_stride % 4 || c_comp % 4 ||
       (tail == kRotate && (gather == nullptr || sign == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  const TailArgs args = {static_cast<const uint32_t*>(c), c_stride, c_comp,
                         static_cast<const long long*>(gather),
                         static_cast<const uint8_t*>(sign)};
  const long long quads = ((rows * Lo) << logn) / 4;
  return static_cast<int>(by_specials(k, static_cast<Tail>(tail),
                                      [&](auto kernel) {
    return launch(kernel, quads, stream, static_cast<const uint32_t*>(x),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(tab), quads, x_stride, Lo, k,
                  logn, args);
  }));
}

// K4b: x [rows, Lo + k, n], rows x_stride words apart (a multiple of 4,
// at least (Lo + k) n) -> out [rows, Lo, n], tab the table of
// ks_mod_down_kernel (k steps of 4 + 4 (Lo + k) words), 1 <= k <= 16.
int abc_ks_mod_down(const void* x, void* out, const void* tab, long long rows,
                    long long x_stride, int Lo, int k, int logn,
                    void* stream) {
  return abc_ks_mod_down_tail(x, out, tab, rows, x_stride, Lo, k, logn,
                              kNoTail, nullptr, 0, 0, nullptr, nullptr,
                              stream);
}

// The launch that abc_ks_<kernel> makes (kernel: 0 decompose, 1 contract,
// 2 mod_down, 3 and 4 mod_down with the relin and the rotate tail) for
// `lines` output rows of n = 2^logn (the product of every output axis but
// the last) and k special primes (mod_down), into info[6]: the
// instantiation's special primes (mod_down, else 0), 0, threads a
// block, blocks, and the kernel's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM.
// Returns the cudaError_t of the query.
int abc_ks_launch_info(int kernel, long long lines, int k, int logn,
                       long long* info) {
  if (logn < 2 || lines < 0 || k < 1 || k > kMaxSpecials) {
    return cudaErrorInvalidValue;
  }
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  const auto query = [&](auto kern) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0);
  };
  switch (kernel) {
    case 0: err = query(ks_decompose_kernel); break;
    case 1: err = query(ks_contract_kernel); break;
    case 2: err = by_specials(k, kNoTail, query); break;
    case 3: err = by_specials(k, kRelin, query); break;
    case 4: err = by_specials(k, kRotate, query); break;
    default: return cudaErrorInvalidValue;
  }
  const long long quads = (lines << logn) / 4;
  info[0] = kernel >= 2 ? specials_arg(k) : 0;
  info[1] = 0;
  info[2] = kThreads;
  info[3] = (quads + kThreads - 1) / kThreads;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
