// Key generation, encryption and decryption kernels for Hopper (sm_90a): K5
// of the port, the elementwise chains of abc_tpu_torch/crypto/rlwe.py,
// crypto/bfv.py and crypto/ckks.py around the NTTs and the contraction.
//
// On the TPU these chains were never Pallas kernels: the reference runs them
// under jax.jit and XLA fused each chain of the jx32 engine into TPU kernels
// of its own. Replaces:
//   rns_uniform    <- abc_tpu/crypto/prng.py:148 uniform_rns_jx_keys (with
//                     threefry2x32 :91): uniform RNS polynomials from
//                     Threefry-2x32 key words
//   ksk_compose    <- abc_tpu/crypto/bfv.py:1251 _ksk_batch_jit (every
//                     missing switching key of a call in one launch) and
//                     the pk_b of :1220 _keygen_dev_jit
//   rlwe_lift      <- bfv.py:1211 _lift_signed_u32 with the tail of :1288
//                     _enc_jit (c0 = ci0 + e0 + delta m, c1 = ci1 + e1)
//   bfv_dec_round  <- the tail of bfv.py:1311 _dec_jit: the fixed-point CRT
//                     scale-and-round to t with the boundary flag
//
// Data: row-major [rows, R, n] uint32 residues (the port stores them as
// int32; every modulus is below 2^30), n = 2^logn >= 4; `rows` flattens
// every leading axis. Every kernel but bfv_dec_round takes a thread per quad
// of 4 coefficients of one output row, so that loads and stores are 16-byte
// accesses coalesced along n; bfv_dec_round splits a quad's limbs over
// lanes of a warp. Tables come by device pointer, never from __constant__
// memory.
//
// Every word written is canonical and equal to the plain torch versions
// (abc_tpu_torch/ops/rlwe_kernels.py), which give the reference's words:
// residues are canonical, so the order of the modular steps is free.
//
// What bounds them on this card. rns_uniform and ksk_compose spend 20
// Threefry rounds (an add, a rotate and an xor each) and 5 key injections on
// every word they draw, about 72 integer operations, against 4 bytes
// written (ksk_compose: 8 written and 4 read). At an SM's issue rate of 128
// integer lanes a clock the cipher's operations bound rns_uniform and take
// three quarters of ksk_compose's time for its bytes, so a thread keeps its
// key words and its 4 counters in registers and touches memory only for its
// outputs and operands. rlwe_lift and bfv_dec_round do a few operations a
// word: bytes bound them, one pass over each operand.

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kParity = 0x1BD11BDAu;

// ------------------------------------------------------------------ Threefry

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

// One Threefry-2x32 block of 20 rounds: 5 groups of 4 with the rotations
// (13, 15, 26, 6) and (17, 29, 16, 24) in turn, the key injected after each
// group. (c0, c1) -> (y0, y1); y0 is the high word of a 64-bit draw.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  y0 = x0;
  y1 = x1;
}

// The uniform residue at counter (ctr, 0) of key (k0, k1): the 64-bit draw
// hi 2^32 + lo reduced exactly mod q (ratio = floor(2^64 / q)).
__device__ __forceinline__ uint32_t uniform_word(uint32_t k0, uint32_t k1,
                                                 uint32_t ctr, uint32_t q,
                                                 uint64_t ratio) {
  uint32_t hi, lo;
  threefry2x32(k0, k1, ctr, 0u, hi, lo);
  return reduce64((static_cast<uint64_t>(hi) << 32) | lo, q, ratio);
}

// The 4 uniform words of row `row` (key words keys[2 row], keys[2 row + 1])
// at column r and coefficients c .. c + 3: counters r n + c ...
__device__ __forceinline__ uint4 uniform_quad(const uint32_t* keys,
                                              long long row, int r, size_t c,
                                              uint32_t q, uint64_t ratio,
                                              int logn) {
  const uint32_t k0 = ld(keys + 2 * row), k1 = ld(keys + 2 * row + 1);
  const uint32_t ctr = (static_cast<uint32_t>(r) << logn) +
                       static_cast<uint32_t>(c);
  return make_uint4(uniform_word(k0, k1, ctr, q, ratio),
                    uniform_word(k0, k1, ctr + 1u, q, ratio),
                    uniform_word(k0, k1, ctr + 2u, q, ratio),
                    uniform_word(k0, k1, ctr + 3u, q, ratio));
}

// ------------------------------------------------------------ uniform draw

// K5a. keys: [rows][2] key words; out: rows of [R, n], row `row` column r
// the uniform residues mod q[r] at counters r n .. r n + n - 1.
__global__ void __launch_bounds__(kThreads)
rns_uniform_kernel(const uint32_t* __restrict__ keys,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ q,
                   const uint64_t* __restrict__ ratio, long long quads,
                   int R, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = row R + r
  const int r = static_cast<int>(at.line % R);
  const long long row = at.line / R;
  st4(out + (static_cast<size_t>(at.line) << logn) + at.c,
      uniform_quad(keys, row, r, at.c, ld(q + r), ld64(ratio + r), logn));
}

// ------------------------------------------------- switching-key composition

// K5b. A switching key's digit i toward a target secret: a uniform (drawn
// here from keys[2 (key A + i)], as rns_uniform draws it) and
// b = -(a s) - e + f_i target mod q_r, over R columns.
//   e: [K, A, R, n] the NTT-form errors; s: [R, n] the NTT-form secret;
//   fac: null (no target term: the public key), else [A][R] records
//        (f_i mod q_r, its Shoup companion), f_i = P W_i;
//   tgt[key]: -1 the target is s^2, p >= 0 it is s read at perm[p][x] (a
//        Galois automorphism in the NTT domain), read only with fac;
//   perm: [P, n] int64.
// out_b, out_a: [K, A, R, n].
__global__ void __launch_bounds__(kThreads)
ksk_compose_kernel(const uint32_t* __restrict__ keys,
                   const uint32_t* __restrict__ e,
                   const uint32_t* __restrict__ s,
                   const uint32_t* __restrict__ fac,
                   const int* __restrict__ tgt,
                   const long long* __restrict__ perm,
                   const uint32_t* __restrict__ q,
                   const uint64_t* __restrict__ ratio,
                   uint32_t* __restrict__ out_b, uint32_t* __restrict__ out_a,
                   long long quads, int A, int R, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = (key A + i) R + r
  const int r = static_cast<int>(at.line % R);
  const long long ki = at.line / R;
  const int i = static_cast<int>(ki % A);
  const long long key = ki / A;
  const uint32_t m = ld(q + r);
  const uint64_t ra = ld64(ratio + r);
  const size_t off = (static_cast<size_t>(at.line) << logn) + at.c;
  const uint32_t* srow = s + (static_cast<size_t>(r) << logn);
  const uint4 sv = ld4(srow + at.c);
  const uint4 ev = ld4(e + off);
  const uint4 av = uniform_quad(keys, ki, r, at.c, m, ra, logn);
  uint4 term = make_uint4(0u, 0u, 0u, 0u);
  if (fac != nullptr) {
    const uint32_t* rec = fac + 2 * (static_cast<size_t>(i) * R + r);
    const uint32_t f = ld(rec), fsh = ld(rec + 1);
    const int kind = __ldg(tgt + key);
    uint4 target;
    if (kind < 0) {
      target = make_uint4(
          mul_mod(sv.x, sv.x, m, ra), mul_mod(sv.y, sv.y, m, ra),
          mul_mod(sv.z, sv.z, m, ra), mul_mod(sv.w, sv.w, m, ra));
    } else {
      const long long* p =
          perm + (static_cast<size_t>(kind) << logn) + at.c;
      target = make_uint4(ld(srow + __ldg(p)), ld(srow + __ldg(p + 1)),
                          ld(srow + __ldg(p + 2)), ld(srow + __ldg(p + 3)));
    }
    term = make_uint4(mul_const(target.x, f, fsh, m),
                      mul_const(target.y, f, fsh, m),
                      mul_const(target.z, f, fsh, m),
                      mul_const(target.w, f, fsh, m));
  }
  uint4 bv;
  bv.x = sub_mod(sub_mod(term.x, mul_mod(av.x, sv.x, m, ra), m), ev.x, m);
  bv.y = sub_mod(sub_mod(term.y, mul_mod(av.y, sv.y, m, ra), m), ev.y, m);
  bv.z = sub_mod(sub_mod(term.z, mul_mod(av.z, sv.z, m, ra), m), ev.z, m);
  bv.w = sub_mod(sub_mod(term.w, mul_mod(av.w, sv.w, m, ra), m), ev.w, m);
  st4(out_a + off, av);
  st4(out_b + off, bv);
}

// -------------------------------------------- signed lift, encryption's adds

__device__ __forceinline__ uint32_t lift_signed(int v, uint32_t q) {
  return v >= 0 ? static_cast<uint32_t>(v) : q - static_cast<uint32_t>(-v);
}

// K5c. out[row, r, x] = (base[row, r, x] + lift_r(v[row, x]) + msg) mod q_r:
//   v: [rows, n] int8 small signed coefficients (|v| < q_r);
//   base: [rows, R, n] residues or null;
//   msg: null, or added to the even rows (c0 of each ciphertext of
//        [B, 2, ...]) as message row mrow = row / 2: with delta ([R]
//        records (delta_r, its Shoup companion)) msg is [(rows + 1) / 2, n]
//        plaintext coefficients and adds msg[mrow, x] delta_r mod q_r, else
//        msg is [(rows + 1) / 2, R, n] residues and adds msg[mrow, r, x].
// out: [rows, R, n].
__global__ void __launch_bounds__(kThreads)
rlwe_lift_kernel(const int8_t* __restrict__ v,
                 const uint32_t* __restrict__ base,
                 const uint32_t* __restrict__ msg,
                 const uint32_t* __restrict__ delta,
                 const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                 long long quads, int R, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = row R + r
  const int r = static_cast<int>(at.line % R);
  const long long row = at.line / R;
  const uint32_t m = ld(q + r);
  const uint32_t packed = static_cast<uint32_t>(__ldg(
      reinterpret_cast<const int*>(v + (static_cast<size_t>(row) << logn) +
                                   at.c)));
  uint32_t x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = lift_signed(static_cast<int8_t>(packed >> (8 * k)), m);
  }
  const size_t off = (static_cast<size_t>(at.line) << logn) + at.c;
  if (base != nullptr) {
    const uint4 b = ld4(base + off);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = add_mod(x[k], lane_of(b, k), m);
  }
  if (msg != nullptr && row % 2 == 0) {
    const long long mrow = row / 2;
    if (delta != nullptr) {
      const uint32_t d = ld(delta + 2 * r), dsh = ld(delta + 2 * r + 1);
      const uint4 mv = ld4(msg + (static_cast<size_t>(mrow) << logn) + at.c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = add_mod(x[k], mul_const(lane_of(mv, k), d, dsh, m), m);
      }
    } else {
      const uint4 mv = ld4(
          msg + (static_cast<size_t>(mrow * R + r) << logn) + at.c);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = add_mod(x[k], lane_of(mv, k), m);
    }
  }
  st4(out + off, make_uint4(x[0], x[1], x[2], x[3]));
}

// ------------------------------------------------------ BFV scale-and-round

// K5d. v: rows of [L, n], c(s) mod q in the coefficient domain; tab: per
// limb l the record (q_l, (q/q_l)^-1 mod q_l, its Shoup companion, f_hi,
// f_lo) with (f_hi, f_lo) = floor(t 2^64 / q_l). Per coefficient, y_l =
// v_l (q/q_l)^-1 mod q_l and the sum of y_l (f_hi 2^32 + f_lo) / 2^64 is
// carried exactly in units of 2^-32: `frac` its fractional part, `whole`
// its integer part. out: rows of [n], m = (whole + (frac >= 2^31)) mod t;
// *flag is set to 1 where |frac - 2^31| < 4096, a coefficient this close
// to the rounding boundary that the host decides it exactly.
//
// A quad's limbs are split over kDecLanes lanes of a warp (lane group g
// takes limbs g, g + kDecLanes, ...), and their partial sums meet through
// shuffles: one ciphertext has too few quads to fill the card, and a thread
// that walks all L limbs waits on a DRAM round trip every few limbs. A warp
// covers kDecQuads quads: the lanes of one group load kDecQuads
// consecutive quads of a limb row. The sums meet by halves: the lanes of a
// quad first add their groups' sums beyond four, then swap half of the
// four coefficients' sums, then one of the two left, so that group g ends
// with the whole sum of coefficient g % 4 and rounds it.
constexpr int kDecLanes = 8;
constexpr int kDecQuads = 32 / kDecLanes;
static_assert(kDecLanes % 4 == 0 && kDecLanes <= 32,
              "four lane groups of a quad or more, a warp's lanes at most");

// the sums (frac, whole) of coefficient `hi ? b : a` kept, and those of the
// other swapped with the lane `off` away
__device__ __forceinline__ void keep_one(uint64_t& fa, uint64_t& wa,
                                         uint64_t fb, uint64_t wb, bool hi,
                                         int off) {
  const uint64_t send_f = hi ? fa : fb, send_w = hi ? wa : wb;
  fa = (hi ? fb : fa) + __shfl_xor_sync(0xFFFFFFFFu, send_f, off);
  wa = (hi ? wb : wa) + __shfl_xor_sync(0xFFFFFFFFu, send_w, off);
}

__global__ void __launch_bounds__(kThreads)
bfv_dec_round_kernel(const uint32_t* __restrict__ v,
                     const uint32_t* __restrict__ tab,
                     uint32_t* __restrict__ out, uint32_t* __restrict__ flag,
                     long long quads, int L, uint32_t t_mod, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int g = lane / kDecQuads;
  const long long quad = (t >> 5) * kDecQuads + lane % kDecQuads;
  const bool live = quad < quads;
  const At at = at_of(live ? quad : 0, logn);   // line = row
  const uint32_t* in =
      v + (static_cast<size_t>(at.line) * L << logn) + at.c;
  uint64_t frac[4] = {0, 0, 0, 0}, whole[4] = {0, 0, 0, 0};
  if (live) {
    // up to four of the group's limbs' loads in flight at once
#pragma unroll 4
    for (int l = g; l < L; l += kDecLanes) {
      const uint32_t* rec = tab + 5 * l;
      const uint32_t m = ld(rec), w = ld(rec + 1), wsh = ld(rec + 2),
                     f_hi = ld(rec + 3), f_lo = ld(rec + 4);
      const uint4 x = ld4(in + (static_cast<size_t>(l) << logn));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t y = mul_const(lane_of(x, k), w, wsh, m);
        const uint64_t p_hi = y * f_hi;
        frac[k] += (p_hi & 0xFFFFFFFFull) + ((y * f_lo) >> 32);
        whole[k] += p_hi >> 32;
      }
    }
  }
  // every lane of the warp takes part; the sums are exact, so their order
  // is free
#pragma unroll
  for (int off = 4 * kDecQuads; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      frac[k] += __shfl_xor_sync(0xFFFFFFFFu, frac[k], off);
      whole[k] += __shfl_xor_sync(0xFFFFFFFFu, whole[k], off);
    }
  }
  const bool hi2 = g & 2, hi1 = g & 1;
  keep_one(frac[0], whole[0], frac[2], whole[2], hi2, 2 * kDecQuads);
  keep_one(frac[1], whole[1], frac[3], whole[3], hi2, 2 * kDecQuads);
  keep_one(frac[0], whole[0], frac[1], whole[1], hi1, kDecQuads);
  if (!live || g >= 4) return;
  const uint64_t fr = frac[0], wh = whole[0];   // coefficient g's
  constexpr uint32_t kHalf = 1u << 31;
  const uint32_t low = static_cast<uint32_t>(fr);
  const bool up = low >= kHalf;
  if ((up ? low - kHalf : kHalf - low) < 4096u) *flag = 1u;
  out[(static_cast<size_t>(at.line) << logn) + at.c + g] =
      static_cast<uint32_t>((wh + (fr >> 32) + up) % t_mod);
}

// bfv_dec_round_kernel's threads for `quads` quads: a warp per kDecQuads
long long dec_round_threads(long long quads) {
  return (quads + kDecQuads - 1) / kDecQuads * 32;
}

// ------------------------------------------------------------- launching

// A launch of `threads` threads (a quad each, but bfv_dec_round_kernel's),
// kThreads a block.
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

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t; n = 2^logn
// (logn >= 2). Each returns the cudaError_t of its launch (0 on success); a
// shape the kernel does not take returns cudaErrorInvalidValue. Every
// operand takes 16-byte aligned rows (the int8 v of abc_rlwe_lift: 4-byte).

// K5a: keys [rows][2] uint32 -> out [rows, R, n], q [R] uint32 and ratio
// [R] uint64 the moduli; R n <= 2^32 (the counters are 32-bit).
int abc_rns_uniform(const void* keys, void* out, const void* q,
                    const void* ratio, long long rows, int R, int logn,
                    void* stream) {
  if (logn < 2 || rows < 0 || R < 1 ||
      (static_cast<long long>(R) << logn) > (1LL << 32)) {
    return cudaErrorInvalidValue;
  }
  const long long quads = ((rows * R) << logn) / 4;
  return static_cast<int>(launch(
      rns_uniform_kernel, quads, stream, static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(q),
      static_cast<const uint64_t*>(ratio), quads, R, logn));
}

// K5b: keys [K A][2], e [K, A, R, n], s [R, n], fac [A][R][2] or null, tgt
// [K] int32 and perm [P, n] int64 (read only with fac; perm may be null
// where no tgt is >= 0), q [R], ratio [R] -> out_b, out_a [K, A, R, n].
int abc_ksk_compose(const void* keys, const void* e, const void* s,
                    const void* fac, const void* tgt, const void* perm,
                    const void* q, const void* ratio, void* out_b,
                    void* out_a, long long K, int A, int R, int logn,
                    void* stream) {
  if (logn < 2 || K < 0 || A < 1 || R < 1 ||
      (fac != nullptr && tgt == nullptr) ||
      (static_cast<long long>(R) << logn) > (1LL << 32)) {
    return cudaErrorInvalidValue;
  }
  const long long quads = ((K * A * R) << logn) / 4;
  return static_cast<int>(launch(
      ksk_compose_kernel, quads, stream, static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(e), static_cast<const uint32_t*>(s),
      static_cast<const uint32_t*>(fac), static_cast<const int*>(tgt),
      static_cast<const long long*>(perm), static_cast<const uint32_t*>(q),
      static_cast<const uint64_t*>(ratio), static_cast<uint32_t*>(out_b),
      static_cast<uint32_t*>(out_a), quads, A, R, logn));
}

// K5c: v [rows, n] int8, base [rows, R, n] or null, msg null or (delta
// [R][2] given) [(rows + 1) / 2, n] or (delta null) [(rows + 1) / 2, R, n],
// added to the even rows, q [R] -> out [rows, R, n].
int abc_rlwe_lift(const void* v, const void* base, const void* msg,
                  const void* delta, const void* q, void* out, long long rows,
                  int R, int logn, void* stream) {
  if (logn < 2 || rows < 0 || R < 1 ||
      (delta != nullptr && msg == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long quads = ((rows * R) << logn) / 4;
  return static_cast<int>(launch(
      rlwe_lift_kernel, quads, stream, static_cast<const int8_t*>(v),
      static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(msg),
      static_cast<const uint32_t*>(delta), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(out), quads, R, logn));
}

// K5d: v [rows, L, n], tab [L][5] (bfv_dec_round_kernel), 1 < t < 2^31 ->
// out [rows, n] and flag [1] (zeroed on the stream first, then set to 1 by
// any coefficient at the boundary).
int abc_bfv_dec_round(const void* v, const void* tab, void* out, void* flag,
                      long long rows, int L, unsigned t, int logn,
                      void* stream) {
  if (logn < 2 || rows < 0 || L < 1 || t < 2 || t >= (1u << 31)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(uint32_t),
                                          static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (rows << logn) / 4;
  return static_cast<int>(launch(
      bfv_dec_round_kernel, dec_round_threads(quads), stream,
      static_cast<const uint32_t*>(v), static_cast<const uint32_t*>(tab),
      static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(flag), quads, L, static_cast<uint32_t>(t),
      logn));
}

// The launch that abc_<kernel> makes (kernel: 0 rns_uniform, 1
// ksk_compose, 2 rlwe_lift, 3 bfv_dec_round) for `lines` output rows of n =
// 2^logn (the product of every output axis but the last), into info[6]:
// 0, 0, threads a block, blocks, and the kernel's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM.
// Returns the cudaError_t of the query.
int abc_rlwe_launch_info(int kernel, long long lines, int logn,
                         long long* info) {
  if (logn < 2 || lines < 0) return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  const auto query = [&](auto kern) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0);
  };
  switch (kernel) {
    case 0: err = query(rns_uniform_kernel); break;
    case 1: err = query(ksk_compose_kernel); break;
    case 2: err = query(rlwe_lift_kernel); break;
    case 3: err = query(bfv_dec_round_kernel); break;
    default: return cudaErrorInvalidValue;
  }
  const long long quads = (lines << logn) / 4;
  const long long threads = kernel == 3 ? dec_round_threads(quads) : quads;
  info[0] = 0;
  info[1] = 0;
  info[2] = kThreads;
  info[3] = (threads + kThreads - 1) / kThreads;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
