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
// every leading axis. rns_uniform and ksk_compose take a thread per quad of
// 4 coefficients of one output row, rlwe_lift a thread per source quad and
// 1 or 2 of its limb rows, so that loads and stores are 16-byte accesses
// coalesced along n; bfv_dec_round splits a quad's limbs over lanes of a
// warp. Tables come by device pointer, never from __constant__ memory;
// bfv_dec_round stages its records in shared memory once a block.
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
// outputs and operands.
//
// rlwe_lift and bfv_dec_round do a few operations a word. Bytes bound them
// where a launch fills the card (the lift of B=64 ciphertexts and of the 19
// keys' errors: one pass over each operand); at one ciphertext (2 x 6
// rows of 8192, 13 limbs of 16384) a launch is bound by one DRAM round
// trip (about 1.9 us on an H100) and by what a thread does before and
// after it. So both split their indices in 32 bits, with shifts by logn and
// a multiply-and-shift (Div, rns_common.cuh), where 64-bit `/` and `%`
// called a division routine before the first load; the lift reads each
// small operand (the int8 word, the message quad) once for the limb rows
// of its thread and issues every load before the first add; the
// scale-and-round issues its limb quads before it stages the records in
// shared memory behind one barrier (not five scalar record loads a limb in
// every lane), reduces its sum mod t by a reciprocal (reduce64) where a
// 64-bit `%` called the remainder routine, and writes its flag itself, a
// word a block, with no memset before it: one kernel a call.

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

// threads an SM holds of a thread-a-quad kernel (few registers, no shared
// memory): a launch of fewer quads than SMs x kResident leaves the card
// under one wave
constexpr long long kResident = 2048;
// limb rows a thread of rlwe_lift takes where a thread a row would fill the
// card (lift_rows_arg). Measured on an H100 (PERF.md, K5c), in one call: 2
// and 4 within 1% of each other cold at B=64 (15.60, 15.70 us) and at the
// 19 keys' errors (76.77, 76.56), 2 faster warm (18.40 against 18.78,
// 78.46 against 78.87) with fewer registers; 1 slower there (82.7 against
// 78.2 at 2, in an earlier build)
constexpr int kLiftRows = 2;

struct LiftArgs {
  const int8_t* v;
  const uint32_t* base;
  const uint32_t* msg;
  const uint32_t* delta;
  const uint32_t* q;
  uint32_t* out;
  uint32_t quads;                               // rows groups n / 4 < 2^31
  Div groups;                                   // groups of G limb rows a row
  int R, logn;
};

// the 4 int8 coefficients of `packed` lifted mod q: v + (v < 0 ? q : 0)
__device__ __forceinline__ uint4 lift4(uint32_t packed, uint32_t q) {
  uint32_t x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = static_cast<int8_t>(packed >> (8 * k));
    x[k] = static_cast<uint32_t>(v) + (v < 0 ? q : 0u);
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(add_mod(a.x, b.x, q), add_mod(a.y, b.y, q),
                    add_mod(a.z, b.z, q), add_mod(a.w, b.w, q));
}

__device__ __forceinline__ uint4 mul4(uint4 a, uint32_t w, uint32_t wsh,
                                      uint32_t q) {
  return make_uint4(mul_const(a.x, w, wsh, q), mul_const(a.y, w, wsh, q),
                    mul_const(a.z, w, wsh, q), mul_const(a.w, w, wsh, q));
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
//
// A thread owns one source quad (4 int8 coefficients of row `row`) and G
// limb rows r0 .. r0 + G - 1 of it (fewer in the last group where G does
// not divide R): the int8 word and, on an even row of the Delta form, the
// message quad are loaded once for the G rows, then the G base quads and
// the G moduli (and Delta records), all before the first add; G 16-byte
// stores follow. Whether the row carries the message is its lowest bit.
template <int G>
__global__ void __launch_bounds__(kThreads)
rlwe_lift_kernel(const LiftArgs a) {
  const int qlog = a.logn - 2;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.quads) return;
  const uint32_t line = t >> qlog;              // row groups + group
  const uint32_t row = quot(line, a.groups);
  const int r0 = static_cast<int>(line - row * a.groups.d) * G;
  // G = 1: groups = R, so r0 < R
  const int here = G == 1 ? 1 : min(G, a.R - r0);
  const uint32_t c = (t & ((1u << qlog) - 1)) * 4;
  const bool with_msg = a.msg != nullptr && (row & 1u) == 0;
  const bool times_delta = with_msg && a.delta != nullptr;
  const uint32_t mrow = row >> 1;
  const uint32_t packed = static_cast<uint32_t>(
      __ldg(reinterpret_cast<const int*>(
          a.v + (static_cast<size_t>(row) << a.logn) + c)));
  uint4 mv[G], bv[G];
  uint32_t m[G], d[G], dsh[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= here) break;
    const int r = r0 + j;
    m[j] = ld(a.q + r);
    if (a.base != nullptr) {
      bv[j] = ld4(a.base + ((static_cast<size_t>(row) * a.R + r) << a.logn) +
                  c);
    }
    if (times_delta) {
      d[j] = ld(a.delta + 2 * r);
      dsh[j] = ld(a.delta + 2 * r + 1);
    } else if (with_msg) {
      mv[j] = ld4(a.msg + ((static_cast<size_t>(mrow) * a.R + r) << a.logn) +
                  c);
    }
  }
  if (times_delta) {
    mv[0] = ld4(a.msg + (static_cast<size_t>(mrow) << a.logn) + c);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= here) break;
    uint4 x = lift4(packed, m[j]);
    if (a.base != nullptr) x = add4(x, bv[j], m[j]);
    if (times_delta) {
      x = add4(x, mul4(mv[0], d[j], dsh[j], m[j]), m[j]);
    } else if (with_msg) {
      x = add4(x, mv[j], m[j]);
    }
    st4(a.out + ((static_cast<size_t>(row) * a.R + r0 + j) << a.logn) + c, x);
  }
}

// Limb rows a thread for a lift of `rows` source rows over R limbs of n =
// 2^logn on `sms` SMs: kLiftRows where a thread a quad of one output row
// would fill the card, else 1 (one ciphertext: a thread a row keeps the
// most threads in flight; measured at (8192, 6), 2 there read 2.28 us cold
// against 2.17, PERF.md).
int lift_rows_arg(long long rows, int R, int logn, int sms) {
  const long long quads = ((rows * R) << logn) / 4;
  return quads >= sms * kResident ? kLiftRows : 1;
}

// ------------------------------------------------------ BFV scale-and-round

// K5d. v: rows of [L, n], c(s) mod q in the coefficient domain; tab: per
// limb l the record (q_l, (q/q_l)^-1 mod q_l, its Shoup companion, f_hi,
// f_lo) with (f_hi, f_lo) = floor(t 2^64 / q_l). Per coefficient, y_l =
// v_l (q/q_l)^-1 mod q_l and the sum of y_l (f_hi 2^32 + f_lo) / 2^64 is
// carried exactly in units of 2^-32: `frac` its fractional part, `whole`
// its integer part. out: rows of [n], m = (whole + (frac >= 2^31)) mod t;
// flag: a word a block, 1 iff some coefficient of the block has |frac -
// 2^31| < kDecMargin (a coefficient this close to the rounding boundary
// that the host decides it exactly), else 0.
//
// The sum's bound: y_l f_hi < t 2^32, so each limb adds below t to `whole`
// and below 2^33 to `frac`; whole + (frac >> 32) + 1 <= L (t + 1), below
// 2^64 for any L and t < 2^31, and reduce64 by floor(2^64 / t) (the host
// passes it) is exact over all of it: its remainder is below 2t < 2^32.
//
// A quad's limbs are split over kDecLanes lanes of a warp (lane group g
// takes limbs g, g + kDecLanes, ...), a warp covering kDecQuads quads, and
// their partial sums meet through shuffles: first the groups beyond four
// into the first four, then half of the four coefficients' sums swapped,
// then one of the two left, so that group g < 4 ends with the whole sum of
// coefficient g and rounds it. Limbs come in chunks of kDecChunk: a lane
// loads its quads of the chunk into registers (kLaneLoads, all in flight),
// then the block stages the chunk's records in shared memory behind one
// barrier. The flag costs the block's last barrier (__syncthreads_or) and
// one store: no memset before the launch, no atomic.
//
// Measured on an H100 (PERF.md, K5d), cold, in one call: this split 2.01
// and 2.32 us at (8192, 6) and (16384, 13), against 2.06 and 2.79 for
// lanes that load five scalar records a limb, reduce by a 64-bit remainder
// and need a memset beside the launch; 16 lanes a quad 2.12 and 2.49; a
// block a tile of 128 coefficients (a thread each, its L terms summed from
// shared memory) 2.27 and 2.55, and that tile with its flag drawn by an
// atomic ticket (one word, zeroed again by the last block) 2.51 and 2.83.
constexpr int kDecRec = 5;
constexpr uint32_t kDecMargin = 4096;
constexpr int kDecLanes = 8;
constexpr int kDecQuads = 32 / kDecLanes;
constexpr int kLaneLoads = 4;
constexpr int kDecChunk = kDecLanes * kLaneLoads;
constexpr int kRecLoads = (kDecChunk * kDecRec + kThreads - 1) / kThreads;
static_assert(kDecLanes % 4 == 0 && kDecLanes <= 32,
              "four lane groups of a quad or more, a warp's lanes at most");

struct DecArgs {
  const uint32_t* v;
  const uint32_t* tab;                          // [L][kDecRec]
  uint32_t* out;
  uint32_t* flag;                               // a word a block
  uint32_t coeffs;                              // rows n < 2^31
  int L, logn;
  uint32_t t;
  uint64_t t_ratio;                             // floor(2^64 / t)
};

// one limb's term of a coefficient: y = x (q/q_l)^-1 mod q_l, then y f
// split into the running sums
__device__ __forceinline__ void dec_term(uint32_t x, const uint32_t* r,
                                         uint64_t& frac, uint64_t& whole) {
  const uint64_t y = mul_const(x, r[1], r[2], r[0]);
  const uint64_t p_hi = y * r[3];
  frac += (p_hi & 0xFFFFFFFFull) + ((y * r[4]) >> 32);
  whole += p_hi >> 32;
}

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
bfv_dec_round_kernel(const DecArgs a) {
  __shared__ uint32_t rec[kDecChunk * kDecRec];
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int g = lane / kDecQuads;
  const uint32_t quad = (t >> 5) * kDecQuads + lane % kDecQuads;
  const bool live = quad < a.coeffs / 4;
  const int qlog = a.logn - 2;
  const uint32_t line = live ? quad >> qlog : 0;
  const uint32_t c = live ? (quad & ((1u << qlog) - 1)) * 4 : 0;
  const uint32_t* in = a.v + ((static_cast<size_t>(line) * a.L) << a.logn) + c;
  uint64_t frac[4] = {0, 0, 0, 0}, whole[4] = {0, 0, 0, 0};
  for (int l0 = 0; l0 < a.L; l0 += kDecChunk) {
    const int lc = min(kDecChunk, a.L - l0);
    uint4 x[kLaneLoads];
#pragma unroll
    for (int i = 0; i < kLaneLoads; ++i) {
      const int l = g + i * kDecLanes;
      if (live && l < lc) {
        x[i] = ld4(in + (static_cast<size_t>(l0 + l) << a.logn));
      }
    }
    uint32_t word[kRecLoads];
#pragma unroll
    for (int s = 0; s < kRecLoads; ++s) {
      const int i = threadIdx.x + s * kThreads;
      if (i < kDecRec * lc) word[s] = ld(a.tab + kDecRec * l0 + i);
    }
    if (l0 > 0) __syncthreads();                // the last chunk's readers
#pragma unroll
    for (int s = 0; s < kRecLoads; ++s) {
      const int i = threadIdx.x + s * kThreads;
      if (i < kDecRec * lc) rec[i] = word[s];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLaneLoads; ++i) {
      const int l = g + i * kDecLanes;
      if (!live || l >= lc) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dec_term(lane_of(x[i], k), rec + kDecRec * l, frac[k], whole[k]);
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
  bool near = false;
  if (live && g < 4) {                          // coefficient g's sums
    constexpr uint32_t kHalf = 1u << 31;
    const uint32_t low = static_cast<uint32_t>(frac[0]);
    const bool up = low >= kHalf;
    near = (up ? low - kHalf : kHalf - low) < kDecMargin;
    a.out[(static_cast<size_t>(line) << a.logn) + c + g] =
        reduce64(whole[0] + (frac[0] >> 32) + up, a.t, a.t_ratio);
  }
  const int any = __syncthreads_or(near);
  if (threadIdx.x == 0) a.flag[blockIdx.x] = any ? 1u : 0u;
}

// bfv_dec_round_kernel's blocks for `coeffs` coefficients: a warp per
// kDecQuads quads
long long dec_blocks(long long coeffs) {
  const long long warps = (coeffs / 4 + kDecQuads - 1) / kDecQuads;
  return (warps * 32 + kThreads - 1) / kThreads;
}

template <typename Go>
cudaError_t by_lift_kernel(int G, Go go) {
  return G == kLiftRows ? go(rlwe_lift_kernel<kLiftRows>)
                        : go(rlwe_lift_kernel<1>);
}

// ------------------------------------------------------------- launching

// A launch of `threads` threads (a quad each, but bfv_dec_round's),
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

// floor(2^64 / t) for 2 <= t < 2^32
uint64_t ratio_of(uint32_t t) {
  const uint64_t r = ~0ull / t;
  return (t & (t - 1)) == 0 ? r + 1 : r;
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
// added to the even rows, q [R] -> out [rows, R, n]; rows R n / 4 < 2^31.
int abc_rlwe_lift(const void* v, const void* base, const void* msg,
                  const void* delta, const void* q, void* out, long long rows,
                  int R, int logn, void* stream) {
  if (logn < 2 || logn > 30 || rows < 0 || R < 1 ||
      (delta != nullptr && msg == nullptr) || rows >= (1LL << 31) ||
      ((rows * R) << logn) / 4 >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = lift_rows_arg(rows, R, logn, sms);
  LiftArgs a = {};
  a.v = static_cast<const int8_t*>(v);
  a.base = static_cast<const uint32_t*>(base);
  a.msg = static_cast<const uint32_t*>(msg);
  a.delta = static_cast<const uint32_t*>(delta);
  a.q = static_cast<const uint32_t*>(q);
  a.out = static_cast<uint32_t*>(out);
  const int groups = (R + G - 1) / G;
  a.quads = static_cast<uint32_t>(((rows * groups) << logn) / 4);
  a.groups = div_by(static_cast<uint32_t>(groups));
  a.R = R;
  a.logn = logn;
  return static_cast<int>(by_lift_kernel(G, [&](auto kernel) {
    return launch(kernel, a.quads, stream, a);
  }));
}

// K5d: v [rows, L, n], tab [L][5] (bfv_dec_round_kernel's records), 1 < t
// < 2^31 -> out [rows, n] and flag [flag_words] (flag_words the launch's
// blocks, ceil(rows n / 64): each written 0 or 1 by its block, the call
// flagged iff any is 1; no memset); rows n < 2^31.
int abc_bfv_dec_round(const void* v, const void* tab, void* out, void* flag,
                      long long flag_words, long long rows, int L, unsigned t,
                      int logn, void* stream) {
  if (logn < 2 || logn > 30 || rows < 0 || L < 1 || t < 2 ||
      t >= (1u << 31) || (rows << logn) >= (1LL << 31) ||
      flag_words != dec_blocks(rows << logn)) {
    return cudaErrorInvalidValue;
  }
  DecArgs a = {};
  a.v = static_cast<const uint32_t*>(v);
  a.tab = static_cast<const uint32_t*>(tab);
  a.out = static_cast<uint32_t*>(out);
  a.flag = static_cast<uint32_t*>(flag);
  a.coeffs = static_cast<uint32_t>(rows << logn);
  a.L = L;
  a.logn = logn;
  a.t = t;
  a.t_ratio = ratio_of(t);
  return static_cast<int>(launch(bfv_dec_round_kernel,
                                 dec_blocks(a.coeffs) * kThreads, stream, a));
}

// The launch that abc_<kernel> makes (kernel: 0 rns_uniform, 1
// ksk_compose, 2 rlwe_lift, 3 bfv_dec_round) for `rows` rows of R limbs of
// n = 2^logn (rns_uniform, ksk_compose: their output rows flattened, R
// their limbs; rlwe_lift: v's rows and the limbs it lifts to;
// bfv_dec_round: v's rows and L), into info[6]: rlwe_lift's limb rows a
// thread and groups a row (else 0, 0), threads a block, blocks, and the
// instantiation's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM.
// Returns the cudaError_t of the queries.
int abc_rlwe_plan(int kernel, long long rows, int R, int logn,
                  long long* info) {
  if (logn < 2 || rows < 0 || R < 1 || kernel < 0 || kernel > 3) {
    return cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto query = [&](auto kern) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0);
  };
  long long arg0 = 0, arg1 = 0, blocks = 0;
  switch (kernel) {
    case 0: err = query(rns_uniform_kernel); break;
    case 1: err = query(ksk_compose_kernel); break;
    case 2:
      arg0 = lift_rows_arg(rows, R, logn, sms);
      arg1 = (R + arg0 - 1) / arg0;
      err = by_lift_kernel(static_cast<int>(arg0), query);
      break;
    default:
      blocks = dec_blocks(rows << logn);
      err = query(bfv_dec_round_kernel);
  }
  if (kernel != 3) {
    const long long threads = ((rows * (kernel == 2 ? arg1 : R)) << logn) / 4;
    blocks = (threads + kThreads - 1) / kThreads;
  }
  info[0] = arg0;
  info[1] = arg1;
  info[2] = kThreads;
  info[3] = blocks;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
