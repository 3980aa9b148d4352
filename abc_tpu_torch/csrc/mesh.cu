// Mesh kernels for Hopper (sm_90a): K8 of the port, the arithmetic of the
// mesh paths in abc_tpu_torch/parallel/ that no other kernel of the port
// computes.
//
// On the TPU these were never Pallas kernels: the reference runs its mesh
// bodies under shard_map and jax.jit, and XLA fused each jx32 chain
// (abc_tpu/ops/modarith.py) into TPU kernels of its own. Replaces:
//   dist_ntt_combine <- the butterfly combine after each exchange of the
//                       distributed NTT: DistNttContext.fwd_local
//                       (abc_tpu/parallel/dist_ntt.py:171, combine
//                       :189-192) and inv_local (:208, combine :223-226),
//                       with inv_local's n^-1 scale (:237) folded into the
//                       last stage
//   rns_psum_mod     <- the modular psum of the limb-sharded key switch,
//                       abc_tpu/parallel/sharding.py:85 _psum_mod: the sum
//                       over a shard axis mod q (LocalComm), or the
//                       reduction mod q of the int64 words an all_reduce
//                       summed (DistComm)
//
// Data: residues are uint32 below 2^30 (the port stores them as int32),
// read and written four coefficients at a time with one 16-byte access.
// An operand is [rows, D, L, cols]: `rows` flattens the leading axes (a
// batch, the ciphertext components, a key's digits), D is the mesh's shard
// axis (the shards this process holds: all of them under LocalComm, one on
// a rank), L the limbs, cols the coefficients of a shard (cols = 2^logc >=
// 4). Each operand is read or written where it lies (struct View: the
// words between rows, shards and limbs), so that mesh.scatter's views, a
// chunk of a shard's columns and a shard axis moved behind the rows need no
// copy.
//
// What bounds them on this card: at the mesh paths' shapes (one
// polynomial of [8, 8, 4096], a half of a key switch's accumulators) a
// launch is one DRAM round trip (about 1.9 us on an H100) and what a thread
// does before and after it; only the CKKS op's digit combine (2.4 M words)
// is bound by its bytes. So every index is split in 32 bits, by shifts and
// a multiply and a shift (Div, rns_common.cuh), where 64-bit `/` and `%`
// called the division routine before the first load; every load of a
// thread, tables included, is issued before its first arithmetic (the
// psum's shards unrolled, so that its D loads are one round trip, not D);
// the combine under LocalComm takes a butterfly pair a thread (both
// shards' quads read once, the pair's one Shoup product made once, both
// outputs written); the rank form of the psum reduces its int64 words by a
// reciprocal (reduce64), not the 64-bit remainder routine. Splitting a
// psum's shards over 2-8 lanes of a warp, their sums met by shuffles, was
// measured and lost to a thread a quad at every shape (PERF.md, K8c).
//
// Every word written is canonical in [0, q) and equal to the plain torch
// versions (abc_tpu_torch/ops/mesh_kernels.py, the t64 chains the mesh
// paths ran before): a sum is one conditional subtract, a difference one
// conditional add, a product with a twiddle a Shoup product (mul_const).

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kThreads = 128;
// threads an SM holds of these kernels (few registers, no shared memory): a
// launch of fewer threads than SMs x kResident leaves the card under one
// wave
constexpr long long kResident = 2048;
// butterfly pairs a thread of the LocalComm combine where a thread a pair
// fills the card (combine_pairs_arg)
constexpr int kCombinePairs = 2;
// the shards a thread of the psum loads before its first add past its
// unrolled forms
constexpr int kPsumChunk = 8;

// An operand [rows, D, L, cols] at its strides in words; its coefficients
// are consecutive.
struct View {
  const uint32_t* p;
  long long row, shard, limb;
};

__device__ __forceinline__ size_t at(const View& v, uint32_t r, int d,
                                     int l) {
  return static_cast<size_t>(r * v.row + d * v.shard + l * v.limb);
}

// ---------------------------------------------------------------- combine

struct CombineArgs {
  View x, p, o;
  const uint32_t* w;       // [*, L] the twiddles, tw_shard words a shard
  const uint32_t* wsh;     // their Shoup companions
  const uint32_t* uw;      // [L] n^-1 for the inverse's u side, or null
  const uint32_t* uwsh;
  const uint32_t* q;       // [L]
  long long tw_shard;
  uint32_t items;          // pair quads (LocalComm) or quads (a rank)
  Div limbs;               // L
  Div pairs;               // D / 2, the pairs of a row (LocalComm)
  int d0, t_sh, log_t, qlog;
};

// One exchange stage of the distributed NTT over the partner pairs d <->
// d ^ t_sh of the mesh axis, every shard in this process (LocalComm: the
// exchange is the reading of the partner in place). A thread takes U pair
// quads kThreads apart: pair h of a row is shards du (bit t_sh clear) and
// dv = du | t_sh, both read once, the twiddle w[du] of the pair (both
// shards' tables hold it: DistNttContext checks) with its companion, q and
// n^-1 issued with them. Then
//   forward: out[du] = x_u + w x_v, out[dv] = x_u - w x_v (one product);
//   inverse: out[du] = (x_u + x_v) [n^-1 where uw is given: the last
//            stage], out[dv] = (x_u - x_v) w (w n^-1 in the last stage).
template <bool Inverse, int U>
__global__ void __launch_bounds__(kThreads)
dist_ntt_combine_pair_kernel(const CombineArgs a) {
  const uint32_t mask = (1u << a.qlog) - 1;
  bool live[U];
  uint32_t r[U], c[U], m[U], tw[U], twsh[U], u[U], ush[U];
  int du[U], l[U];
  uint4 xu[U], xv[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const uint32_t i = (blockIdx.x * U + j) * kThreads + threadIdx.x;
    live[j] = i < a.items;
    if (!live[j]) break;
    const uint32_t line = i >> a.qlog;            // (r pairs + h) L + l
    c[j] = (i & mask) * 4;
    const uint32_t rh = quot(line, a.limbs);
    l[j] = static_cast<int>(line - rh * a.limbs.d);
    r[j] = quot(rh, a.pairs);
    const uint32_t h = rh - r[j] * a.pairs.d;
    du[j] = static_cast<int>(((h >> a.log_t) << (a.log_t + 1)) |
                             (h & (a.t_sh - 1)));
    const size_t tab = static_cast<size_t>(du[j] * a.tw_shard + l[j]);
    m[j] = ld(a.q + l[j]);
    tw[j] = ld(a.w + tab);
    twsh[j] = ld(a.wsh + tab);
    if (Inverse && a.uw != nullptr) {
      u[j] = ld(a.uw + l[j]);
      ush[j] = ld(a.uwsh + l[j]);
    }
    xu[j] = ld4(a.x.p + at(a.x, r[j], du[j], l[j]) + c[j]);
    xv[j] = ld4(a.x.p + at(a.x, r[j], du[j] | a.t_sh, l[j]) + c[j]);
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (!live[j]) break;
    uint32_t ou[4], ov[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t s = lane_of(xu[j], e), t = lane_of(xv[j], e);
      if (Inverse) {
        const uint32_t sum = add_mod(s, t, m[j]);
        ou[e] = a.uw != nullptr ? mul_const(sum, u[j], ush[j], m[j]) : sum;
        ov[e] = mul_const(sub_mod(s, t, m[j]), tw[j], twsh[j], m[j]);
      } else {
        const uint32_t wt = mul_const(t, tw[j], twsh[j], m[j]);
        ou[e] = add_mod(s, wt, m[j]);
        ov[e] = sub_mod(s, wt, m[j]);
      }
    }
    uint32_t* o = const_cast<uint32_t*>(a.o.p) + c[j];
    st4(o + at(a.o, r[j], du[j], l[j]),
        make_uint4(ou[0], ou[1], ou[2], ou[3]));
    st4(o + at(a.o, r[j], du[j] | a.t_sh, l[j]),
        make_uint4(ov[0], ov[1], ov[2], ov[3]));
  }
}

// The same stage on a rank: one shard at position d0 and p, the block it
// received from its partner; the shard is the pair's u side where bit t_sh
// of d0 is clear, and a launch writes that side only (a thread a quad):
//   forward: u side x + w p, v side p - w x;
//   inverse: u side x + p [times n^-1 where uw is given], v side (p - x) w.
template <bool Inverse>
__global__ void __launch_bounds__(kThreads)
dist_ntt_combine_rank_kernel(const CombineArgs a) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.items) return;
  const uint32_t line = i >> a.qlog;              // r L + l
  const uint32_t c = (i & ((1u << a.qlog) - 1)) * 4;
  const uint32_t r = quot(line, a.limbs);
  const int l = static_cast<int>(line - r * a.limbs.d);
  const bool is_u = (a.d0 & a.t_sh) == 0;
  const uint32_t m = ld(a.q + l);
  const uint32_t tw = ld(a.w + l), twsh = ld(a.wsh + l);
  uint32_t u = 0, ush = 0;
  if (Inverse && is_u && a.uw != nullptr) {
    u = ld(a.uw + l);
    ush = ld(a.uwsh + l);
  }
  const uint4 xv = ld4(a.x.p + at(a.x, r, 0, l) + c);
  const uint4 pv = ld4(a.p.p + at(a.p, r, 0, l) + c);
  uint32_t res[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t s = lane_of(xv, e), t = lane_of(pv, e);
    if (Inverse) {
      if (is_u) {
        const uint32_t sum = add_mod(s, t, m);
        res[e] = a.uw != nullptr ? mul_const(sum, u, ush, m) : sum;
      } else {
        res[e] = mul_const(sub_mod(t, s, m), tw, twsh, m);
      }
    } else if (is_u) {
      res[e] = add_mod(s, mul_const(t, tw, twsh, m), m);
    } else {
      res[e] = sub_mod(t, mul_const(s, tw, twsh, m), m);
    }
  }
  st4(const_cast<uint32_t*>(a.o.p) + at(a.o, r, 0, l) + c,
      make_uint4(res[0], res[1], res[2], res[3]));
}

// --------------------------------------------------------------------- psum

struct PsumArgs {
  View x;                  // uint32 residues, or (wide) uint64 words
  View o;
  const uint32_t* q;       // [L]
  const uint64_t* ratio;   // [L] floor(2^64 / q) (wide), or null
  uint32_t quads;          // output quads, rows L n / 4 < 2^31
  Div limbs;               // L
  int D, qlog;
};

__device__ __forceinline__ void add4(uint32_t* acc, const uint4& v,
                                     uint32_t m) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = add_mod(acc[e], lane_of(v, e), m);
}

// out [rows, L, n] = sum over the D shards of x [rows, D, L, n] mod q[l],
// by modular adds (a running value below q, so no sum leaves 32 bits
// however many shards), a thread a quad: M shards loaded before the first
// add (M = 1, 2, 4 or 8, the fewest that cover D; M = 0: past 8, in chunks
// of kPsumChunk).
template <int M>
__global__ void __launch_bounds__(kThreads)
rns_psum_mod_kernel(const PsumArgs a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.quads) return;
  const uint32_t line = t >> a.qlog;              // r L + l
  const uint32_t c = (t & ((1u << a.qlog) - 1)) * 4;
  const uint32_t r = quot(line, a.limbs);
  const int l = static_cast<int>(line - r * a.limbs.d);
  const uint32_t m = ld(a.q + l);
  const uint32_t* src = a.x.p + at(a.x, r, 0, l) + c;
  uint32_t acc[4] = {0, 0, 0, 0};
  constexpr int K = M > 0 ? M : kPsumChunk;
  for (int d0 = 0; d0 < a.D; d0 += K) {
    uint4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k < a.D) v[k] = ld4(src + (d0 + k) * a.x.shard);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k < a.D) add4(acc, v[k], m);
    }
    if (M > 0) break;                             // M covers D
  }
  st4(const_cast<uint32_t*>(a.o.p) + at(a.o, r, 0, l) + c,
      make_uint4(acc[0], acc[1], acc[2], acc[3]));
}

// The rank form: out [rows, L, n] = x mod q[l] for uint64 words x [rows, L,
// n] (the sums an all_reduce made, each below 2^63), a thread a quad: its
// four words by two 16-byte loads, each reduced by reduce64 with ratio[l].
__global__ void __launch_bounds__(kThreads)
rns_psum_mod_wide_kernel(const PsumArgs a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.quads) return;
  const uint32_t line = t >> a.qlog;
  const uint32_t c = (t & ((1u << a.qlog) - 1)) * 4;
  const uint32_t r = quot(line, a.limbs);
  const int l = static_cast<int>(line - r * a.limbs.d);
  const uint32_t m = ld(a.q + l);
  const uint64_t ra = ld64(a.ratio + l);
  // the View's strides count 8-byte words: two uint32 words each
  const uint32_t* src = a.x.p + 2 * (at(a.x, r, 0, l) + c);
  const uint4 lo = ld4(src), hi = ld4(src + 4);
  const auto word = [](uint32_t low, uint32_t high) {
    return (static_cast<uint64_t>(high) << 32) | low;
  };
  st4(const_cast<uint32_t*>(a.o.p) + at(a.o, r, 0, l) + c,
      make_uint4(reduce64(word(lo.x, lo.y), m, ra),
                 reduce64(word(lo.z, lo.w), m, ra),
                 reduce64(word(hi.x, hi.y), m, ra),
                 reduce64(word(hi.z, hi.w), m, ra)));
}

// ----------------------------------------------------------------- planning

// pair quads a thread of the LocalComm combine: kCombinePairs where a
// thread a pair fills the card, else 1
int combine_pairs_arg(long long pairs, int sms) {
  return pairs >= sms * kResident ? kCombinePairs : 1;
}

// shards a thread of the psum loads before its first add: the fewest of 1,
// 2, 4 and 8 that cover D, else 0 (chunks of kPsumChunk)
int psum_shards_arg(int D) {
  return D <= 1 ? 1 : D <= 2 ? 2 : D <= 4 ? 4 : D <= 8 ? 8 : 0;
}

template <bool Inverse, typename Go>
cudaError_t by_pairs(int U, Go go) {
  return U == 2 ? go(dist_ntt_combine_pair_kernel<Inverse, 2>)
                : go(dist_ntt_combine_pair_kernel<Inverse, 1>);
}

template <typename Go>
cudaError_t by_shards(int M, Go go) {
  switch (M) {
    case 1: return go(rns_psum_mod_kernel<1>);
    case 2: return go(rns_psum_mod_kernel<2>);
    case 4: return go(rns_psum_mod_kernel<4>);
    case 8: return go(rns_psum_mod_kernel<8>);
    default: return go(rns_psum_mod_kernel<0>);
  }
}

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

// a uint32 operand: 16-byte aligned, its rows, shards and limbs whole quads
// apart
bool view_ok(const void* p, long long row, long long shard, long long limb) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         row >= 0 && shard >= 0 && limb >= 0 && row % 4 == 0 &&
         shard % 4 == 0 && limb % 4 == 0;
}

constexpr long long kIndexLimit = 1LL << 31;

// The launch of one kernel kind (0 the LocalComm combine, 1 a rank's
// combine, 2 the psum of uint32 residues over D shards, 3 the rank form of
// the psum) over rows of [D, L, 2^logc]: its template arguments (arg[0]:
// the combine's pairs a thread, else 1; arg[1]: the psum's shards a thread
// loads before its first add, 0 for chunks) and threads. The work items must stay below
// 2^31 (the quads of x for a combine, of the output for a psum), and the
// LocalComm combine needs an even D; else cudaErrorInvalidValue.
struct Plan {
  int arg[2];
  long long threads;
};

cudaError_t plan_of(int kind, long long rows, int D, int L, int logc,
                    Plan* plan) {
  if (kind < 0 || kind > 3 || logc < 2 || logc > 30 || rows < 0 || D < 1 ||
      L < 1 || (kind == 0 && D % 2 != 0) || (kind != 0 && kind != 2 && D != 1)) {
    return cudaErrorInvalidValue;
  }
  const long long lines = rows * (kind == 2 ? 1 : D) * L;
  if (rows >= kIndexLimit || lines >= kIndexLimit ||
      (lines << logc) / 4 >= kIndexLimit) {
    return cudaErrorInvalidValue;
  }
  const long long quads = (lines << logc) / 4;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  plan->arg[0] = 1;
  plan->arg[1] = 0;
  plan->threads = quads;
  if (kind == 0) {
    const long long pairs = quads / 2;
    const int U = combine_pairs_arg(pairs, sms);
    plan->arg[0] = U;
    plan->threads = (pairs + U * kThreads - 1) / (U * kThreads) * kThreads;
  } else if (kind == 2) {
    plan->arg[1] = psum_shards_arg(D);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K8a: one exchange stage's combine of the distributed NTT (the kernels
// above), out [rows, D, L, 2^logc]. x, p and out as struct View reads them
// (pointer, then the words between rows, shards and limbs). pxor t_sh: the
// LocalComm form, every shard of the axis in x (D even, d0 a multiple of 2
// t_sh; p unread); pxor 0: a rank's form, one shard (D = 1) at position d0
// and its partner's block p. t_sh a power of two; w and wsh [*, L] uint32
// with tw_shard words between shards; uw and uwsh [L] or null (inverse
// only); q [L] uint32; the quads of x below 2^31. All pointers are device
// pointers but null ones; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success); a shape the kernel does not
// take returns cudaErrorInvalidValue.
int abc_dist_ntt_combine(int inverse, const void* x, long long x_row,
                         long long x_shard, long long x_limb, const void* p,
                         long long p_row, long long p_shard, long long p_limb,
                         int pxor, void* out, long long o_row,
                         long long o_shard, long long o_limb, const void* w,
                         const void* wsh, long long tw_shard, const void* uw,
                         const void* uwsh, const void* q, long long rows,
                         int D, int L, int d0, int t_sh, int logc,
                         void* stream) {
  const bool local = pxor != 0;
  if (d0 < 0 || t_sh < 1 || (t_sh & (t_sh - 1)) != 0 ||
      (local && (pxor != t_sh || D % (2 * t_sh) != 0 ||
                 d0 % (2 * t_sh) != 0)) ||
      tw_shard < 0 || w == nullptr || wsh == nullptr || q == nullptr ||
      (uw == nullptr) != (uwsh == nullptr) || (uw != nullptr && !inverse) ||
      !view_ok(x, x_row, x_shard, x_limb) ||
      (!local && !view_ok(p, p_row, p_shard, p_limb)) ||
      !view_ok(out, o_row, o_shard, o_limb)) {
    return cudaErrorInvalidValue;
  }
  Plan plan = {};
  const cudaError_t err = plan_of(local ? 0 : 1, rows, D, L, logc, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  CombineArgs a = {};
  a.x = {static_cast<const uint32_t*>(x), x_row, x_shard, x_limb};
  a.p = {static_cast<const uint32_t*>(p), p_row, p_shard, p_limb};
  a.o = {static_cast<const uint32_t*>(out), o_row, o_shard, o_limb};
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.uw = static_cast<const uint32_t*>(uw);
  a.uwsh = static_cast<const uint32_t*>(uwsh);
  a.q = static_cast<const uint32_t*>(q);
  a.tw_shard = tw_shard;
  const long long quads = ((rows * D * L) << logc) / 4;
  a.items = static_cast<uint32_t>(local ? quads / 2 : quads);
  a.limbs = div_by(static_cast<uint32_t>(L));
  a.pairs = div_by(static_cast<uint32_t>(local ? D / 2 : 1));
  a.d0 = d0;
  a.t_sh = t_sh;
  a.log_t = __builtin_ctz(static_cast<unsigned>(t_sh));
  a.qlog = logc - 2;
  const auto go = [&](auto kernel) {
    return launch(kernel, plan.threads, stream, a);
  };
  if (!local) {
    return static_cast<int>(inverse ? go(dist_ntt_combine_rank_kernel<true>)
                                    : go(dist_ntt_combine_rank_kernel<false>));
  }
  return static_cast<int>(inverse ? by_pairs<true>(plan.arg[0], go)
                                  : by_pairs<false>(plan.arg[0], go));
}

// K8c: out [rows, L, 2^logn] = sum over D shards of x [rows, D, L, 2^logn]
// mod q (the kernels above). wide 0: x uint32 residues as struct View reads
// them; wide 1: x uint64 words below 2^63 (D = 1), 16-byte aligned, its
// strides in words of 8 bytes, reduced with ratio [L] uint64 (floor(2^64 /
// q)). out a uint32 View (its shard stride unused); q [L] uint32; the quads
// of out below 2^31. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a shape the kernel does not take.
int abc_rns_psum_mod(int wide, const void* x, long long x_row,
                     long long x_shard, long long x_limb, void* out,
                     long long o_row, long long o_limb, const void* q,
                     const void* ratio, long long rows, int D, int L,
                     int logn, void* stream) {
  if (q == nullptr || !view_ok(out, o_row, 0, o_limb) ||
      !view_ok(x, x_row, x_shard, x_limb) || (wide && ratio == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Plan plan = {};
  const cudaError_t err = plan_of(wide ? 3 : 2, rows, D, L, logn, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  PsumArgs a = {};
  a.x = {static_cast<const uint32_t*>(x), x_row, x_shard, x_limb};
  a.o = {static_cast<const uint32_t*>(out), o_row, 0, o_limb};
  a.q = static_cast<const uint32_t*>(q);
  a.ratio = static_cast<const uint64_t*>(ratio);
  a.quads = static_cast<uint32_t>(((rows * L) << logn) / 4);
  a.limbs = div_by(static_cast<uint32_t>(L));
  a.D = D;
  a.qlog = logn - 2;
  const auto go = [&](auto kernel) {
    return launch(kernel, plan.threads, stream, a);
  };
  return static_cast<int>(wide ? go(rns_psum_mod_wide_kernel)
                               : by_shards(plan.arg[1], go));
}

// The launch that abc_dist_ntt_combine (kernel 0: the LocalComm form, 1: a
// rank's) or abc_rns_psum_mod (2: uint32 residues over D shards, 3: the
// rank form) makes for `rows` rows of [D, L, 2^logc] (a rank's forms: D =
// 1), into info[6]: arg0 (the combine's pairs a thread; else 1), arg1 (the
// psum's shards a thread loads before its first add, 0 for chunks of 8;
// else 0), threads a block, blocks, and
// the instantiation's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM.
// Allocates nothing. Returns cudaErrorInvalidValue for a shape the kernels
// do not take (work items past 2^31 among them), else the cudaError_t of
// the queries.
int abc_mesh_plan(int kernel, long long rows, int D, int L, int logc,
                  long long* info) {
  Plan plan = {};
  cudaError_t err = plan_of(kernel, rows, D, L, logc, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  const auto query = [&](auto kern) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0);
  };
  switch (kernel) {
    case 0: err = by_pairs<false>(plan.arg[0], query); break;
    case 1: err = query(dist_ntt_combine_rank_kernel<false>); break;
    case 2: err = by_shards(plan.arg[1], query); break;
    default: err = query(rns_psum_mod_wide_kernel);
  }
  info[0] = plan.arg[0];
  info[1] = plan.arg[1];
  info[2] = kThreads;
  info[3] = (plan.threads + kThreads - 1) / kThreads;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
