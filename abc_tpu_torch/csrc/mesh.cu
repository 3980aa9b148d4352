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
// Every word written is canonical in [0, q) and equal to the plain torch
// versions (abc_tpu_torch/ops/mesh_kernels.py, the t64 chains the mesh
// paths ran before): a sum is one conditional subtract, a difference one
// conditional add, a product with a twiddle a Shoup product (mul_const).

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kThreads = 128;

// An operand [rows, D, L, cols] at its strides in words; its coefficients
// are consecutive.
struct View {
  const uint32_t* p;
  long long row, shard, limb;
};

__device__ __forceinline__ size_t at(const View& v, long long r, int d,
                                     int l) {
  return static_cast<size_t>(r * v.row + d * v.shard + l * v.limb);
}

// Where a thread works: its quad's first coefficient c of limb l of shard d
// of row r.
struct Quad {
  long long r;
  int d, l;
  size_t c;
};

__device__ __forceinline__ Quad quad_of(long long t, int D, int L,
                                        int qlog) {
  const long long line = t >> qlog;
  const long long rd = line / L;
  return {rd / D, static_cast<int>(rd % D), static_cast<int>(line % L),
          static_cast<size_t>(t & ((1LL << qlog) - 1)) * 4};
}

// One exchange stage of the distributed NTT over the partner pairs d <->
// d ^ t_sh of the mesh axis. Shard d's partner block is p's shard d ^ pxor
// (LocalComm: pxor = t_sh, p = x, the exchange read in place; a rank:
// pxor = 0, p the block it received). d0 + d is the shard's position on the
// axis, and it is the pair's u side (its lower half) where bit t_sh of it
// is clear. w / wsh: the shard's twiddle and its Shoup companion, at
// w[d * tw_shard + l] (tw_shard L: a table per shard; 0: the rank's own).
//   forward: u side x + w p, v side p - w x;
//   inverse: u side x + p, v side (p - x) w; where uw is given the u side
//   is multiplied by uw (companion uwsh): inv_local's n^-1, folded into
//   its last stage with w n^-1 as the v side's twiddle.
template <bool Inverse>
__global__ void __launch_bounds__(kThreads) dist_ntt_combine_kernel(
    View x, View p, View o, const uint32_t* __restrict__ w,
    const uint32_t* __restrict__ wsh, long long tw_shard,
    const uint32_t* __restrict__ uw, const uint32_t* __restrict__ uwsh,
    const uint32_t* __restrict__ q, long long quads, int D, int L, int d0,
    int t_sh, int pxor, int qlog) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const Quad at4 = quad_of(t, D, L, qlog);
  const int d = at4.d, l = at4.l;
  const uint32_t m = ld(q + l);
  const uint32_t tw = ld(w + d * tw_shard + l);
  const uint32_t twsh = ld(wsh + d * tw_shard + l);
  const bool is_u = ((d0 + d) & t_sh) == 0;
  const uint4 xv = ld4(x.p + at(x, at4.r, d, l) + at4.c);
  const uint4 pv = ld4(p.p + at(p, at4.r, d ^ pxor, l) + at4.c);
  uint32_t u = 0, ush = 0;
  if (Inverse && is_u && uw != nullptr) {
    u = ld(uw + l);
    ush = ld(uwsh + l);
  }
  uint32_t res[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t a = lane_of(xv, e), b = lane_of(pv, e);
    if (Inverse) {
      if (is_u) {
        const uint32_t s = add_mod(a, b, m);
        res[e] = uw != nullptr ? mul_const(s, u, ush, m) : s;
      } else {
        res[e] = mul_const(sub_mod(b, a, m), tw, twsh, m);
      }
    } else if (is_u) {
      res[e] = add_mod(a, mul_const(b, tw, twsh, m), m);
    } else {
      res[e] = sub_mod(b, mul_const(a, tw, twsh, m), m);
    }
  }
  st4(const_cast<uint32_t*>(o.p) + at(o, at4.r, d, l) + at4.c,
      make_uint4(res[0], res[1], res[2], res[3]));
}

// out [rows, L, n] = sum over the D shards of x [rows, D, L, n] mod q[l]:
// uint32 residues summed by modular adds (a running value below q, so no
// sum leaves 32 bits however many shards); or (Wide) uint64 words, the
// sums an all_reduce made, each reduced mod q once.
template <bool Wide>
__global__ void __launch_bounds__(kThreads) rns_psum_mod_kernel(
    View x, const uint64_t* __restrict__ xw, View o,
    const uint32_t* __restrict__ q, long long quads, int D, int L,
    int qlog) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const Quad at4 = quad_of(t, 1, L, qlog);
  const int l = at4.l;
  const uint32_t m = ld(q + l);
  uint32_t acc[4] = {0, 0, 0, 0};
  for (int d = 0; d < D; ++d) {
    const size_t base = at(x, at4.r, d, l) + at4.c;
    if (Wide) {
      uint64_t s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = ld64(xw + base + e) % m;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] = add_mod(acc[e], static_cast<uint32_t>(s[e]), m);
      }
    } else {
      const uint4 v = ld4(x.p + base);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = add_mod(acc[e], lane_of(v, e), m);
    }
  }
  st4(const_cast<uint32_t*>(o.p) + at(o, at4.r, 0, l) + at4.c,
      make_uint4(acc[0], acc[1], acc[2], acc[3]));
}

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

// a uint32 operand: 16-byte aligned, its rows, shards and limbs whole quads
// apart
bool view_ok(const void* p, long long row, long long shard, long long limb) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         row >= 0 && shard >= 0 && limb >= 0 && row % 4 == 0 &&
         shard % 4 == 0 && limb % 4 == 0;
}

}  // namespace

extern "C" {

// K8a: one exchange stage's combine of the distributed NTT (the kernel
// above), out [rows, D, L, 2^logc]. x, p and out as struct View reads them
// (pointer, then the words between rows, shards and limbs); pxor 0 or t_sh
// (t_sh a power of two); w and wsh [*, L] uint32 with tw_shard words
// between shards; uw and uwsh [L] or null (inverse only); q [L] uint32. All
// pointers are device pointers but null ones; `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success); a shape the kernel
// does not take returns cudaErrorInvalidValue.
int abc_dist_ntt_combine(int inverse, const void* x, long long x_row,
                         long long x_shard, long long x_limb, const void* p,
                         long long p_row, long long p_shard, long long p_limb,
                         int pxor, void* out, long long o_row,
                         long long o_shard, long long o_limb, const void* w,
                         const void* wsh, long long tw_shard, const void* uw,
                         const void* uwsh, const void* q, long long rows,
                         int D, int L, int d0, int t_sh, int logc,
                         void* stream) {
  if (logc < 2 || rows < 0 || D < 1 || L < 1 || d0 < 0 || t_sh < 1 ||
      (t_sh & (t_sh - 1)) != 0 || (pxor != 0 && pxor != t_sh) ||
      (pxor != 0 && D <= t_sh) || tw_shard < 0 || w == nullptr ||
      wsh == nullptr || q == nullptr || (uw == nullptr) != (uwsh == nullptr) ||
      (uw != nullptr && !inverse) || !view_ok(x, x_row, x_shard, x_limb) ||
      !view_ok(p, p_row, p_shard, p_limb) ||
      !view_ok(out, o_row, o_shard, o_limb)) {
    return cudaErrorInvalidValue;
  }
  const View vx = {static_cast<const uint32_t*>(x), x_row, x_shard, x_limb};
  const View vp = {static_cast<const uint32_t*>(p), p_row, p_shard, p_limb};
  const View vo = {static_cast<const uint32_t*>(out), o_row, o_shard,
                   o_limb};
  const long long quads = ((rows * D * L) << logc) / 4;
  const auto go = [&](auto kernel) {
    return launch(kernel, quads, stream, vx, vp, vo,
                  static_cast<const uint32_t*>(w),
                  static_cast<const uint32_t*>(wsh), tw_shard,
                  static_cast<const uint32_t*>(uw),
                  static_cast<const uint32_t*>(uwsh),
                  static_cast<const uint32_t*>(q), quads, D, L, d0, t_sh,
                  pxor, logc - 2);
  };
  return static_cast<int>(inverse ? go(dist_ntt_combine_kernel<true>)
                                  : go(dist_ntt_combine_kernel<false>));
}

// K8c: out [rows, L, 2^logn] = sum over D shards of x [rows, D, L, 2^logn]
// mod q (the kernel above). wide 0: x uint32 residues as struct View reads
// them; wide 1: x uint64 words (any 64-bit value), 8-byte aligned, its
// strides in words of 8 bytes. out a uint32 View (its shard stride
// unused); q [L] uint32. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a shape the kernel does not take.
int abc_rns_psum_mod(int wide, const void* x, long long x_row,
                     long long x_shard, long long x_limb, void* out,
                     long long o_row, long long o_limb, const void* q,
                     long long rows, int D, int L, int logn, void* stream) {
  if (logn < 2 || rows < 0 || D < 1 || L < 1 || q == nullptr ||
      !view_ok(out, o_row, 0, o_limb)) {
    return cudaErrorInvalidValue;
  }
  if (wide ? (x == nullptr || reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
              x_row < 0 || x_shard < 0 || x_limb < 0 || x_row % 4 != 0 ||
              x_shard % 4 != 0 || x_limb % 4 != 0)
           : !view_ok(x, x_row, x_shard, x_limb)) {
    return cudaErrorInvalidValue;
  }
  const View vx = {static_cast<const uint32_t*>(x), x_row, x_shard, x_limb};
  const View vo = {static_cast<const uint32_t*>(out), o_row, 0, o_limb};
  const long long quads = ((rows * L) << logn) / 4;
  const uint64_t* xw = static_cast<const uint64_t*>(x);
  const uint32_t* qs = static_cast<const uint32_t*>(q);
  return static_cast<int>(
      wide ? launch(rns_psum_mod_kernel<true>, quads, stream, vx, xw, vo, qs,
                    quads, D, L, logn - 2)
           : launch(rns_psum_mod_kernel<false>, quads, stream, vx, xw, vo,
                    qs, quads, D, L, logn - 2));
}

}  // extern "C"
