// NTT cost-attribution kernels for Hopper (sm_90a): the forward transform
// of ntt.cu with one class of work removed, and u32 ALU chains that
// calibrate the card's sustained integer rate on the butterfly's own mix.
//
// Replaces the TPU kernels of scripts/ntt_ablation.py:
//   ablate_ntt_kernel<Mode> <- ablate_ntt (body _ablate_kernel), one kernel
//                              per mode, so no mode pays for a runtime
//                              branch inside the stage loop
//   alu_mac_kernel          <- alu_chain(kind="mac")   (_alu_mac_kernel)
//   alu_shoup_kernel        <- alu_chain(kind="shoup") (_alu_shoup_kernel)
//
// ablate_ntt_kernel keeps ntt_fwd_kernel's skeleton: one CTA per row,
// threads_for(n) threads, the row in 4n bytes of dynamic shared memory, the
// same strided butterfly loop and __syncthreads() per stage. A stage either
// EXCHANGES (butterflies over shared memory, then a barrier) or stays in the
// thread (each thread rewrites the elements it loaded; a run of such stages
// is one pass in registers, with one barrier at its end). What each mode
// keeps, and the words it writes (canonical in [0, q), mod-q arithmetic):
//   zero        load + store + launch, the floor          x
//   masks_only  per-stage index arithmetic, in-thread     (x + popcount(p)) mod q
//   rolls_only  every stage exchanges, no multiply        w = 1 butterflies
//   muls_only   Shoup product and twiddle loads w[m+b],   x*(1 + w[m + p/(2t)])
//               wsh[m+b] per element, in-thread           on every stage
//   rolls_sub   exchange on stages with t >= 128, in-thread x+1 on the others
//   rolls_lane  exchange on stages with t < 128, in-thread x+1 on the others
//   full        ntt_fwd_kernel's butterflies               the forward NTT
//   reformed    a pass that multiplies every element by its own-position
//               twiddle and keeps the product at v positions, a barrier,
//               then an add/sub exchange of the product    the forward NTT
//   split0      reformed, with stage 0 (one block) done as plain butterflies
//               without per-element index arithmetic      the forward NTT
//   splitk      the same for every stage with <= 4 blocks and t >= 128
//                                                          the forward NTT
// rolls_sub / rolls_lane split the stages where the TPU kernel split sublane
// from lane rolls; here both halves use the same shared-memory exchange, and
// only t < 32 puts a butterfly's two words in one 32-word window (2-way bank
// conflicts).
//
// What bounds them on this card: like ntt_fwd, one CTA per row, so a
// 14-row n=16384 transform runs on 14 of 132 SMs, and within the CTA the
// integer issue rate and the per-stage barrier bound it, not HBM: the
// butterfly loop compiles to 32 instructions a butterfly, 25 of them
// integer ALU, of which index and 64-bit twiddle-address arithmetic
// outnumber the Shoup product's three multiplies. The ALU chains are one
// thread per element, 256 threads a block, `iters` dependent multiply-adds
// per thread: the integer multiply pipe's issue rate, given enough warps to
// hide each IMAD's latency.
//
// The chains' constants and `iters` are kernel arguments and the unroll is
// bounded (8): with compile-time constants an unrolled chain of x*c + d can
// fold into one multiply-add, the trap that made the TPU calibration read
// high. The instruction count per iteration is read back from the SASS.

#include "ntt_common.cuh"

namespace {

// the order of abc_tpu_torch.ops.ntt_ablation.MODES
enum Mode : int {
  kZero = 0, kMasksOnly, kRollsOnly, kMulsOnly, kFull, kReformed, kRollsSub,
  kRollsLane, kSplit0, kSplitK, kModes
};

constexpr int kLaneLogT = 7;  // stages with t >= 128 (the TPU's sublane rolls)

__device__ __forceinline__ uint32_t reduce_2q(uint32_t x, uint32_t two_q) {
  return x >= two_q ? x - two_q : x;
}

// Does the stage of span 2t = 2^(logt+1) exchange words between threads?
template <int M>
__device__ __forceinline__ bool exchanges(int logt) {
  if (M == kRollsSub) return logt >= kLaneLogT;
  if (M == kRollsLane) return logt < kLaneLogT;
  return M != kMasksOnly && M != kMulsOnly;
}

// Is stage st (m = 2^st blocks) formed block by block, with hoisted
// twiddles and no per-element index arithmetic?
template <int M>
__device__ __forceinline__ bool split_stage(int st, int logt) {
  if (M == kSplit0) return st == 0;
  if (M == kSplitK) return st <= 2 && logt >= kLaneLogT;
  return false;
}

// One in-thread stage on the word at position i.
template <int M>
__device__ __forceinline__ uint32_t in_thread_stage(
    uint32_t x, int i, int m, int logt, uint32_t q, uint32_t two_q,
    const uint32_t* __restrict__ w, const uint32_t* __restrict__ wsh) {
  if constexpr (M == kMasksOnly) {
    return x + ((i >> logt) & 1);          // +1 at the stage's v positions
  } else if constexpr (M == kMulsOnly) {
    const uint32_t xr = reduce_2q(x, two_q);
    const int b = i >> (logt + 1);
    return xr + shoup_lazy(xr, w[m + b], wsh[m + b], q);   // < 4q
  } else {
    return reduce_2q(x, two_q) + 1;
  }
}

template <int M>
__global__ void ablate_ntt_kernel(const uint32_t* __restrict__ in,
                                  uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ qs,
                                  const uint32_t* __restrict__ tw,
                                  const uint32_t* __restrict__ tw_sh,
                                  int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>(row % L);
  const uint32_t q = qs[l];
  const uint32_t two_q = q << 1;
  const uint32_t* w = tw + static_cast<size_t>(l) * n;
  const uint32_t* wsh = tw_sh + static_cast<size_t>(l) * n;
  const uint32_t* x = in + row * n;
  uint32_t* y = out + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[i];
  __syncthreads();

  if constexpr (M == kZero) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = s[i];
    return;
  }

  // stage st has m = 2^st blocks of span 2t; invariant s < 4q
  for (int st = 0; st < logn;) {
    const int logt = logn - 1 - st;
    const int m = 1 << st;
    const int t = 1 << logt;
    if (!exchanges<M>(logt)) {
      int end = st + 1;
      while (end < logn && !exchanges<M>(logn - 1 - end)) ++end;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        uint32_t v = s[i];
        for (int k = st; k < end; ++k)
          v = in_thread_stage<M>(v, i, 1 << k, logn - 1 - k, q, two_q, w,
                                 wsh);
        s[i] = v;
      }
      __syncthreads();
      st = end;
      continue;
    }
    if (split_stage<M>(st, logt)) {
      for (int b = 0; b < m; ++b) {
        const uint32_t wb = w[m + b];
        const uint32_t wb_sh = wsh[m + b];
        uint32_t* top = s + (b << (logt + 1));
        for (int j = threadIdx.x; j < t; j += blockDim.x) {
          const uint32_t u = reduce_2q(top[j], two_q);
          const uint32_t v = shoup_lazy(top[j + t], wb, wb_sh, q);
          top[j] = u + v;
          top[j + t] = u + two_q - v;
        }
      }
    } else if constexpr (M == kReformed || M == kSplit0 || M == kSplitK) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t xr = reduce_2q(s[i], two_q);
        const int b = i >> (logt + 1);
        const uint32_t prod = shoup_lazy(xr, w[m + b], wsh[m + b], q);
        s[i] = ((i >> logt) & 1) ? prod : xr;   // both < 2q
      }
      __syncthreads();
      for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
        const int i0 = ((j >> logt) << (logt + 1)) + (j & (t - 1));
        const int i1 = i0 + t;
        const uint32_t u = s[i0];
        const uint32_t v = s[i1];
        s[i0] = u + v;
        s[i1] = u + two_q - v;
      }
    } else {
      for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
        const int b = j >> logt;
        const int i0 = (b << (logt + 1)) + (j & (t - 1));
        const int i1 = i0 + t;
        const uint32_t u = reduce_2q(s[i0], two_q);
        uint32_t v;
        if constexpr (M == kFull) {
          v = shoup_lazy(s[i1], w[m + b], wsh[m + b], q);
        } else {
          v = reduce_2q(s[i1], two_q);          // the w = 1 butterfly
        }
        s[i0] = u + v;
        s[i1] = u + two_q - v;
      }
    }
    __syncthreads();
    ++st;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t r = reduce_2q(s[i], two_q);
    if (r >= q) r -= q;
    y[i] = r;
  }
}

template <int M>
cudaError_t launch_ablate(const uint32_t* in, uint32_t* out,
                          const uint32_t* q, const uint32_t* tw,
                          const uint32_t* tw_sh, long long rows, int L,
                          int logn, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = prepare(ablate_ntt_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  ablate_ntt_kernel<M><<<static_cast<unsigned>(rows), threads_for(1 << logn),
                         smem, stream>>>(in, out, q, tw, tw_sh, L, logn);
  return cudaGetLastError();
}

using AblateLauncher = cudaError_t (*)(const uint32_t*, uint32_t*,
                                       const uint32_t*, const uint32_t*,
                                       const uint32_t*, long long, int, int,
                                       cudaStream_t);
constexpr AblateLauncher kAblate[kModes] = {
    launch_ablate<kZero>,     launch_ablate<kMasksOnly>,
    launch_ablate<kRollsOnly>, launch_ablate<kMulsOnly>,
    launch_ablate<kFull>,     launch_ablate<kReformed>,
    launch_ablate<kRollsSub>, launch_ablate<kRollsLane>,
    launch_ablate<kSplit0>,   launch_ablate<kSplitK>};

constexpr int kAluThreads = 256;

// x = x*c + d, `iters` times, in u32 wraparound
__global__ void alu_mac_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, long long count,
                               uint32_t c, uint32_t d, int iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t x = in[i];
#pragma unroll 8
  for (int k = 0; k < iters; ++k) x = x * c + d;
  out[i] = x;
}

// x = x*w - umulhi(x, wsh)*q (the butterfly's lazy Shoup product), `iters`
// times, in u32 wraparound
__global__ void alu_shoup_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, long long count,
                                 uint32_t w, uint32_t wsh, uint32_t q,
                                 int iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t x = in[i];
#pragma unroll 8
  for (int k = 0; k < iters; ++k) x = shoup_lazy(x, w, wsh, q);
  out[i] = x;
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success); an unknown mode returns
// cudaErrorInvalidValue.
int abc_ablate_ntt(const void* in, void* out, const void* q, const void* tw,
                   const void* tw_sh, long long rows, int L, int logn,
                   int mode, void* stream) {
  if (mode < 0 || mode >= kModes) return cudaErrorInvalidValue;
  return static_cast<int>(kAblate[mode](
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh), rows, L, logn,
      static_cast<cudaStream_t>(stream)));
}

// kind 0: mac with (c, d) = (k0, k1); kind 1: shoup with (w, wsh, q) =
// (k0, k1, k2). `count` words, any layout.
int abc_alu_chain(const void* in, void* out, long long count, int kind,
                  unsigned k0, unsigned k1, unsigned k2, int iters,
                  void* stream) {
  if (count <= 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((count + kAluThreads - 1) / kAluThreads);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    alu_mac_kernel<<<blocks, kAluThreads, 0, s>>>(x, y, count, k0, k1, iters);
  } else if (kind == 1) {
    alu_shoup_kernel<<<blocks, kAluThreads, 0, s>>>(x, y, count, k0, k1, k2,
                                                    iters);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
