// NTT cost-attribution kernels for Hopper (sm_90a): the forward transform
// of ntt.cu with one class of work removed, and u32 ALU chains that
// calibrate the card's sustained integer rate on the butterfly's own mix.
//
// Replaces the TPU kernels of scripts/ntt_ablation.py:
//   ablate_ntt_kernel<Mode, LOGC> <- ablate_ntt :178 (pallas_call :181, body
//                                    _ablate_kernel :85), one kernel per mode
//                                    and cluster size, so that no mode pays
//                                    for a runtime branch on the mode
//   alu_mac_kernel                <- alu_chain(kind="mac")   (_alu_mac_kernel)
//   alu_shoup_kernel              <- alu_chain(kind="shoup") (_alu_shoup_kernel)
//
// On the TPU the ablation took apart the kernel that ships: the same grid and
// DMA, pieces switched off. Here likewise: every mode runs on ntt_fwd's
// skeleton (ntt_passes.cuh: log_cluster's C CTAs per row, min(S/8, 512)
// threads, the same dynamic shared memory, launch()), and `full` IS
// ntt_fwd_kernel, compiled from the same fwd_body with the same butterfly.
// What each mode keeps, and the words it writes (canonical in [0, q)):
//
//   zero        each CTA's own chunk in and out as 16-byte loads and stores,
//               8 words a thread: the launch, load and store floor of the
//               geometry                                     x
//   masks_only  zero + the TPU mode's per-stage position arithmetic: for
//               every stage, which side of its butterfly a word is on, from
//               the word's index, added to the word; no exchange, no
//               product. (In the shipping passes that index arithmetic is
//               paid per group of 8 and per pass, not per word and stage,
//               so this mode bounds it from above.)   (x + popcount(p)) mod q
//   muls_only   zero + the Shoup product of every word by its own position's
//               twiddle on every stage, the twiddles loaded once per group of
//               8 words and stage block as the passes load them (one per
//               stage on the 8 adjacent words, then 2 and 4 on the last two
//               stages; the gather stages' one per CTA): twice the shipping
//               products, as on the TPU; no exchange   x*(1 + w[m + p/(2t)])
//   rolls_only  every data movement of the shipping kernel (the gather of
//               the stages across CTAs, the shared-memory round trip and
//               barrier of every pass, 16-byte stores) with w = 1 butterflies:
//               no twiddle loads, no products                w = 1 butterflies
//   rolls_sub   rolls_only's movement; the w = 1 butterfly on the stages with
//   rolls_lane  t >= 128 (rolls_sub) or t < 128 (rolls_lane), x + 1 on both
//               words elsewhere. The TPU split its sublane from its lane
//               rolls there; on this card every pass moves its words through
//               shared memory whatever its stages do, so the two differ only
//               in arithmetic                                as the TPU's
//   full        the shipping kernel, instruction for instruction   the NTT
//   reformed    the TPU form that multiplies every word by its own position's
//               twiddle and then exchanges the product. In a register
//               butterfly the u word's product has no use and is not
//               computed, so what changes against full is that the v word is
//               reduced to [0, 2q) before its product           the NTT
//   split0      reformed, with global stage 0 as full does it    the NTT
//   splitk      reformed, with the stages of at most 4 blocks and t >= 128
//               (global stages 0-2) as full does them. The TPU formed those
//               stages from static slices without rolls; on this card every
//               stage is already a register butterfly with one twiddle per
//               block, so split0 and splitk change only which stages reduce
//               the v word first                                 the NTT
//
// What bounds them on this card: like ntt_fwd, bytes (4n in and 4n out a
// row, the tables once: 1.1 us at (n, L, B) = (16384, 14, 1)), against which
// the kernel spends its time in launch, in the passes' barriers and latency
// and in the instructions around each product. The design answers that as
// ntt_fwd does: 8 CTAs a row there (112 for 14 rows, where the first design
// of this file ran 14), three stages a barrier, 16-byte accesses. The modes
// say how much of
// ntt_fwd's time each class of work takes: full - zero is the transform's
// work above the floor, rolls_only - zero its data movement, muls_only -
// zero the products with their twiddle loads, masks_only - zero the
// position arithmetic. The ALU chains are one thread per element, 256
// threads a block, `iters` dependent multiply-adds per thread: the integer
// multiply pipe's throughput, given enough warps to hide each IMAD's latency.
//
// The chains' constants and `iters` are kernel arguments and the unroll is
// bounded (8): with compile-time constants an unrolled chain of x*c + d can
// fold into one multiply-add, the trap that made the TPU calibration read
// high. The instruction count per iteration is read back from the SASS.

#include "ntt_passes.cuh"

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

// The w = 1 butterfly. In and out: a, b < 4q.
__device__ __forceinline__ void unit_butterfly(uint32_t& a, uint32_t& b,
                                               uint32_t two_q) {
  const uint32_t u = reduce_2q(a, two_q), v = reduce_2q(b, two_q);
  a = u + v;
  b = u + two_q - v;
}

struct UnitButterfly {        // rolls_only
  static constexpr bool kTwiddles = false;
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t, uint32_t,
                                             const Row& r, int) const {
    unit_butterfly(a, b, r.two_q);
  }
};

template <bool SUB>           // rolls_sub (true), rolls_lane (false)
struct HalfRolls {
  static constexpr bool kTwiddles = false;
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t, uint32_t,
                                             const Row& r, int logt) const {
    if ((logt >= kLaneLogT) == SUB) {
      unit_butterfly(a, b, r.two_q);
    } else {                  // < 2q + 1
      a = reduce_2q(a, r.two_q) + 1;
      b = reduce_2q(b, r.two_q) + 1;
    }
  }
};

// reformed (FULL_STAGES = 0), split0 (1), splitk (3): the v word reduced
// before its product, but on global stages below FULL_STAGES with t >= 128
// (t >= n/2 for stage 0), which run full's butterfly.
template <int FULL_STAGES>
struct ReformedButterfly {
  static constexpr bool kTwiddles = true;
  int logn;
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t w, uint32_t wsh,
                                             const Row& r, int logt) const {
    const bool as_full =
        logn - 1 - logt < FULL_STAGES && logt >= kLaneLogT;
    const uint32_t u = reduce_2q(a, r.two_q);
    const uint32_t v =
        shoup_lazy(as_full ? b : reduce_2q(b, r.two_q), w, wsh, r.q);
    a = u + v;
    b = u + r.two_q - v;
  }
};

// One stage of muls_only on a word: x*(1 + w) up to lazy reduction. In: x <
// 4q. Out: < 4q.
__device__ __forceinline__ uint32_t mul_stage(uint32_t x, uint32_t w,
                                              uint32_t wsh, const Row& r) {
  const uint32_t xr = reduce_2q(x, r.two_q);
  return xr + shoup_lazy(xr, w, wsh, r.q);
}

// zero, masks_only, muls_only: every word stays in the thread that loads
// it. Thread g of a CTA takes the chunk's words 8g .. 8g+7 (the last pass's
// grouping), in and out as two 16-byte accesses.
template <int M, int LOGC>
__device__ __forceinline__ void own_words_body(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ qs, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tw_sh, int L, int logn) {
  constexpr int C = 1 << LOGC;
  const int c = static_cast<int>(blockIdx.x) & (C - 1);
  const size_t row = blockIdx.x >> LOGC;
  const Row r =
      row_of(qs, tw, tw_sh, static_cast<int>(row % L), c, logn, LOGC);
  const size_t at = (row << logn) + (static_cast<size_t>(c) << r.logS);
  const uint4* x4 = reinterpret_cast<const uint4*>(in + at);
  uint4* y4 = reinterpret_cast<uint4*>(out + at);

  uint32_t cw[LOGC > 0 ? LOGC : 1], cwsh[LOGC > 0 ? LOGC : 1];
#pragma unroll
  for (int st = 0; st < LOGC; ++st) {
    cw[st] = cwsh[st] = 0;
    if constexpr (M == kMulsOnly) {
      cw[st] = r.w[r.cc >> (LOGC - st)];
      cwsh[st] = r.wsh[r.cc >> (LOGC - st)];
    }
  }
  const int groups = 1 << (r.logS - 3);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int base = g << 3;
    const uint4 lo4 = x4[2 * g], hi4 = x4[2 * g + 1];
    uint32_t x[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                     hi4.x, hi4.y, hi4.z, hi4.w};
    if constexpr (M == kMasksOnly) {
      // the stages across chunks: bit LOGC-1-st of c; then the local
      // stages, half-span 2^logt: bit logt of the word's index
#pragma unroll
      for (int st = 0; st < LOGC; ++st) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] += (c >> (LOGC - 1 - st)) & 1;
      }
      for (int logt = r.logS - 1; logt >= 0; --logt) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] += ((base + e) >> logt) & 1;
      }
    } else if constexpr (M == kMulsOnly) {
#pragma unroll
      for (int st = 0; st < LOGC; ++st) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = mul_stage(x[e], cw[st], cwsh[st], r);
      }
      // local stage s: twiddle (cc << s) + p / 2^(logS - s) at chunk
      // position p; one for all 8 words while logS - s >= 3
      for (int s = 0; s <= r.logS - 3; ++s) {
        const int i = (r.cc << s) + (base >> (r.logS - s));
        const uint32_t w = r.w[i], wsh = r.wsh[i];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = mul_stage(x[e], w, wsh, r);
      }
#pragma unroll
      for (int k = 1; k <= 2; ++k) {     // s = logS - 3 + k: 2^k twiddles
        const int s = r.logS - 3 + k;
#pragma unroll
        for (int blk = 0; blk < (1 << k); ++blk) {
          const int i = (r.cc << s) + (base >> (3 - k)) + blk;
          const uint32_t w = r.w[i], wsh = r.wsh[i];
#pragma unroll
          for (int e = blk << (3 - k); e < (blk + 1) << (3 - k); ++e)
            x[e] = mul_stage(x[e], w, wsh, r);
        }
      }
    }
    if constexpr (M != kZero) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = reduce_2q(x[e], r.two_q);
        if (x[e] >= r.q) x[e] -= r.q;
      }
    }
    y4[2 * g] = make_uint4(x[0], x[1], x[2], x[3]);
    y4[2 * g + 1] = make_uint4(x[4], x[5], x[6], x[7]);
  }
}

template <int M, int LOGC>
__global__ void __launch_bounds__(kMaxThreads)
ablate_ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ qs,
                  const uint32_t* __restrict__ tw,
                  const uint32_t* __restrict__ tw_sh, int L, int logn) {
  if constexpr (M == kZero || M == kMasksOnly || M == kMulsOnly) {
    own_words_body<M, LOGC>(in, out, qs, tw, tw_sh, L, logn);
  } else if constexpr (M == kFull) {
    fwd_body<LOGC>(in, out, qs, tw, tw_sh, L, logn, CtButterfly{});
  } else if constexpr (M == kRollsOnly) {
    fwd_body<LOGC>(in, out, qs, tw, tw_sh, L, logn, UnitButterfly{});
  } else if constexpr (M == kRollsSub || M == kRollsLane) {
    fwd_body<LOGC>(in, out, qs, tw, tw_sh, L, logn,
                   HalfRolls<M == kRollsSub>{});
  } else {
    constexpr int kFullStages = M == kSplit0 ? 1 : M == kSplitK ? 3 : 0;
    fwd_body<LOGC>(in, out, qs, tw, tw_sh, L, logn,
                   ReformedButterfly<kFullStages>{logn});
  }
}

template <int M, int LOGC>
cudaError_t launch_ablate(const uint32_t* in, uint32_t* out,
                          const uint32_t* q, const uint32_t* tw,
                          const uint32_t* tw_sh, long long rows, int L,
                          int logn, void* stream) {
  return launch(ablate_ntt_kernel<M, LOGC>, 1u, 1, LOGC, rows, logn, stream,
                in, out, q, tw, tw_sh, L, logn);
}

template <int M>
cudaError_t allow_mode() {
  for (cudaError_t err : {allow_max_smem(ablate_ntt_kernel<M, 0>),
                          allow_max_smem(ablate_ntt_kernel<M, 1>),
                          allow_max_smem(ablate_ntt_kernel<M, 2>),
                          allow_max_smem(ablate_ntt_kernel<M, 3>)}) {
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

using AblateLauncher = cudaError_t (*)(const uint32_t*, uint32_t*,
                                       const uint32_t*, const uint32_t*,
                                       const uint32_t*, long long, int, int,
                                       void*);
#define ABLATE_MODE(M)                                                   \
  { launch_ablate<M, 0>, launch_ablate<M, 1>, launch_ablate<M, 2>,       \
    launch_ablate<M, 3> }
constexpr AblateLauncher kAblate[kModes][4] = {
    ABLATE_MODE(kZero),     ABLATE_MODE(kMasksOnly), ABLATE_MODE(kRollsOnly),
    ABLATE_MODE(kMulsOnly), ABLATE_MODE(kFull),      ABLATE_MODE(kReformed),
    ABLATE_MODE(kRollsSub), ABLATE_MODE(kRollsLane), ABLATE_MODE(kSplit0),
    ABLATE_MODE(kSplitK)};
#undef ABLATE_MODE

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
  return static_cast<int>(kAblate[mode][log_cluster(rows, logn)](
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh), rows, L, logn, stream));
}

// Allows every ablation kernel the most dynamic shared memory a launch takes
// (ntt_passes.cuh: allow_max_smem); the library's loader calls it once.
int abc_ablate_init() {
  for (cudaError_t err :
       {allow_mode<kZero>(), allow_mode<kMasksOnly>(),
        allow_mode<kRollsOnly>(), allow_mode<kMulsOnly>(),
        allow_mode<kFull>(), allow_mode<kReformed>(),
        allow_mode<kRollsSub>(), allow_mode<kRollsLane>(),
        allow_mode<kSplit0>(), allow_mode<kSplitK>()}) {
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
