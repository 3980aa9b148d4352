// The forward transform's skeleton, shared by ntt_fwd_kernel (ntt.cu) and
// the ablation kernels (ntt_ablation.cu), so that the ablation's `full` mode
// is the shipping kernel compiled from the same source: the launch geometry
// (log_cluster, launch), the gather of the stages across CTAs, and the
// register passes over shared memory. ntt.cu's file note says why the design
// is what it is.
//
// fwd_body and fwd_pass take the butterfly as a stage operation `Op`:
//   Op::kTwiddles   whether the stage loads its twiddle and Shoup companion
//   op(a, b, w, wsh, r, logt)
//                   the butterfly of a stage with half-span 2^logt on the
//                   pair (a, b); words < 4q before and after
// CtButterfly is the transform's own; ntt_ablation.cu adds the others.
#pragma once

#include <initializer_list>

#include "ntt_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinChunkLog = 10;   // a CTA holds at least 1024 coefficients

// Index of logical word i in the padded shared-memory layout.
__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

__host__ __device__ constexpr int padded_words(int words) {
  return words + (words >> 3);
}

// The largest n the kernels take (ops/ntt_kernels.py MAX_N) and the most
// dynamic shared memory a launch takes: one padded chunk of that size, or
// two of half of it (the inverse's buffers at C = 2).
constexpr int kMaxLogN = 15;
constexpr size_t kMaxSmemBytes =
    sizeof(uint32_t) * padded_words(1 << kMaxLogN);

// Dynamic shared memory above 48 KB must be opted into per kernel. The
// attribute belongs to the function, not to a launch, so every kernel that
// launch() starts is allowed kMaxSmemBytes once, when the library is loaded
// (abc_ntt_init, abc_ablate_init): no launch changes it under the nodes of a
// captured graph, and no launch makes a host call besides its own.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxSmemBytes));
}

// 16-byte word groups of the padded layout: logical words 4v .. 4v+3 sit
// at padded uint4 index v + (v >> 3).
__device__ __forceinline__ int pad4(int v) { return v + (v >> 3); }

// Forward butterfly. In: a < 4q, b any word. Out: a, b < 4q.
__device__ __forceinline__ void ct_butterfly(uint32_t& a, uint32_t& b,
                                             uint32_t w, uint32_t wsh,
                                             uint32_t q, uint32_t two_q) {
  uint32_t u = a;
  if (u >= two_q) u -= two_q;                       // < 2q
  const uint32_t v = shoup_lazy(b, w, wsh, q);      // < 2q
  a = u + v;
  b = u + two_q - v;
}

struct Row {
  uint32_t q, two_q;
  const uint32_t* w;     // this limb's twiddle row
  const uint32_t* wsh;   // its Shoup companions
  int cc;                // C + cluster rank: the chunk's twiddle prefix
  int logS;              // log2 of the chunk size
};

__device__ __forceinline__ Row row_of(const uint32_t* qs, const uint32_t* tw,
                                      const uint32_t* tw_sh, int l, int c,
                                      int logn, int logC) {
  Row r;
  r.q = qs[l];
  r.two_q = r.q << 1;
  r.w = tw + (static_cast<size_t>(l) << logn);
  r.wsh = tw_sh + (static_cast<size_t>(l) << logn);
  r.cc = (1 << logC) + c;
  r.logS = logn - logC;
  return r;
}

// The shipping transform's butterfly.
struct CtButterfly {
  static constexpr bool kTwiddles = true;
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t w, uint32_t wsh,
                                             const Row& r, int) const {
    ct_butterfly(a, b, w, wsh, r.q, r.two_q);
  }
};

// R forward stages on 2^R coefficients per thread, local stages
// s0 .. s0+R-1 of the chunk (stage s pairs words S >> (s+1) apart). A group
// is the words base + j*t2, j < 2^R, t2 = S >> (s0+R), all inside one block
// `hi` of stage s0; stage s0+k splits it into 2^k blocks with twiddles
// (B << k) + blk, B = (cc << s0) + hi (global m + block, see ntt.cu's file
// note). TO_GLOBAL is the pass with t2 = 1: it reads the thread's 8 adjacent
// words and writes them, reduced to [0, q), straight to the output row.
// Invariant: words < 4q before and after.
template <int R, bool TO_GLOBAL, class Op>
__device__ __forceinline__ void fwd_pass(uint32_t* s, uint32_t* y,
                                         const Row& r, int s0, const Op& op) {
  constexpr int E = 1 << R;
  const int logt2 = r.logS - s0 - R;
  const int groups = 1 << (r.logS - R);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int lo = g & ((1 << logt2) - 1);
    const int hi = g >> logt2;
    const int base = (hi << (logt2 + R)) + lo;
    uint32_t x[E];
    if constexpr (TO_GLOBAL) {
      const uint4* src = reinterpret_cast<const uint4*>(s + pad(base));
      const uint4 lo4 = src[0], hi4 = src[1];
      x[0] = lo4.x; x[1] = lo4.y; x[2] = lo4.z; x[3] = lo4.w;
      x[E - 4] = hi4.x; x[E - 3] = hi4.y; x[E - 2] = hi4.z; x[E - 1] = hi4.w;
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) x[j] = s[pad(base + (j << logt2))];
    }
    const int B = (r.cc << s0) + hi;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int half = E >> (k + 1);
#pragma unroll
      for (int blk = 0; blk < (1 << k); ++blk) {
        uint32_t w = 0, wsh = 0;
        if constexpr (Op::kTwiddles) {
          w = r.w[(B << k) + blk];
          wsh = r.wsh[(B << k) + blk];
        }
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const int a = blk * 2 * half + j;
          op(x[a], x[a + half], w, wsh, r, logt2 + R - 1 - k);
        }
      }
    }
    if constexpr (TO_GLOBAL) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (x[j] >= r.two_q) x[j] -= r.two_q;
        if (x[j] >= r.q) x[j] -= r.q;
      }
      uint4* dst = reinterpret_cast<uint4*>(y + base);
      dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
      dst[1] = make_uint4(x[E - 4], x[E - 3], x[E - 2], x[E - 1]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) s[pad(base + (j << logt2))] = x[j];
    }
  }
}

// Forward transform of chunk c = blockIdx.x % C of row blockIdx.x / C,
// C = 2^LOGC, with the butterfly `op`. grid = rows * C CTAs; dynamic shared
// memory = padded_words(S) words.
//
// The LOGC stages whose span reaches across chunks (m = 1 .. C/2) come
// first and read the input row itself (the gather): for each of its own
// offsets o the CTA loads word o of all C chunks (C 16-byte loads a thread)
// and runs the part of the radix-C butterfly that its own output needs: C-1
// butterflies of which it keeps one side each, `upper` by the bits of c;
// stage st uses the single twiddle cc >> (LOGC - st). The row is read C
// times from L2 and no CTA waits for another. With C = 1 this pass is the
// copy into shared memory. Words < 4q after it. Then the local stages,
// three at a time in registers, the log2(S) mod 3 left over first.
template <int LOGC, class Op>
__device__ __forceinline__ void fwd_body(const uint32_t* __restrict__ in,
                                         uint32_t* __restrict__ out,
                                         const uint32_t* __restrict__ qs,
                                         const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ tw_sh,
                                         int L, int logn, const Op& op) {
  extern __shared__ uint4 smem4[];
  constexpr int C = 1 << LOGC;
  const int c = static_cast<int>(blockIdx.x) & (C - 1);
  const size_t row = blockIdx.x >> LOGC;
  const Row r =
      row_of(qs, tw, tw_sh, static_cast<int>(row % L), c, logn, LOGC);
  const int vecs = 1 << (r.logS - 2);
  const uint4* row4 = reinterpret_cast<const uint4*>(in + (row << logn));
  uint32_t* y = out + (row << logn) + (static_cast<size_t>(c) << r.logS);

  uint32_t cw[LOGC > 0 ? LOGC : 1], cwsh[LOGC > 0 ? LOGC : 1];
#pragma unroll
  for (int st = 0; st < LOGC; ++st) {
    cw[st] = cwsh[st] = 0;
    if constexpr (Op::kTwiddles) {
      cw[st] = r.w[r.cc >> (LOGC - st)];
      cwsh[st] = r.wsh[r.cc >> (LOGC - st)];
    }
  }
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[C][4];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const uint4 t = row4[(j << (r.logS - 2)) + v];
      x[j][0] = t.x; x[j][1] = t.y; x[j][2] = t.z; x[j][3] = t.w;
    }
#pragma unroll
    for (int st = 0; st < LOGC; ++st) {
      const bool upper = (c >> (LOGC - 1 - st)) & 1;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {   // constant bounds: x stays in
        if (i < (C >> (st + 1))) {        // registers once unrolled
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t lo = x[i][e], hi = x[i + (C >> (st + 1))][e];
            op(lo, hi, cw[st], cwsh[st], r, logn - 1 - st);
            x[i][e] = upper ? hi : lo;
          }
        }
      }
    }
    smem4[pad4(v)] = make_uint4(x[0][0], x[0][1], x[0][2], x[0][3]);
  }
  __syncthreads();

  uint32_t* s = reinterpret_cast<uint32_t*>(smem4);
  const int rem = r.logS % 3;
  if (rem == 1) {
    fwd_pass<1, false>(s, y, r, 0, op);
    __syncthreads();
  } else if (rem == 2) {
    fwd_pass<2, false>(s, y, r, 0, op);
    __syncthreads();
  }
  int s0 = rem;
  for (; s0 < r.logS - 3; s0 += 3) {
    fwd_pass<3, false>(s, y, r, s0, op);
    __syncthreads();
  }
  fwd_pass<3, true>(s, y, r, s0, op);
}

// Cluster size for a launch, from its shape alone: the smallest power of
// two C <= 8 with rows*C >= 96 CTAs, while a CTA still holds 2^kMinChunkLog
// coefficients.
int log_cluster(long long rows, int logn) {
  int logC = 0;
  while (logC < 3 && (rows << logC) < 96 && logn - (logC + 1) >= kMinChunkLog)
    ++logC;
  return logC;
}

// Launch `kernel` on rows << logC CTAs of min(S/8, kMaxThreads) threads, S =
// n >> logC, in clusters of `cluster` CTAs, with `buffers` chunk buffers of
// dynamic shared memory (allowed up to kMaxSmemBytes at load time).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned cluster, int buffers, int logC,
                   long long rows, int logn, void* stream, Args... args) {
  const int S = 1 << (logn - logC);
  const size_t smem = sizeof(uint32_t) * padded_words(S) * buffers;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows << logC));
  cfg.blockDim = dim3((S >> 3) < kMaxThreads ? (S >> 3) : kMaxThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
