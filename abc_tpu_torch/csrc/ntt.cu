// Negacyclic NTT kernels over RNS limbs for Hopper (sm_90a).
//
// Replaces the TPU kernels of abc_tpu/ops/pallas_ntt.py:
//   ntt_fwd  <- pallas_fwd_ntt / pallas_fwd_ntt_fp  (kernel body _fwd_kernel)
//   ntt_inv  <- pallas_inv_ntt / pallas_inv_ntt_fp  (kernel body _inv_kernel)
// The two TPU variants of each transform existed only to fit VMEM and the
// TPU's table bandwidth; here one kernel per direction reads the [L, n]
// psi^brv twiddle tables and their Shoup companions directly, indexed
// m + block exactly as abc_tpu/crypto/ntt.py:_fwd_stages/_inv_stages index
// them.
//
// Data: a row-major [rows, n] array of uint32 residues (the port stores them
// as int32; every prime is below 2^30, so the bits are the same). Row r uses
// modulus index r % L. Outputs are canonical in [0, q), hence bit-identical
// to the np64/jx32/Pallas transforms whatever stage grouping and lazy
// reduction run inside.
//
// What bounds it on this card. A row is 4n bytes read and 4n written, and
// n/2 * log2(n) butterflies of 3 integer multiply-adds each: at the main
// path's largest launch (42 rows, n=8192) that is 3.2 MB and 6.7 M IMAD,
// about 1 us of memory time and 0.4 us of issue time, so the bound is bytes.
// What actually limits a launch of 12-42 rows is neither: it is how many of
// the 132 SMs work, how many instructions surround each product, and how
// many barriers and waits the stages cost. The design goes at those:
//
// * A row is split over C = 1, 2, 4 or 8 CTAs (C is chosen by the launcher
//   from rows and n alone: the smallest C with rows*C >= 96 whose CTAs
//   still hold 1024 coefficients). CTA c keeps the contiguous chunk
//   [c*S, (c+1)*S), S = n/C, in its shared memory, and log2(C) stages reach
//   across chunks. The two directions treat those stages differently,
//   because they stand at opposite ends of the transform:
//   - forward, they come first, so each CTA reads them straight from the
//     input row: word o of all C chunks, and the C-1 butterflies its own
//     word o needs. The row is read C times from L2, some products are
//     computed in several CTAs, and no CTA ever waits for another.
//   - inverse, they come last, after each CTA's local stages. The C CTAs of
//     a row are launched as one thread block cluster, and each stage reads
//     the partner chunk through distributed shared memory, ping-ponging
//     between two buffers, at one cluster.sync() per stage. On this card a
//     cluster.sync() with its pass costs about 1 us, which is why the
//     forward kernel avoids them where it can.
// * Local stages run three at a time: a thread takes 8 coefficients into
//   registers, runs 3 stages (12 butterflies) on them with the 1+2+4
//   twiddles of those stages loaded once, and writes them back. 13 stages
//   become 4-5 passes, so barriers and shared-memory traffic fall threefold
//   and the index arithmetic is paid once per pass, not once per butterfly.
//   The log2(S) mod 3 stages left over run as one shorter pass.
// * Rows enter and leave as 16-byte loads and stores. The pass next to
//   global memory (spans 4, 2, 1) reads or writes a thread's 8 adjacent
//   words directly in global memory. Shared memory is padded by 4 words per
//   32 (pad()), which makes that pass's 16-byte accesses and the span-8
//   pass's word accesses free of bank conflicts.
// * At most 512 threads a CTA, so that two or three CTAs of a large batch
//   share an SM's registers and shared memory.
//
// Lazy ranges (Harvey): forward values stay in [0, 4q), inverse values in
// [0, 2q) (4q < 2^32 for q < 2^30); each pass states its invariant. The
// reductions are compare-and-subtract: min(x, x - 2q) measured slower.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinChunkLog = 10;   // a CTA holds at least 1024 coefficients

// Index of logical word i in the padded shared-memory layout.
__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

__host__ __device__ constexpr int padded_words(int words) {
  return words + (words >> 3);
}

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

// Inverse butterfly. In: a, b < 2q. Out: a, b < 2q.
__device__ __forceinline__ void gs_butterfly(uint32_t& a, uint32_t& b,
                                             uint32_t w, uint32_t wsh,
                                             uint32_t q, uint32_t two_q) {
  const uint32_t u = a, v = b;
  uint32_t sum = u + v;                             // < 4q
  if (sum >= two_q) sum -= two_q;
  a = sum;
  b = shoup_lazy(u + two_q - v, w, wsh, q);
}

struct Row {
  uint32_t q, two_q;
  const uint32_t* w;     // this limb's twiddle row
  const uint32_t* wsh;   // its Shoup companions
  int cc;                // C + cluster rank: the chunk's twiddle prefix
  int logS;              // log2 of the chunk size
};

// R forward stages on 2^R coefficients per thread, local stages
// s0 .. s0+R-1 of the chunk (stage s pairs words S >> (s+1) apart). A group
// is the words base + j*t2, j < 2^R, t2 = S >> (s0+R), all inside one block
// `hi` of stage s0; stage s0+k splits it into 2^k blocks with twiddles
// (B << k) + blk, B = (cc << s0) + hi (global m + block, see the file note).
// TO_GLOBAL is the pass with t2 = 1: it reads the thread's 8 adjacent words
// and writes them, reduced to [0, q), straight to the output row.
// Invariant: words < 4q before and after.
template <int R, bool TO_GLOBAL>
__device__ __forceinline__ void fwd_pass(uint32_t* s, uint32_t* y,
                                         const Row& r, int s0) {
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
        const uint32_t w = r.w[(B << k) + blk];
        const uint32_t wsh = r.wsh[(B << k) + blk];
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const int a = blk * 2 * half + j;
          ct_butterfly(x[a], x[a + half], w, wsh, r.q, r.two_q);
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

// The mirror image: R inverse stages with spans t2, 2*t2, ... on the words
// base + j*t2; stage k pairs j with j + 2^k and uses twiddle
// (B0 >> k) + (j >> (k+1)), B0 = m0*cc + hi*2^(R-1), m0 = S >> (logt2+1).
// FROM_GLOBAL is the pass with t2 = 1, reading the thread's 8 adjacent words
// from the input row. Invariant: words < 2q before and after (input words
// are < q).
template <int R, bool FROM_GLOBAL>
__device__ __forceinline__ void inv_pass(uint32_t* s, const uint32_t* x_in,
                                         const Row& r, int logt2) {
  constexpr int E = 1 << R;
  const int groups = 1 << (r.logS - R);
  const int logm0 = r.logS - logt2 - 1;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int lo = g & ((1 << logt2) - 1);
    const int hi = g >> logt2;
    const int base = (hi << (logt2 + R)) + lo;
    uint32_t x[E];
    if constexpr (FROM_GLOBAL) {
      const uint4* src = reinterpret_cast<const uint4*>(x_in + base);
      const uint4 lo4 = src[0], hi4 = src[1];
      x[0] = lo4.x; x[1] = lo4.y; x[2] = lo4.z; x[3] = lo4.w;
      x[E - 4] = hi4.x; x[E - 3] = hi4.y; x[E - 2] = hi4.z; x[E - 1] = hi4.w;
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) x[j] = s[pad(base + (j << logt2))];
    }
    const int B0 = (r.cc << logm0) + (hi << (R - 1));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int dist = 1 << k;
#pragma unroll
      for (int blk = 0; blk < (E >> (k + 1)); ++blk) {
        const uint32_t w = r.w[(B0 >> k) + blk];
        const uint32_t wsh = r.wsh[(B0 >> k) + blk];
#pragma unroll
        for (int j = 0; j < dist; ++j) {
          const int a = blk * 2 * dist + j;
          gs_butterfly(x[a], x[a + dist], w, wsh, r.q, r.two_q);
        }
      }
    }
    if constexpr (FROM_GLOBAL) {
      uint4* dst = reinterpret_cast<uint4*>(s + pad(base));
      dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
      dst[1] = make_uint4(x[E - 4], x[E - 3], x[E - 2], x[E - 1]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) s[pad(base + (j << logt2))] = x[j];
    }
  }
}

// 16-byte word groups of the padded layout: logical words 4v .. 4v+3 sit
// at padded uint4 index v + (v >> 3).
__device__ __forceinline__ int pad4(int v) { return v + (v >> 3); }

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

// Forward transform of chunk c = blockIdx.x % C of row blockIdx.x / C,
// C = 2^LOGC. grid = rows * C CTAs; dynamic shared memory =
// padded_words(S) words.
//
// The LOGC stages whose span reaches across chunks (m = 1 .. C/2) come
// first and read the input row itself: for each of its own offsets o the
// CTA loads word o of all C chunks (C 16-byte loads a thread) and runs the
// part of the radix-C butterfly that its own output needs: C-1 butterflies
// of which it keeps one side each, `upper` by the bits of c; stage st uses
// the single twiddle cc >> (LOGC - st). The row is read C times from L2 and
// no CTA waits for another. With C = 1 this pass is the copy into shared
// memory. Words < 4q after it.
template <int LOGC>
__global__ void __launch_bounds__(kMaxThreads)
ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh, int L, int logn) {
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
    cw[st] = r.w[r.cc >> (LOGC - st)];
    cwsh[st] = r.wsh[r.cc >> (LOGC - st)];
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
            ct_butterfly(lo, hi, cw[st], cwsh[st], r.q, r.two_q);
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
    fwd_pass<1, false>(s, y, r, 0);
    __syncthreads();
  } else if (rem == 2) {
    fwd_pass<2, false>(s, y, r, 0);
    __syncthreads();
  }
  int s0 = rem;
  for (; s0 < r.logS - 3; s0 += 3) {
    fwd_pass<3, false>(s, y, r, s0);
    __syncthreads();
  }
  fwd_pass<3, true>(s, y, r, s0);
}

// Inverse transform of chunk c of a row, launched as clusters of C = 2^logC
// CTAs (one cluster per row); dynamic shared memory = padded_words(S) words,
// twice that when C > 1.
//
// The local stages (spans 1 .. S/2) come first. The logC stages whose span
// reaches across chunks come last and cannot read the input row as the
// forward kernel does: word o of chunk c pairs with word o of chunk c ^ d,
// d = 1 .. C/2 chunks away, read from the partner CTA's shared memory
// (distributed shared memory); the whole chunk shares twiddle
// cc >> log2(2d). Each such stage ping-pongs between two buffers, so it
// costs one cluster.sync(): a CTA writes buffer B only after the sync that
// follows every read of B. Words < 2q after each stage.
__global__ void __launch_bounds__(kMaxThreads)
ntt_inv_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh,
               const uint32_t* __restrict__ ninv,
               const uint32_t* __restrict__ ninv_sh, int L, int logn,
               int logC) {
  extern __shared__ uint4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = 1 << logC;
  const int c = static_cast<int>(blockIdx.x) & (C - 1);
  const size_t row = blockIdx.x >> logC;
  const int l = static_cast<int>(row % L);
  const Row r = row_of(qs, tw, tw_sh, l, c, logn, logC);
  const int S = 1 << r.logS;
  const int vecs = S >> 2;
  const uint32_t* x = in + (row << logn) + (static_cast<size_t>(c) << r.logS);
  uint32_t* y = out + (row << logn) + (static_cast<size_t>(c) << r.logS);

  uint4* cur = smem4;
  uint4* nxt = smem4 + (padded_words(S) >> 2);
  uint32_t* s = reinterpret_cast<uint32_t*>(cur);

  // local stages, spans 1 .. S/2: 3 at a time from the bottom, then the
  // log2(S) mod 3 left over
  inv_pass<3, true>(s, x, r, 0);
  __syncthreads();
  const int rem = r.logS % 3;
  int logt2 = 3;
  for (; logt2 + 3 <= r.logS; logt2 += 3) {
    inv_pass<3, false>(s, x, r, logt2);
    __syncthreads();
  }
  if (rem == 1) {
    inv_pass<1, false>(s, x, r, logt2);
    __syncthreads();
  } else if (rem == 2) {
    inv_pass<2, false>(s, x, r, logt2);
    __syncthreads();
  }

  // the stages across chunks, d = 1 .. C/2
  for (int logd = 0; logd < logC; ++logd) {
    cluster.sync();
    const int d = 1 << logd;
    const uint4* far = cluster.map_shared_rank(cur, c ^ d);
    const uint32_t w = r.w[r.cc >> (logd + 1)];
    const uint32_t wsh = r.wsh[r.cc >> (logd + 1)];
    const bool upper = (c & d) != 0;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 mine = cur[pad4(v)], other = far[pad4(v)];
      uint32_t a[4] = {mine.x, mine.y, mine.z, mine.w};
      uint32_t b[4] = {other.x, other.y, other.z, other.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t lo = upper ? b[j] : a[j];
        uint32_t hi = upper ? a[j] : b[j];
        gs_butterfly(lo, hi, w, wsh, r.q, r.two_q);
        o[j] = upper ? hi : lo;
      }
      nxt[pad4(v)] = make_uint4(o[0], o[1], o[2], o[3]);
    }
    uint4* t = cur; cur = nxt; nxt = t;
  }
  if (logC > 0) cluster.sync();     // partners are done reading this chunk

  // n^-1 scale, reduce to [0, q), 16-byte stores
  const uint32_t ni = ninv[l];
  const uint32_t ni_sh = ninv_sh[l];
  uint4* y4 = reinterpret_cast<uint4*>(y);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const uint4 val = cur[pad4(v)];
    uint32_t o[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = shoup_lazy(o[j], ni, ni_sh, r.q);        // < 2q
      if (o[j] >= r.q) o[j] -= r.q;
    }
    y4[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
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
// dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned cluster, int buffers, int logC,
                   long long rows, int logn, void* stream, Args... args) {
  const int S = 1 << (logn - logC);
  const size_t smem = sizeof(uint32_t) * padded_words(S) * buffers;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t. n = 2^logn
// with 10 <= logn. Returns the cudaError_t of the launch (0 on success).
int abc_ntt_fwd(const void* in, void* out, const void* q, const void* tw,
                const void* tw_sh, long long rows, int L, int logn,
                void* stream) {
  const int logC = log_cluster(rows, logn);
  auto go = [&](auto kernel) {
    return static_cast<int>(launch(
        kernel, 1u, 1, logC, rows, logn, stream,
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
        static_cast<const uint32_t*>(tw_sh), L, logn));
  };
  switch (logC) {
    case 0: return go(ntt_fwd_kernel<0>);
    case 1: return go(ntt_fwd_kernel<1>);
    case 2: return go(ntt_fwd_kernel<2>);
    default: return go(ntt_fwd_kernel<3>);
  }
}

int abc_ntt_inv(const void* in, void* out, const void* q, const void* tw,
                const void* tw_sh, const void* ninv, const void* ninv_sh,
                long long rows, int L, int logn, void* stream) {
  const int logC = log_cluster(rows, logn);
  return static_cast<int>(launch(
      ntt_inv_kernel, 1u << logC, logC > 0 ? 2 : 1, logC, rows, logn, stream,
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(ninv),
      static_cast<const uint32_t*>(ninv_sh), L, logn, logC));
}

// CTAs per row that a launch of this shape uses (what abc_ntt_fwd and
// abc_ntt_inv pick).
int abc_ntt_cluster_size(long long rows, int logn) {
  return 1 << log_cluster(rows, logn);
}

const char* abc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
