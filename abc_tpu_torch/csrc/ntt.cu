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

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

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

// The mirror image of ntt_passes.cuh's fwd_pass: R inverse stages with spans t2, 2*t2, ... on the words
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

// Forward transform of chunk c = blockIdx.x % C of row blockIdx.x / C,
// C = 2^LOGC: ntt_passes.cuh's fwd_body with the transform's butterfly.
template <int LOGC>
__global__ void __launch_bounds__(kMaxThreads)
ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh, int L, int logn) {
  fwd_body<LOGC>(in, out, qs, tw, tw_sh, L, logn, CtButterfly{});
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

// Allows every kernel of this file the most dynamic shared memory a launch
// takes (ntt_passes.cuh: allow_max_smem); the library's loader calls it once.
int abc_ntt_init() {
  for (cudaError_t err : {allow_max_smem(ntt_fwd_kernel<0>),
                          allow_max_smem(ntt_fwd_kernel<1>),
                          allow_max_smem(ntt_fwd_kernel<2>),
                          allow_max_smem(ntt_fwd_kernel<3>),
                          allow_max_smem(ntt_inv_kernel)}) {
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
