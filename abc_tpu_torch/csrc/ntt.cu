// Negacyclic NTT kernels over RNS limbs for Hopper (sm_90a).
//
// Replaces the TPU kernels of abc_tpu/ops/pallas_ntt.py:
//   ntt_fwd  <- pallas_fwd_ntt / pallas_fwd_ntt_fp  (kernel body _fwd_kernel)
//   ntt_inv  <- pallas_inv_ntt / pallas_inv_ntt_fp  (kernel body _inv_kernel)
// The two TPU variants of each transform existed only to fit VMEM and the
// TPU's table bandwidth; here one kernel reads the [L, n] psi^brv twiddle
// tables and their Shoup companions directly, indexed m + block exactly as
// abc_tpu/crypto/ntt.py:_fwd_stages/_inv_stages index them.
//
// Data: a row-major [rows, n] array of uint32 residues (the port stores them
// as int32; every prime is below 2^30, so the bits are the same). Row r uses
// modulus index r % L. Outputs are canonical in [0, q), hence bit-identical
// to the np64/jx32/Pallas transforms whatever lazy reduction runs inside.
//
// Design (deliberately simple first version): one CTA per row; the row lives
// in dynamic shared memory (4n bytes: 32 KB at n=8192, 64 KB at n=16384,
// 128 KB at n=32768) across all log2(n) stages; threads stride over the n/2
// butterflies of each stage with __syncthreads() between stages; products
// are Shoup products via __umulhi. Forward: Harvey lazy butterflies with
// values in [0, 4q). Inverse: Gentleman-Sande with values in [0, 2q) and a
// final n^-1 Shoup scale.
//
// What bounds it on this card: one mult+relin at n=8192 launches its
// transforms with at most 42 rows each, i.e. at most 42 CTAs on 132 SMs, so
// the kernel is occupancy- and launch-bound, not HBM-bound (one 32 KB read
// and write per row). Register-resident radix-4/8 stages, several rows per
// CTA and fusion with the surrounding RNS chains are later work.

#include "ntt_common.cuh"

namespace {

__global__ void ntt_fwd_kernel(const uint32_t* __restrict__ in,
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

  // stage with m blocks of span 2t: u = s[2tb+o], v = s[2tb+t+o], twiddle
  // w[m+b]; invariant s < 4q (4q < 2^32 for 30-bit primes)
  for (int m = 1, logt = logn - 1; m < n; m <<= 1, --logt) {
    const int t = 1 << logt;
    for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
      const int b = j >> logt;
      const int i0 = (b << (logt + 1)) + (j & (t - 1));
      const int i1 = i0 + t;
      uint32_t u = s[i0];
      if (u >= two_q) u -= two_q;                                // < 2q
      const uint32_t v = shoup_lazy(s[i1], w[m + b], wsh[m + b], q);  // < 2q
      s[i0] = u + v;                                             // < 4q
      s[i1] = u + two_q - v;                                     // < 4q
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t r = s[i];
    if (r >= two_q) r -= two_q;
    if (r >= q) r -= q;
    y[i] = r;
  }
}

__global__ void ntt_inv_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ qs,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ tw_sh,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ ninv_sh,
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

  // Gentleman-Sande, m = n/2 .. 1; invariant s < 2q
  for (int m = n >> 1, logt = 0; m >= 1; m >>= 1, ++logt) {
    const int t = 1 << logt;
    for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
      const int b = j >> logt;
      const int i0 = (b << (logt + 1)) + (j & (t - 1));
      const int i1 = i0 + t;
      const uint32_t u = s[i0];
      const uint32_t v = s[i1];
      uint32_t sum = u + v;                                      // < 4q
      if (sum >= two_q) sum -= two_q;                            // < 2q
      s[i0] = sum;
      s[i1] = shoup_lazy(u + two_q - v, w[m + b], wsh[m + b], q);  // < 2q
    }
    __syncthreads();
  }

  const uint32_t ni = ninv[l];
  const uint32_t ni_sh = ninv_sh[l];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t r = shoup_lazy(s[i], ni, ni_sh, q);
    if (r >= q) r -= q;
    y[i] = r;
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
int abc_ntt_fwd(const void* in, void* out, const void* q, const void* tw,
                const void* tw_sh, long long rows, int L, int logn,
                void* stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = prepare(ntt_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<static_cast<unsigned>(rows), threads_for(1 << logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh), L, logn);
  return static_cast<int>(cudaGetLastError());
}

int abc_ntt_inv(const void* in, void* out, const void* q, const void* tw,
                const void* tw_sh, const void* ninv, const void* ninv_sh,
                long long rows, int L, int logn, void* stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = prepare(ntt_inv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_kernel<<<static_cast<unsigned>(rows), threads_for(1 << logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(ninv),
      static_cast<const uint32_t*>(ninv_sh), L, logn);
  return static_cast<int>(cudaGetLastError());
}

const char* abc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
