// RNS elementwise kernels for Hopper (sm_90a): K9b of the port, the modular
// add, subtract, negate and multiply of ciphertexts and plaintexts in
// abc_tpu_torch/crypto/bfv.py, crypto/ckks.py, crypto/ntt.py and
// crypto/rlwe.py.
//
// On the TPU these were never Pallas kernels: the reference's jx32 engine
// (abc_tpu/ops/modarith.py:116 add, :122 sub, :127 neg, :132 mul) runs under
// jax.jit, and XLA fused each chain into the program's own kernels.
// Replaces:
//   rns_ew_add <- BfvContext.add and add_plain (abc_tpu/crypto/bfv.py:802,
//                 :817), CkksContext.add (abc_tpu/crypto/ckks.py:624)
//   rns_ew_sub <- BfvContext.sub and sub_plain (bfv.py:806, :821),
//                 CkksContext.sub (ckks.py:629)
//   rns_ew_neg <- BfvContext.negate and sub_from_plain (bfv.py:809, :825)
//   rns_ew_mul <- BfvContext._plain_dm and multiply_plain (bfv.py:812,
//                 :831), CkksContext's integer multiply and multiply_plain
//                 (ckks.py:718, :761)
//
// Data: out [rows, C, L, n] uint32 residues (the port stores them as int32;
// every modulus is below 2^30), n = 2^logn >= 4, limb l over q[l]; `rows`
// flattens every axis before the component axis C. Each operand is read
// where it lies (struct Operand): row r, component c, limb l at p + (r %
// rows) row + c comp + l limb words, so that a batch's component, a
// level's limbs of a wider ciphertext, a plaintext broadcast over the
// batch and the components ([L, n], limb stride n) or over the limbs too
// (an [n] coefficient vector, limb stride 0) and an operand with fewer
// leading rows (broadcast over the outer ones) need no copy. b may be a
// column (`b_col`): one word per limb for all n coefficients, a constant
// such as m mod q_l of the CKKS integer multiply. w, if given, multiplies b
// first (b w mod q: Delta m of a BFV plaintext). The component-0 form
// (`first`) applies the op with b to component 0 only and copies the other
// components (negated, for rns_ew_neg). A thread takes a quad of 4
// coefficients of one output row: 16-byte loads and stores coalesced
// along n.
//
// Every word written is canonical in [0, q) and equal to the plain torch
// version's (abc_tpu_torch/ops/elementwise_kernels.py: the t64 engine of
// ops/modarith.py): a sum is one conditional subtract, a difference one
// conditional add, a negation keeps 0 at 0, a product of two residues is
// reduced by reduce64 (rns_common.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Op { kAdd, kSub, kMul, kNeg };

struct Operand {
  const uint32_t* p;
  long long rows, row, comp, limb;
};

__device__ __forceinline__ const uint32_t* row_of(const Operand& o,
                                                  long long r, int c,
                                                  int l) {
  return o.p + (r % o.rows) * o.row + c * o.comp + l * o.limb;
}

template <Op O>
__device__ __forceinline__ uint32_t apply(uint32_t x, uint32_t y, uint32_t m,
                                          uint64_t ra) {
  if (O == kSub) return sub_mod(x, y, m);
  if (O == kMul) return mul_mod(x, y, m, ra);
  return add_mod(x, y, m);                      // kAdd, kNeg's c0 addend
}

// out = a O b, or -a (+ b on component 0) for kNeg.
template <Op O>
__device__ __forceinline__ void ew_body(
    const Operand& a, const Operand& b, int b_col,
    const uint32_t* __restrict__ w, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ q, const uint64_t* __restrict__ ratio,
    long long quads, int C, int L, int first, int logn) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= quads) return;
  const At at = at_of(t, logn);                 // line = (row C + c) L + l
  const int l = static_cast<int>(at.line % L);
  const long long rc = at.line / L;
  const int c = static_cast<int>(rc % C);
  const long long row = rc / C;
  const uint32_t m = ld(q + l);
  uint4 x = ld4(row_of(a, row, c, l) + at.c);
  if (O == kNeg) {
    x = make_uint4(neg_mod(x.x, m), neg_mod(x.y, m), neg_mod(x.z, m),
                   neg_mod(x.w, m));
  }
  if (b.p != nullptr && (!first || c == 0)) {
    const uint32_t* bp = row_of(b, row, c, l);
    uint4 y;
    if (b_col) {
      const uint32_t v = ld(bp);
      y = make_uint4(v, v, v, v);
    } else {
      y = ld4(bp + at.c);
    }
    const uint64_t ra = (O == kMul || w != nullptr) ? ld64(ratio + l) : 0;
    if (w != nullptr) {
      const uint32_t f = ld(w + l);
      y = make_uint4(mul_mod(y.x, f, m, ra), mul_mod(y.y, f, m, ra),
                     mul_mod(y.z, f, m, ra), mul_mod(y.w, f, m, ra));
    }
    x = make_uint4(apply<O>(x.x, y.x, m, ra), apply<O>(x.y, y.y, m, ra),
                   apply<O>(x.z, y.z, m, ra), apply<O>(x.w, y.w, m, ra));
  }
  st4(out + (static_cast<size_t>(at.line) << logn) + at.c, x);
}

#define RNS_EW_KERNEL(name, op)                                              \
  __global__ void __launch_bounds__(kThreads)                                \
      name(Operand a, Operand b, int b_col, const uint32_t* __restrict__ w, \
           uint32_t* __restrict__ out, const uint32_t* __restrict__ q,      \
           const uint64_t* __restrict__ ratio, long long quads, int C,      \
           int L, int first, int logn) {                                    \
    ew_body<op>(a, b, b_col, w, out, q, ratio, quads, C, L, first, logn);   \
  }

RNS_EW_KERNEL(rns_ew_add_kernel, kAdd)
RNS_EW_KERNEL(rns_ew_sub_kernel, kSub)
RNS_EW_KERNEL(rns_ew_mul_kernel, kMul)
RNS_EW_KERNEL(rns_ew_neg_kernel, kNeg)

#undef RNS_EW_KERNEL

template <typename Go>
cudaError_t by_op(int op, Go go) {
  switch (op) {
    case kAdd: return go(rns_ew_add_kernel);
    case kSub: return go(rns_ew_sub_kernel);
    case kMul: return go(rns_ew_mul_kernel);
    default: return go(rns_ew_neg_kernel);
  }
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

bool strides_ok(long long rows, long long row, long long comp,
                long long limb) {
  return rows >= 1 && row >= 0 && comp >= 0 && limb >= 0 && row % 4 == 0 &&
         comp % 4 == 0 && limb % 4 == 0;
}

}  // namespace

extern "C" {

// K9b: out [rows, C, L, n] = a op b mod q (op: 0 add, 1 sub, 2 mul, 3 neg:
// -a, plus b on component 0 where b is given). a and b as struct Operand
// reads them: (pointer, rows, then the row, component and limb strides in
// words); their rows divide `rows`; a's strides multiples of 4, and b's
// unless b_col (b one word a limb). b null only for neg; w [L] uint32 or
// null; first: the component-0 form (needs b). q [L] uint32 and ratio [L]
// uint64 (floor(2^64 / q)). All pointers are device pointers but null
// ones, every row 16-byte aligned; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success); a shape the kernel does not
// take returns cudaErrorInvalidValue.
int abc_rns_ew(int op, const void* a, long long a_rows, long long a_row,
               long long a_comp, long long a_limb, const void* b,
               long long b_rows, long long b_row, long long b_comp,
               long long b_limb, int b_col, const void* w, void* out,
               const void* q, const void* ratio, long long rows, int C, int L,
               int first, int logn, void* stream) {
  if (logn < 2 || rows < 0 || C < 1 || L < 1 || op < kAdd || op > kNeg ||
      a == nullptr || !strides_ok(a_rows, a_row, a_comp, a_limb) ||
      rows % a_rows != 0 || (b == nullptr && (op != kNeg || first)) ||
      (b == nullptr && w != nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (b != nullptr &&
      (b_rows < 1 || rows % b_rows != 0 ||
       (!b_col && !strides_ok(b_rows, b_row, b_comp, b_limb)) ||
       (op == kNeg && !first))) {
    return cudaErrorInvalidValue;
  }
  const Operand oa = {static_cast<const uint32_t*>(a), a_rows, a_row, a_comp,
                      a_limb};
  const Operand ob = {static_cast<const uint32_t*>(b), b == nullptr ? 1
                                                                    : b_rows,
                      b_row, b_comp, b_limb};
  const long long quads = ((rows * C * L) << logn) / 4;
  return static_cast<int>(by_op(op, [&](auto kernel) {
    return launch(kernel, quads, stream, oa, ob, b_col,
                  static_cast<const uint32_t*>(w),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(q),
                  static_cast<const uint64_t*>(ratio), quads, C, L, first,
                  logn);
  }));
}

// The launch that abc_rns_ew makes for op over `lines` output rows of n =
// 2^logn (rows C L), into info[6]: 0, 0, threads a block, blocks, and the
// kernel's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM. Returns the cudaError_t of the query.
int abc_ew_launch_info(int op, long long lines, int logn, long long* info) {
  if (logn < 2 || lines < 0 || op < kAdd || op > kNeg) {
    return cudaErrorInvalidValue;
  }
  int per_sm = 0;
  const cudaError_t err = by_op(op, [&](auto kern) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0);
  });
  const long long quads = (lines << logn) / 4;
  info[0] = 0;
  info[1] = 0;
  info[2] = kThreads;
  info[3] = (quads + kThreads - 1) / kThreads;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
