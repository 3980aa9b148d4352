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
// components (negated, for rns_ew_neg).
//
// What bounds it: bytes (each operand read once, the output written once;
// a product's reduce64 is a few multiply-adds a word), and, at one
// ciphertext, the latency of one launch with one DRAM round trip (about
// 1.9 us on an H100). The design: a thread takes U quads of 4
// coefficients of one output line (U = 1 or 2, the host's choice by the
// launch's size: quads_arg), kThreads quads apart, so that every 16-byte
// load and store of a warp is coalesced along n and all U quads of a and
// of b are in flight before the first arithmetic. The line's row,
// component and limb come from 32-bit indices by a multiply and a shift
// (Div, rns_common.cuh), not the 64-bit division routine that `% L`,
// `/ C` and `% rows` on 64-bit indices called before the first load. A
// programmatic dependent launch (the tables read while the launch before
// drains, the operands after griddepcontrol.wait) was measured in a
// mult+relin, a hamming and a LaplaceSharpening replay: no gain in the
// first two, 1.5% slower in the third (PERF.md, K9b); it is not used.
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
// threads an SM holds of these kernels (few registers, no shared memory)
constexpr long long kResident = 2048;

enum Op { kAdd, kSub, kMul, kNeg };

// An operand read where it lies: output row r reads its row r mod rows.
struct Operand {
  const uint32_t* p;
  Div rows;
  long long row, comp, limb;
};

struct EwArgs {
  Operand a, b;
  int b_col;
  const uint32_t* w;
  uint32_t* out;
  const uint32_t* q;
  const uint64_t* ratio;
  uint32_t quads;                               // rows C L n / 4 < 2^31
  Div C, L;
  int first, logn;
};

__device__ __forceinline__ const uint32_t* row_of(const Operand& o,
                                                  uint32_t r, int c, int l) {
  const uint32_t own = r - quot(r, o.rows) * o.rows.d;
  return o.p + static_cast<size_t>(own) * o.row + c * o.comp + l * o.limb;
}

template <Op O>
__device__ __forceinline__ uint32_t apply(uint32_t x, uint32_t y, uint32_t m,
                                          uint64_t ra) {
  if (O == kSub) return sub_mod(x, y, m);
  if (O == kMul) return mul_mod(x, y, m, ra);
  return add_mod(x, y, m);                      // kAdd, kNeg's c0 addend
}

// out = a O b, or -a (+ b on component 0) for kNeg, over U quads of one
// line: quads t + i kThreads (i < U) of the launch, t the thread's first.
template <Op O, int U>
__device__ __forceinline__ void ew_body(const EwArgs& e) {
  const int qlog = e.logn - 2;
  const uint32_t t = blockIdx.x * (kThreads * U) + threadIdx.x;
  if (t >= e.quads) return;
  const uint32_t line = t >> qlog;              // (row C + c) L + l
  const uint32_t rc = quot(line, e.L);
  const int l = static_cast<int>(line - rc * e.L.d);
  const uint32_t row = quot(rc, e.C);
  const int c = static_cast<int>(rc - row * e.C.d);
  const bool with_b = e.b.p != nullptr && (!e.first || c == 0);
  const bool times_w = with_b && e.w != nullptr;
  const uint32_t m = ld(e.q + l);
  const uint64_t ra =
      with_b && (O == kMul || times_w) ? ld64(e.ratio + l) : 0;
  const uint32_t f = times_w ? ld(e.w + l) : 0;
  const uint32_t* ap = row_of(e.a, row, c, l);
  const uint32_t* bp = with_b ? row_of(e.b, row, c, l) : nullptr;
  const uint32_t mask = (1u << qlog) - 1;
  uint4 x[U], y[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    x[i] = ld4(ap + static_cast<size_t>((t + i * kThreads) & mask) * 4);
  }
  if (with_b) {
    if (e.b_col) {
      const uint32_t v = ld(bp);
#pragma unroll
      for (int i = 0; i < U; ++i) y[i] = make_uint4(v, v, v, v);
    } else {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        y[i] = ld4(bp + static_cast<size_t>((t + i * kThreads) & mask) * 4);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
    uint4 v = x[i];
    if (O == kNeg) {
      v = make_uint4(neg_mod(v.x, m), neg_mod(v.y, m), neg_mod(v.z, m),
                     neg_mod(v.w, m));
    }
    if (with_b) {
      uint4 b = y[i];
      if (times_w) {
        b = make_uint4(mul_mod(b.x, f, m, ra), mul_mod(b.y, f, m, ra),
                       mul_mod(b.z, f, m, ra), mul_mod(b.w, f, m, ra));
      }
      v = make_uint4(apply<O>(v.x, b.x, m, ra), apply<O>(v.y, b.y, m, ra),
                     apply<O>(v.z, b.z, m, ra), apply<O>(v.w, b.w, m, ra));
    }
    st4(e.out + (static_cast<size_t>(line) << e.logn) +
            static_cast<size_t>((t + i * kThreads) & mask) * 4,
        v);
  }
}

#define RNS_EW_KERNEL(name, op)                                      \
  template <int U>                                                   \
  __global__ void __launch_bounds__(kThreads) name(const EwArgs e) { \
    ew_body<op, U>(e);                                               \
  }

RNS_EW_KERNEL(rns_ew_add_kernel, kAdd)
RNS_EW_KERNEL(rns_ew_sub_kernel, kSub)
RNS_EW_KERNEL(rns_ew_mul_kernel, kMul)
RNS_EW_KERNEL(rns_ew_neg_kernel, kNeg)

#undef RNS_EW_KERNEL

template <int U, typename Go>
cudaError_t by_op(int op, Go go) {
  switch (op) {
    case kAdd: return go(rns_ew_add_kernel<U>);
    case kSub: return go(rns_ew_sub_kernel<U>);
    case kMul: return go(rns_ew_mul_kernel<U>);
    default: return go(rns_ew_neg_kernel<U>);
  }
}

// The instantiation of op for U quads a thread, passed to `go`.
template <typename Go>
cudaError_t by_kernel(int op, int U, Go go) {
  return U == 2 ? by_op<2>(op, go) : by_op<1>(op, go);
}

// Quads a thread for a launch of `quads` quads of lines of n = 2^logn on
// `sms` SMs: 2 where the launch fills the card (every SM holding kResident
// threads of a thread a quad), else 1; and 1 where a block's kThreads U
// quads would not fit one line (n < 1024), so that a thread's quads share
// its line and no block is ragged. Measured on an H100 (PERF.md, K9b): 2
// at B=64 of (8192, 6) read fastest, 4 slower; 1 at one ciphertext.
int quads_arg(long long quads, int logn, int sms) {
  return quads >= sms * kResident &&
                 ((static_cast<long long>(kThreads) * 2) << 2) <=
                     (1LL << logn)
             ? 2
             : 1;
}

// A launch of `kernel` on `stream`: `grid` blocks of kThreads.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned grid, void* stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool strides_ok(long long rows, long long row, long long comp,
                long long limb) {
  return rows >= 1 && rows < (1LL << 31) && row >= 0 && comp >= 0 &&
         limb >= 0 && row % 4 == 0 && comp % 4 == 0 && limb % 4 == 0;
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
// ones, every row 16-byte aligned, the output under 2^31 quads; `stream` is
// a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success); a shape the kernel does not
// take returns cudaErrorInvalidValue.
int abc_rns_ew(int op, const void* a, long long a_rows, long long a_row,
               long long a_comp, long long a_limb, const void* b,
               long long b_rows, long long b_row, long long b_comp,
               long long b_limb, int b_col, const void* w, void* out,
               const void* q, const void* ratio, long long rows, int C, int L,
               int first, int logn, void* stream) {
  if (logn < 2 || logn > 30 || rows < 0 || C < 1 || L < 1 || op < kAdd ||
      op > kNeg || a == nullptr ||
      !strides_ok(a_rows, a_row, a_comp, a_limb) || rows % a_rows != 0 ||
      (b == nullptr && (op != kNeg || first)) ||
      (b == nullptr && w != nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (b != nullptr &&
      (b_rows < 1 || b_rows >= (1LL << 31) || rows % b_rows != 0 ||
       (!b_col && !strides_ok(b_rows, b_row, b_comp, b_limb)) ||
       (op == kNeg && !first))) {
    return cudaErrorInvalidValue;
  }
  const long long lines = rows * C * L;
  if (lines >= (1LL << 31) || (lines << logn) / 4 >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const long long quads = (lines << logn) / 4;
  if (quads == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int U = quads_arg(quads, logn, sms);
  EwArgs e = {};
  e.a = {static_cast<const uint32_t*>(a), div_by(a_rows), a_row, a_comp,
         a_limb};
  e.b = {static_cast<const uint32_t*>(b), div_by(b == nullptr ? 1 : b_rows),
         b_row, b_comp, b_limb};
  e.b_col = b_col;
  e.w = static_cast<const uint32_t*>(w);
  e.out = static_cast<uint32_t*>(out);
  e.q = static_cast<const uint32_t*>(q);
  e.ratio = static_cast<const uint64_t*>(ratio);
  e.quads = static_cast<uint32_t>(quads);
  e.C = div_by(C);
  e.L = div_by(L);
  e.first = first;
  e.logn = logn;
  const long long per_block = static_cast<long long>(kThreads) * U;
  const auto grid = static_cast<unsigned>((quads + per_block - 1) / per_block);
  return static_cast<int>(by_kernel(op, U, [&](auto kernel) {
    return launch(kernel, grid, stream, e);
  }));
}

// The launch that abc_rns_ew makes for op over `lines` output rows of n =
// 2^logn (rows C L), into info[6]: the quads a thread (U), 0, threads a
// block, blocks, and the instantiation's theoretical occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): blocks and warps an SM.
// Returns the cudaError_t of the queries.
int abc_ew_launch_info(int op, long long lines, int logn, long long* info) {
  if (logn < 2 || logn > 30 || lines < 0 || op < kAdd || op > kNeg) {
    return cudaErrorInvalidValue;
  }
  const long long quads = (lines << logn) / 4;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  const int U = err == cudaSuccess ? quads_arg(quads, logn, sms) : 1;
  if (err == cudaSuccess) {
    err = by_kernel(op, U, [&](auto kern) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                           kThreads, 0);
    });
  }
  const long long per_block = static_cast<long long>(kThreads) * U;
  info[0] = U;
  info[1] = 0;
  info[2] = kThreads;
  info[3] = (quads + per_block - 1) / per_block;
  info[4] = per_sm;
  info[5] = static_cast<long long>(per_sm) * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
