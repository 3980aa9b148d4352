"""abc_tpu_torch.ops.behz_kernels (K3, the BEHZ multiply): the plain torch
versions against abc_tpu's BehzContext word for word (np64, and jx32 on the
CPU), a numpy uint64 model of the kernels' own arithmetic (Shoup products,
64-bit Barrett, the packed tables of csrc/behz.cu) against the plain
versions, the kernel source itself compiled for the host against a stub
runtime, the CPU routing, and, on a CUDA device, each kernel against its
plain version.

Inputs are drawn with numpy from a seed; residues are integers, so the
tolerance is exact equality.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from abc_tpu.crypto.behz import BehzContext as RefBehz
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.behz import BehzContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import behz_kernels as bk
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops.modarith import as_residues, barrett_ratio, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

M64 = (1 << 64) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(n, L, cls=BfvParams, **kw):
    """L data primes of 30 bits and one special prime at ring degree n, t of
    20 bits (the presets' shape, at any L)."""
    t = gen_ntt_primes(20, 1, n)[0]
    primes = gen_ntt_primes(30, L + 1, n, exclude=[t])
    return cls(n=n, coeff_modulus=primes, plain_modulus=t, **kw)


def _port(params, device="cpu"):
    return BehzContext(params, NttContext(params.n, params.data_primes,
                                          device))


def _rand(moduli, lead, n, seed, edge=None):
    """uint32 residues [*lead, len(moduli), n]; edge "zero" / "max" (q-1)."""
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    shape = tuple(lead) + (len(moduli), n)
    if edge == "zero":
        return np.zeros(shape, np.uint32)
    if edge == "max":
        return np.broadcast_to(q - 1, shape).astype(np.uint32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, q, size=shape, dtype=np.uint64).astype(np.uint32)


def _ref_tensor(ref, f1, f2, base):
    """The reference's tensor product (the closure in
    abc_tpu/crypto/behz.py:multiply), its engine's words."""
    e = ref.engine
    q, mu = (ref.q_cols, ref.mu_q) if base == "q" else \
        (ref.bsk_cols, ref.mu_bsk)
    return np.stack([np.asarray(v) for v in (
        e.mul(f1[0], f2[0], q, mu),
        e.add(e.mul(f1[0], f2[1], q, mu), e.mul(f1[1], f2[0], q, mu), q),
        e.mul(f1[1], f2[1], q, mu))])


def _port_tensor(bz, f1, f2, base):
    ntt = bz.ntt_q if base == "q" else bz.ntt_bsk
    got, = bk.behz_tensor((as_residues(f1, "cpu"), as_residues(f2, "cpu"),
                           ntt.q_col, ntt.ratio))
    return to_host(got)


# ------------------------------------------------- plain vs the reference

def _hold_chains(port, ref, lead, seed, xp=np):
    """Every chain of the port's plain path against the reference on the
    same residues: to_bsk, tensor over q and over Bsk, fast_floor,
    from_bsk."""
    L, n = port.params.L, port.params.n
    qs, bsk = port.params.data_primes, port.bsk
    x = _rand(qs, lead + (2,), n, seed)
    np.testing.assert_array_equal(
        to_host(port._to_bsk(as_residues(x, "cpu"))),
        np.asarray(ref._to_bsk(xp.asarray(x))))
    e_q = _rand(qs, lead + (3,), n, seed + 1)
    e_b = _rand(bsk, lead + (3,), n, seed + 2)
    np.testing.assert_array_equal(
        to_host(port._fast_floor(as_residues(e_q, "cpu"),
                                 as_residues(e_b, "cpu"))),
        np.asarray(ref._fast_floor(xp.asarray(e_q), xp.asarray(e_b))))
    np.testing.assert_array_equal(
        to_host(port._from_bsk(as_residues(e_b, "cpu"))),
        np.asarray(ref._from_bsk(xp.asarray(e_b))))
    for base, mods in (("q", qs), ("bsk", bsk)):
        f1 = _rand(mods, lead + (2,), n, seed + 3)
        f2 = _rand(mods, lead + (2,), n, seed + 4)
        want = np.stack([_ref_tensor(ref, xp.asarray(a), xp.asarray(b), base)
                         for a, b in zip(f1.reshape((-1,) + f1.shape[-3:]),
                                         f2.reshape((-1,) + f2.shape[-3:]))])
        got = _port_tensor(port, f1, f2, base)
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert L == len(qs)


def _hold_multiply(port, ref, lead, seed, xp=np):
    """BehzContext.multiply of two ciphertexts of random residues (each row
    of a batch against a reference call of its own)."""
    n, qs = port.params.n, port.params.data_primes
    a, b = (_rand(qs, lead + (2,), n, seed + s) for s in (5, 6))
    got = to_host(port.multiply(
        port.precompute_operand(as_residues(a, "cpu")),
        port.precompute_operand(as_residues(b, "cpu"))))
    flat = got.reshape((-1,) + got.shape[-3:])
    for i, (ra, rb) in enumerate(zip(a.reshape((-1,) + a.shape[-3:]),
                                     b.reshape((-1,) + b.shape[-3:]))):
        np.testing.assert_array_equal(
            flat[i], np.asarray(ref.multiply(xp.asarray(ra), xp.asarray(rb))))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_plain_chains_match_np64(lead):
    params = BfvParams.create(1024, seed=3)
    ref = RefBehz(RefBfvParams.create(1024, seed=3, engine="np64"))
    port = _port(params)
    assert port.bsk == ref.bsk
    _hold_chains(port, ref, lead, seed=10)
    _hold_multiply(port, ref, lead, seed=10)


@pytest.fixture(scope="module")
def jx32_ref():
    pytest.importorskip("jax")
    return RefBehz(RefBfvParams.create(1024, seed=3, engine="jx32"))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_plain_chains_match_jx32(jx32_ref, lead):
    import jax.numpy as jnp
    port = _port(BfvParams.create(1024, seed=3))
    _hold_chains(port, jx32_ref, lead, seed=20, xp=jnp)
    if not lead:
        _hold_multiply(port, jx32_ref, lead, seed=20, xp=jnp)


@pytest.mark.parametrize("L", [17, 27, 65])
def test_plain_chains_match_np64_past_16_limbs(L):
    """L >= 17: from_bsk sums L+1 >= 18 products per word, past what a
    64-bit accumulator holds unreduced (16 products below 2^60); 27 is the
    largest L of BfvParams.create (n=32768), here at n=2048; 65 is past the
    64 source limbs of one chunk of the kernels."""
    ref = RefBehz(_params(2048, L, RefBfvParams, engine="np64"))
    port = _port(_params(2048, L))
    assert port.bsk == ref.bsk and len(port.bsk) == L + 2
    _hold_chains(port, ref, (), seed=L)
    _hold_multiply(port, ref, (), seed=L)


def test_to_bsk_n8192_spot_check():
    """One spot check at the main path's preset (n=8192, L=6)."""
    params = BfvParams.create(8192, seed=11)
    ref = RefBehz(RefBfvParams.create(8192, seed=11, engine="np64"))
    port = _port(params)
    x = _rand(params.data_primes, (2,), 8192, seed=8192)
    np.testing.assert_array_equal(to_host(port._to_bsk(as_residues(x, "cpu"))),
                                  ref._to_bsk(x))


def test_cpu_route_counts_no_launch():
    port = _port(BfvParams.create(1024, seed=3))
    before = dict(bk.launches)
    x = as_residues(_rand(port.params.data_primes, (2,), 1024, 0), "cpu")
    port.multiply(port.precompute_operand(x), port.precompute_operand(x))
    assert bk.launches == before
    assert set(before) == {"behz_to_bsk", "behz_tensor", "behz_fast_floor",
                           "behz_from_bsk"}


def test_a_tensor_off_the_cpu_is_never_taken_by_the_plain_path():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks (here a meta tensor, refused)."""
    port = _port(BfvParams.create(1024, seed=3))
    x = torch.empty((2, port.params.L, 1024), dtype=torch.int32,
                    device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port._to_bsk(x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bk.behz_tensor((x, x, port.ntt_q.q_col.to("meta"),
                        port.ntt_q.ratio.to("meta")))


def test_a_cpu_context_packs_no_kernel_tables():
    """The packed tables go to the device only where a kernel can run; their
    words, packed on demand, have csrc/behz.cu's sizes."""
    port = _port(BfvParams.create(1024, seed=3))
    L = port.params.L
    assert port.kernel_tab == {}
    sizes = {k: v.size for k, v in port.kernel_words().items()}
    head = bk.HEADER + bk.SRC_WORDS * L + bk.DST_WORDS * (L + 2)
    assert sizes == {"to_bsk": head + L * (L + 2),
                     "fast_floor": head + L * (L + 2),
                     "from_bsk": bk.HEADER + bk.SRC_WORDS * (L + 1)
                     + bk.DST_WORDS * L + (L + 1) * L}


def test_ntt_context_ratio_rides_with_its_moduli():
    """floor(2^64 / q) per modulus beside q, in the context and in every
    subset view (a prefix and a gather), read by both schemes' tensor
    products."""
    moduli = gen_ntt_primes(30, 5, 64)
    ntt = NttContext(64, moduli, "cpu")
    want = [(1 << 64) // q for q in moduli]
    assert ntt.ratio.numpy().view(np.uint64).tolist() == want
    for idx in ([0, 1, 2], [4, 0, 3]):
        view = ntt.subset(idx)
        assert view.ratio.numpy().view(np.uint64).tolist() == \
            [want[i] for i in idx]
        assert view.ratio.shape[0] == view.q_col.shape[0]


# ---------------------------------- the kernels' arithmetic, modelled in numpy

def _u(a):
    return np.asarray(a, dtype=np.uint64)


def _umul64hi(a, b):
    """High 64 bits of the 128-bit product of uint64 arrays (numpy wraps
    uint64 arithmetic mod 2^64)."""
    m = np.uint64(0xFFFFFFFF)
    s = np.uint64(32)
    a0, a1, b0, b1 = a & m, a >> s, b & m, b >> s
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> s) + (p01 & m) + (p10 & m)
    return p11 + (p01 >> s) + (p10 >> s) + (mid >> s)


def _reduce64(x, q, ratio):
    quot = _umul64hi(_u(x), _u(ratio))
    r = (_u(x) - quot * _u(q)) & np.uint64(0xFFFFFFFF)
    return np.where(r >= q, r - q, r)


def _mul_const(a, w, wsh, q):
    m = np.uint64(0xFFFFFFFF)
    hi = (_u(a) * _u(wsh)) >> np.uint64(32)
    r = (_u(a) * _u(w) - hi * _u(q)) & m
    return np.where(r >= q, r - q, r)


def _sub_mod(a, b, q):
    return np.where(a >= b, a - b, a + q - b)


class _Tables:
    """csrc/behz.cu's packed table read back: header, source and
    destination records, the conversion table."""

    def __init__(self, tab, K, D):
        w = np.asarray(tab, dtype=np.uint32).astype(np.uint64)
        self.head = w[:bk.HEADER]
        at = bk.HEADER
        self.src = w[at:at + bk.SRC_WORDS * K].reshape(K, bk.SRC_WORDS)
        at += bk.SRC_WORDS * K
        self.dst = w[at:at + bk.DST_WORDS * D].reshape(D, bk.DST_WORDS)
        at += bk.DST_WORDS * D
        self.T = w[at:].reshape(K, D)

    @staticmethod
    def ratio(rec):
        return rec[1] | (rec[2] << np.uint64(32))


def _convert(y, T, d, q, ratio):
    """Σ y_i·T[i, d] mod q, reduced after every 16 products (y: [K, W])."""
    acc = np.zeros(y.shape[1:], np.uint64)
    for i in range(y.shape[0]):
        acc = acc + y[i] * T[i, d]
        if i % 16 == 15 and i + 1 < y.shape[0]:
            acc = _reduce64(acc, q, ratio)
    return _reduce64(acc, q, ratio)


def model_to_bsk(tab, x, K, D):
    t = _Tables(tab, K, D)
    x = _u(x)
    y = np.stack([_mul_const(x[i], *t.src[i, [1, 2, 0]]) for i in range(K)])
    mask = np.uint64(0xFFFF)
    s = np.zeros(x.shape[1:], np.uint64)
    for i in range(K):
        s = (s + (y[i] & mask) * t.src[i, 3]) & np.uint64(0xFFFFFFFF)
    r = ((s & mask) * t.head[0]) & mask
    out = []
    for d in range(D):
        b, ratio = t.dst[d, 0], _Tables.ratio(t.dst[d])
        r_b = np.where(r >= np.uint64(1 << 15), r + b - np.uint64(1 << 16), r)
        v = _reduce64(_convert(y, t.T, d, b, ratio) + t.dst[d, 3] * r_b, b,
                      ratio)
        out.append(_mul_const(v, t.dst[d, 4], t.dst[d, 5], b))
    return np.stack(out)


def model_fast_floor(tab, e_q, e_b, K, D):
    """T holds -qhat_i mod b_d: the sum with (t mod b_d)·e_bsk as one more
    term is t·e_bsk - conv, times q^-1."""
    t = _Tables(tab, K, D)
    y = np.stack([_mul_const(_u(e_q[i]), *t.src[i, [1, 2, 0]])
                  for i in range(K)])
    out = []
    for d in range(D):
        b, ratio = t.dst[d, 0], _Tables.ratio(t.dst[d])
        v = _reduce64(_convert(y, t.T, d, b, ratio) + t.dst[d, 3] *
                      _u(e_b[d]), b, ratio)
        out.append(_mul_const(v, t.dst[d, 4], t.dst[d, 5], b))
    return np.stack(out)


def model_from_bsk(tab, x, K, D):
    t = _Tables(tab, K, D)
    x = _u(x)
    msk, msk_ratio = t.head[0], _Tables.ratio(t.head)
    y = np.stack([_mul_const(x[i], *t.src[i, [1, 2, 0]]) for i in range(K)])
    conv_msk = _convert(y, t.src[:, 3:4], 0, msk, msk_ratio)
    alpha = _mul_const(_sub_mod(conv_msk, x[K], msk), t.head[3], t.head[4],
                       msk)
    neg = alpha > t.head[5]
    out = []
    for j in range(D):
        q, ratio = t.dst[j, 0], _Tables.ratio(t.dst[j])
        conv = _convert(y, t.T, j, q, ratio)
        a = np.where(alpha >= q, alpha - q, alpha)
        a = np.where(neg, _sub_mod(a, t.dst[j, 4], q), a)
        corr = _reduce64(t.dst[j, 3] * a, q, ratio)
        out.append(_sub_mod(conv, corr, q))
    return np.stack(out)


def model_tensor(f1, f2, q, ratio):
    f1, f2, q = _u(f1), _u(f2), _u(q).reshape(-1, 1)
    ratio = np.asarray(ratio).view(np.uint64).reshape(-1, 1)
    a0, a1, b0, b1 = f1[0], f1[1], f2[0], f2[1]
    return np.stack([_reduce64(a0 * b0, q, ratio),
                     _reduce64(a0 * b1 + a1 * b0, q, ratio),
                     _reduce64(a1 * b1, q, ratio)])


@pytest.mark.parametrize("edge", [None, "zero", "max"])
@pytest.mark.parametrize("L", [6, 17, 27])
def test_kernel_arithmetic_model_matches_plain(L, edge):
    """The kernels' per-coefficient arithmetic (packed tables, Shoup
    products, reduce64 after every 16 products) in numpy uint64, against
    the plain versions, over random and edge residues."""
    n = 64
    port = _port(_params(n, L))
    qs, bsk = port.params.data_primes, port.bsk
    D = L + 2
    words = port.kernel_words()
    x = _rand(qs, (), n, L, edge)
    np.testing.assert_array_equal(
        model_to_bsk(words["to_bsk"], x, L, D),
        to_host(port._to_bsk_plain(as_residues(x, "cpu"))))
    e_q, e_b = _rand(qs, (), n, L + 1, edge), _rand(bsk, (), n, L + 2, edge)
    np.testing.assert_array_equal(
        model_fast_floor(words["fast_floor"], e_q, e_b, L, D),
        to_host(port._fast_floor_plain(as_residues(e_q, "cpu"),
                                       as_residues(e_b, "cpu"))))
    np.testing.assert_array_equal(
        model_from_bsk(words["from_bsk"], e_b, L + 1, L),
        to_host(port._from_bsk_plain(as_residues(e_b, "cpu"))))
    for mods, ntt in ((qs, port.ntt_q), (bsk, port.ntt_bsk)):
        f1, f2 = (_rand(mods, (2,), n, L + s, edge) for s in (3, 4))
        np.testing.assert_array_equal(
            model_tensor(f1, f2, mods, ntt.ratio.numpy()),
            to_host(bk.tensor_plain(as_residues(f1, "cpu"),
                                    as_residues(f2, "cpu"), ntt.q_col)))


def test_reduce64_model_at_the_extremes():
    """reduce64 over the whole 64-bit range, for the smallest and largest
    30-bit primes of the port and a 2-bit modulus."""
    rng = np.random.default_rng(64)
    x = np.concatenate([rng.integers(0, 1 << 63, 1000, dtype=np.uint64) * 2,
                        _u([0, 1, M64, M64 - 1, 1 << 63, (1 << 60) - 1])])
    for q in (3, (1 << 29) + 11, (1 << 30) - 35):
        got = _reduce64(x, np.uint64(q), np.uint64(barrett_ratio(q)))
        want = np.asarray([int(v) % q for v in x], dtype=np.uint64)
        np.testing.assert_array_equal(got, want)


# ------------------------- the kernel source, compiled for the host (g++)

_STUB = r"""
// Host stand-in for the CUDA runtime: a launch runs its blocks one after
// another on one std::thread per thread of a block; __syncthreads is a
// std::barrier of the block, threadIdx is thread_local and __shared__
// storage is static (one block runs at a time).
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx;
static dim3 blockIdx, blockDim, gridDim;
static std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  void* attrs;
  unsigned numAttrs;
};
template <typename T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return static_cast<unsigned long long>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K,
                                                          int threads,
                                                          size_t) {
  *blocks = 2048 / threads;
  return cudaSuccess;
}
template <typename... E, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  // one std::thread per thread of a block, reused block after block: the
  // host sets blockIdx between two steps of `step`
  const unsigned threads = cfg->blockDim.x, blocks = cfg->gridDim.x;
  blockDim = cfg->blockDim;
  gridDim = cfg->gridDim;
  std::barrier<> bar(threads), step(threads + 1);
  block_barrier = &bar;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < blocks; ++b) {
        step.arrive_and_wait();
        kernel(args...);
        step.arrive_and_wait();
      }
    });
  }
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx = dim3(b);
    step.arrive_and_wait();
    step.arrive_and_wait();
  }
  for (auto& th : pool) th.join();
  return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/behz.cu compiled by g++ against the stub runtime above."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    root = tmp_path_factory.mktemp("behz_host")
    (root / "cuda_runtime.h").write_text(_STUB)
    src = [s for s in _build.SOURCES if s.endswith("behz.cu")][0]
    lib_path = root / "libbehz_host.so"
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++",
                    f"-I{root}", f"-I{_build._CSRC}", src, "-o",
                    str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_behz(lib)
    lib.abc_behz_launch_info.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.abc_behz_launch_info.restype = ctypes.c_int
    return lib


# the first six cases kept their order since the kernels' first design;
# every L in both forms, past 64 sources (more than one chunk of the tile
# kernels; 65 and 80 need more than one pass of destinations)
HOST_CASES = [(1, ()), (6, (3,)), (16, ()), (17, (2,)), (27, ()), (63, ()),
              (1, (2,)), (6, ()), (16, (3,)), (17, ()), (27, (2,)),
              (63, (2,)), (65, (2,)), (65, ()), (80, (3,)), (80, ())]


def _hold_host_kernels(host_lib, n, L, lead):
    """The four kernels of csrc/behz.cu, run on the host, against their
    plain versions at ring degree n, L data primes, leading axes `lead`
    (a broadcast operand of the tensor product among them)."""
    logn = n.bit_length() - 1
    port = _port(_params(n, L))
    qs, bsk, D = port.params.data_primes, port.bsk, L + 2
    tab = {k: as_residues(v, "cpu") for k, v in port.kernel_words().items()}

    def run(fn, *args):
        assert fn(*args) == 0

    x = as_residues(_rand(qs, lead + (2,), n, L), "cpu")
    out = torch.empty(lead + (2, D, n), dtype=torch.int32)
    run(host_lib.abc_behz_to_bsk, x.data_ptr(), out.data_ptr(),
        tab["to_bsk"].data_ptr(), x.numel() // (L * n), L, D, logn, None)
    assert torch.equal(out, port._to_bsk_plain(x))
    e_q = as_residues(_rand(qs, lead + (3,), n, L + 1), "cpu")
    e_b = as_residues(_rand(bsk, lead + (3,), n, L + 2, "max"), "cpu")
    out = torch.empty_like(e_b)
    run(host_lib.abc_behz_fast_floor, e_q.data_ptr(), e_b.data_ptr(),
        out.data_ptr(), tab["fast_floor"].data_ptr(), e_q.numel() // (L * n),
        L, D, logn, None)
    assert torch.equal(out, port._fast_floor_plain(e_q, e_b))
    x_b = as_residues(_rand(bsk, lead + (3,), n, L + 3), "cpu")
    out = torch.empty(lead + (3, L, n), dtype=torch.int32)
    run(host_lib.abc_behz_from_bsk, x_b.data_ptr(), out.data_ptr(),
        tab["from_bsk"].data_ptr(), x_b.numel() // (D * n), L + 1, L, logn,
        None)
    assert torch.equal(out, port._from_bsk_plain(x_b))
    bases = [(as_residues(_rand(mods, lead + (2,), n, L + 4), "cpu"),
              as_residues(_rand(mods, (2,), n, L + 5), "cpu"),   # broadcast
              ntt) for mods, ntt in ((qs, port.ntt_q), (bsk, port.ntt_bsk))]
    for got, (f1, f2, ntt) in zip(_host_tensor(host_lib, bases, n), bases):
        assert torch.equal(got, bk.tensor_plain(f1, f2, ntt.q_col))


def _host_tensor(host_lib, bases, n):
    """The products of abc_behz_tensor_bases of the host build over
    `bases`, (f1, f2, NttContext) each, one or two, in one launch."""
    outs, args = [], []
    for f1, f2, ntt in bases:
        D = ntt.q_col.shape[0]
        rows1, rows2 = (f.numel() // (2 * D * n) for f in (f1, f2))
        lead = torch.broadcast_shapes(f1.shape[:-3], f2.shape[:-3])
        outs.append(torch.empty(lead + (3, D, n), dtype=torch.int32))
        args += [f1.data_ptr(), f2.data_ptr(), outs[-1].data_ptr(),
                 ntt.q_col.data_ptr(), ntt.ratio.data_ptr(), rows1, rows2, D]
    if len(bases) == 1:
        args += [None] * 5 + [0, 0, 0]
    assert host_lib.abc_behz_tensor_bases(*args, n.bit_length() - 1,
                                          None) == 0
    return outs


@pytest.mark.parametrize("L,lead", HOST_CASES)
def test_kernel_source_on_the_host_matches_plain(host_lib, L, lead):
    """The four kernels of csrc/behz.cu, run thread by thread on the host
    (n=64, so that one tile of 128 coefficients spans two rows), equal
    their plain versions: both source chunks of the tile kernels (16 and
    32), one to four destinations a thread, more than one pass over the
    destinations, and a broadcast operand of the tensor product."""
    _hold_host_kernels(host_lib, 64, L, lead)


@pytest.mark.parametrize("n,L,lead", [(4, 6, (3,)), (8, 17, ()),
                                      (128, 6, ()), (256, 6, (3,)),
                                      (512, 27, ()), (256, 65, (2,))])
def test_kernel_source_on_the_host_tiles_any_n(host_lib, n, L, lead):
    """The tile kernels at ring degrees below, at and above the tile: a
    tile of many short rows (n=4: 32 rows, the last tile part empty), one
    row exactly, rows of several tiles, and chunks and passes over rows of
    two tiles at L=65."""
    _hold_host_kernels(host_lib, n, L, lead)


@pytest.mark.parametrize("L", [1, 6, 15])
def test_kernel_source_on_the_host_warp_path(host_lib, L):
    """to_bsk and from_bsk with a warp a tile (16 sources or fewer, 2048
    tiles or more: 4096 rows of n=64), against their plain versions a slice
    of rows at a time."""
    n, lead = 64, (2048,)
    port = _port(_params(n, L))
    qs, bsk, D = port.params.data_primes, port.bsk, L + 2
    tab = {k: as_residues(v, "cpu") for k, v in port.kernel_words().items()}
    x = as_residues(_rand(qs, lead + (2,), n, L), "cpu")
    x_b = as_residues(_rand(bsk, lead + (3,), n, L + 3), "cpu")
    to = torch.empty(lead + (2, D, n), dtype=torch.int32)
    back = torch.empty(lead + (3, L, n), dtype=torch.int32)
    assert host_lib.abc_behz_to_bsk(x.data_ptr(), to.data_ptr(),
                                    tab["to_bsk"].data_ptr(), 4096, L, D, 6,
                                    None) == 0
    assert host_lib.abc_behz_from_bsk(x_b.data_ptr(), back.data_ptr(),
                                      tab["from_bsk"].data_ptr(), 6144, L + 1,
                                      L, 6, None) == 0
    for part in torch.arange(2048).split(256):
        assert torch.equal(to[part], port._to_bsk_plain(x[part]))
        assert torch.equal(back[part], port._from_bsk_plain(x_b[part]))


def _hold_host_fast_floor(host_lib, n, L, lead, edge, part=None):
    """behz_fast_floor of the host build against its plain version at ring
    degree n, L data primes, leading axes `lead`, random or edge inputs
    (e_q and e_bsk both all 0 or all q-1); the plain version a slice of
    `part` leading rows at a time."""
    port = _port(_params(n, L))
    qs, bsk, D = port.params.data_primes, port.bsk, L + 2
    tab = as_residues(port.kernel_words()["fast_floor"], "cpu")
    e_q = as_residues(_rand(qs, lead + (3,), n, L + 1, edge), "cpu")
    e_b = as_residues(_rand(bsk, lead + (3,), n, L + 2, edge), "cpu")
    out = torch.empty_like(e_b)
    assert host_lib.abc_behz_fast_floor(
        e_q.data_ptr(), e_b.data_ptr(), out.data_ptr(), tab.data_ptr(),
        e_q.numel() // (L * n), L, D, n.bit_length() - 1, None) == 0
    parts = torch.arange(lead[0]).split(part) if part else [...]
    for at in parts:
        assert torch.equal(out[at], port._fast_floor_plain(e_q[at], e_b[at]))


@pytest.mark.parametrize("n,L,lead,edge", [
    (4, 6, (3,), None), (8, 17, (), "max"), (16, 1, (), "zero"),
    (64, 1, (2,), "max"), (64, 6, (), None), (64, 15, (2,), "zero"),
    (128, 16, (), "max"), (128, 17, (2,), None), (256, 27, (), "zero"),
    (256, 27, (2,), "max"), (512, 65, (), None), (64, 65, (2,), "max"),
    (128, 80, (), "zero"), (64, 80, (3,), None)])
def test_fast_floor_source_on_the_host_block_path(host_lib, n, L, lead, edge):
    """behz_fast_floor as a block a tile (fewer than 2048 tiles), run thread
    by thread on the host: n from 4 (a tile of 32 short rows) to 512, one
    source chunk (L <= 16) or more (17, 27, 65, 80), one to four
    destinations a thread and more than one pass (65, 80), one ciphertext
    and batches, random inputs and inputs all 0 or all q-1."""
    _hold_host_fast_floor(host_lib, n, L, lead, edge)


@pytest.mark.parametrize("L,edge", [(1, None), (6, "max"), (6, "zero"),
                                    (15, None), (16, "max")])
def test_fast_floor_source_on_the_host_warp_path(host_lib, L, edge):
    """behz_fast_floor with a warp a tile (16 sources or fewer, 2048 tiles
    or more: 2048 ciphertexts of n=64, 3 rows each)."""
    _hold_host_fast_floor(host_lib, 64, L, (2048,), edge, part=128)


@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("case", ["one base", "two bases", "first one row",
                                  "second one row", "square"])
def test_tensor_source_on_the_host(host_lib, case, n):
    """behz_tensor of the host build over one base or both bases of a
    multiply in one launch, a one-row operand broadcast over the other's
    rows, and the square (the same forms twice), against tensor_plain."""
    port = _port(_params(n, 6))
    qs, bsk = port.params.data_primes, port.bsk

    def form(mods, lead, seed):
        return as_residues(_rand(mods, lead + (2,), n, seed), "cpu")

    lead1 = () if case == "first one row" else (3,)
    lead2 = () if case == "second one row" else (3,)
    bases = []
    for mods, ntt, seed in ((qs, port.ntt_q, 1), (bsk, port.ntt_bsk, 3)):
        f1 = form(mods, lead1, seed)
        f2 = f1 if case == "square" else form(mods, lead2, seed + 1)
        bases.append((f1, f2, ntt))
    bases = bases[:1] if case == "one base" else bases
    for got, (f1, f2, ntt) in zip(_host_tensor(host_lib, bases, n), bases):
        assert got.shape == (3, 3, ntt.q_col.shape[0], n)
        assert torch.equal(got, bk.tensor_plain(f1, f2, ntt.q_col))


@pytest.mark.parametrize("L,want", [(6, (1, 16, 288)), (27, (2, 32, 512)),
                                    (80, (4, 32, 512))])
def test_tile_launch_shape(host_lib, L, want):
    """The tile kernels' launch (abc_behz_launch_info): ND destinations a
    thread, KC sources a chunk, threads a block (destination warps and the
    scalar warp); a block per 128 coefficients; at 2048 tiles or more and
    16 sources or fewer a warp a tile, four a block."""
    info = (ctypes.c_longlong * 6)()
    assert host_lib.abc_behz_launch_info(0, L, L + 2, 2, 13, info) == 0
    assert tuple(info[:3]) == want and info[3] == 2 * 8192 // 128
    # a batch of 64: 8192 tiles, a warp each where the sources fit
    assert host_lib.abc_behz_launch_info(0, L, L + 2, 128, 13, info) == 0
    assert tuple(info[:4]) == ((0, 8, 128, 2048) if L == 6 else
                               want + (8192,))
    # fast_floor: the same tiles without a scalar warp, at any K
    assert host_lib.abc_behz_launch_info(1, 6, 8, 3, 13, info) == 0
    assert tuple(info[:4]) == (1, 16, 256, 3 * 8192 // 128)
    assert host_lib.abc_behz_launch_info(1, 65, 67, 3, 13, info) == 0
    assert tuple(info[:3]) == (4, 32, 480)
    assert host_lib.abc_behz_launch_info(1, 6, 8, 192, 13, info) == 0
    assert tuple(info[:4]) == (0, 8, 128, 192 * 8192 // 128 // 4)
    # its warp path from 3072 tiles (B=16 at n=8192), to_bsk's from 2048
    for kernel, rows, warp in ((1, 36, False), (1, 48, True), (0, 32, True),
                               (0, 30, False)):
        assert host_lib.abc_behz_launch_info(kernel, 6, 8, rows, 13,
                                             info) == 0
        assert (info[0] == 0) == warp, (kernel, rows)
    # tensor: base q and base Bsk in one launch, a quad a thread
    assert host_lib.abc_behz_launch_info(3, 6, 8, 1, 13, info) == 0
    assert tuple(info[:4]) == (0, 0, 128, (6 + 8) * 8192 // 4 // 128)
    assert host_lib.abc_behz_launch_info(0, 0, 2, 1, 13, info) != 0


_TO_BSK = "_ZN12_GLOBAL__N_118behz_to_bsk_kernelILi1ELi16EEEvPKjPjS2_xiii"
_PTXAS = f"""ptxas info    : Compiling entry function '{_TO_BSK}' for 'sm_90a'
ptxas info    : Function properties for {_TO_BSK}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8704 bytes smem, 400 bytes cmem[0]
"""
_SASS = f"""\tcode for sm_90a
\t\tFunction : {_TO_BSK}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   IMAD.WIDE.U32 R8, R4, R6, R8 ;
        /*0030*/                   IMAD.MOV.U32 R9, RZ, RZ, R3 ;
        /*0040*/               @P0 IMAD.HI.U32 R10, R4, R6, RZ ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   STS.128 [R0], R4 ;
        /*0070*/                   LDS.128 R4, [R0] ;
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0090*/                   EXIT ;
"""


def test_kernel_census_reads_ptxas_and_sass():
    """ops/kernel_census (printed by chip_smoke.py phase 2b beside each
    kernel's time) from ptxas -v and cuobjdump -sass text: one row per
    kernel, keyed as the launch names it."""
    from abc_tpu_torch.ops import kernel_census as kc
    table = kc.kernel_table(_PTXAS, _SASS)
    assert table == {"behz_to_bsk_kernel<1,16>": {
        "registers": 40, "smem": 8704, "spill_stores": 8, "spill_loads": 4,
        "instructions": 10, "IMAD": 2, "IMAD.WIDE": 1, "LDG": 1, "STG": 1,
        "LDS": 1, "STS": 1, "BAR": 1}}
    for demangled in ("void (anonymous namespace)::behz_to_bsk_kernel<1, "
                      "16>(unsigned int const*, int)",
                      "void <unnamed>::behz_to_bsk_kernel<(int)1, (int)16>"
                      "(const unsigned int *, int)"):
        assert kc.kernel_key(demangled) == "behz_to_bsk_kernel<1,16>"
    assert kc.kernel_key("_ZN12_GLOBAL__N_122behz_fast_floor_kernelIL"
                         "i4ELi32EEEvPKjS2_PjS2_xiii") == \
        "behz_fast_floor_kernel<4,32>"
    assert kc.kernel_key("void (anonymous namespace)::behz_fast_floor_"
                         "warp_kernel<16>(unsigned int const*)") == \
        "behz_fast_floor_warp_kernel<16>"


def test_every_launch_names_a_kernel_of_the_source(host_lib):
    """Each launch abc_behz_launch_info reports at chip_smoke.py's BEHZ
    shapes names a kernel the source instantiates (kernel_census.launch_key
    against the host build's symbols), so phase 2b finds its census."""
    from abc_tpu_torch.ops import kernel_census as kc
    import chip_smoke
    nm = subprocess.run(["nm", host_lib._name], capture_output=True,
                        text=True, check=True).stdout.split()
    keys = {kc.kernel_key(w) for w in nm
            if w.startswith("_ZN") and "_kernel" in w}
    for n, L, batch, _ in chip_smoke.BEHZ_SHAPES:
        for name in bk.launches:
            info = (ctypes.c_longlong * 6)()
            assert host_lib.abc_behz_launch_info(
                bk._INFO_KERNEL[name], *kc.launch_of(name, L, L + 2, batch),
                n.bit_length() - 1, info) == 0
            got = dict(zip(("arg0", "arg1", "threads", "blocks",
                            "blocks_per_sm", "warps_per_sm"), info))
            assert kc.launch_key(name, got) in keys, (name, n, L)


# ------------------------------------------------------------- on the card

def _card_cases(n, L, lead, dev):
    """(kernel name, kernel call, plain call) at one shape, random inputs
    with 0 and q-1 among them."""
    params = _params(n, L) if L != 6 or n != 8192 else \
        BfvParams.create(8192, seed=11)
    port, cpu = _port(params, dev), _port(params)
    qs, bsk = params.data_primes, port.bsk

    def both(moduli, shape_lead, seed):
        h = _rand(moduli, shape_lead, n, seed)
        h[..., 0] = 0
        h[..., 1::97] = (np.asarray(moduli, np.uint32) - 1).reshape(-1, 1)
        return as_residues(h, dev), as_residues(h, "cpu")

    (x, xc), (eq, eqc), (eb, ebc) = (both(qs, lead + (2,), 1),
                                     both(qs, lead + (3,), 2),
                                     both(bsk, lead + (3,), 3))
    # the precompute_operand forms of two operands, over q and over Bsk
    (fq1, fq1c), (fq2, fq2c) = both(qs, lead + (2,), 4), both(qs, lead + (2,),
                                                               5)
    (fb1, fb1c), (fb2, fb2c) = both(bsk, lead + (2,), 6), \
        both(bsk, lead + (2,), 7)
    return [
        ("behz_to_bsk", lambda: port._to_bsk(x), lambda: cpu._to_bsk(xc)),
        ("behz_fast_floor", lambda: port._fast_floor(eq, eb),
         lambda: cpu._fast_floor(eqc, ebc)),
        ("behz_from_bsk", lambda: port._from_bsk(eb),
         lambda: cpu._from_bsk(ebc)),
        ("behz_tensor", lambda: port._tensor((fq1, fb1), (fq2, fb2)),
         lambda: cpu._tensor((fq1c, fb1c), (fq2c, fb2c))),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("n,L,lead", [(8192, 6, ()), (8192, 6, (4,)),
                                      (8192, 15, (16,)),
                                      (2048, 17, ()), (2048, 27, ()),
                                      (2048, 65, (2,))])
def test_kernels_equal_plain_on_cuda(cuda, n, L, lead):
    """(8192, 15, (16,)): 2048 tiles of to_bsk's 15 sources and 3072 of
    from_bsk's 16, both on the warp path (csrc/behz.cu: tile_shape)."""
    for name, kern, plain in _card_cases(n, L, lead, cuda):
        before = bk.launches[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert bk.launches[name] == before + 1
        if name != "behz_tensor":       # both bases, one launch
            got, want = (got,), (want,)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one base", "first one row",
                                  "second one row", "square"])
def test_tensor_bases_equal_plain_on_cuda(cuda, case):
    """behz_tensor on the card over one base (as the CKKS multiply calls
    it) and over both bases with a one-row operand broadcast over a batch
    of 4, or the same forms twice, against tensor_plain."""
    port = _port(_params(8192, 6), cuda)
    lead1 = () if case == "first one row" else (4,)
    lead2 = () if case == "second one row" else (4,)
    bases = []
    for mods, ntt, seed in ((port.params.data_primes, port.ntt_q, 1),
                            (port.bsk, port.ntt_bsk, 3)):
        f1 = as_residues(_rand(mods, lead1 + (2,), 8192, seed), cuda)
        f2 = f1 if case == "square" else \
            as_residues(_rand(mods, lead2 + (2,), 8192, seed + 1), cuda)
        bases.append((f1, f2, ntt.q_col, ntt.ratio))
    bases = bases[:1] if case == "one base" else bases
    before = bk.launches["behz_tensor"]
    got = bk.behz_tensor(*bases)
    torch.cuda.synchronize()
    assert bk.launches["behz_tensor"] == before + 1
    for g, (f1, f2, q, _) in zip(got, bases):
        assert torch.equal(g.cpu(), bk.tensor_plain(f1.cpu(), f2.cpu(),
                                                    q.cpu()))


@pytest.mark.gpu
def test_views_are_copied_once_and_otherwise_refused_on_cuda(cuda):
    """One rule for the four chains on the card: a non-contiguous operand
    raises; precompute_operand copies a view once, for both transforms."""
    port = _port(_params(1024, 3), cuda)
    qs, bsk = port.params.data_primes, port.bsk
    x = as_residues(_rand(qs, (2,), 2048, 1), cuda)[..., ::2]
    eq = as_residues(_rand(qs, (3,), 2048, 2), cuda)[..., ::2]
    eb = as_residues(_rand(bsk, (3,), 2048, 3), cuda)[..., ::2]
    f = as_residues(_rand(qs, (2,), 2048, 4), cuda)[..., ::2]
    for call in (lambda: port._to_bsk(x), lambda: port._from_bsk(eb),
                 lambda: port._fast_floor(eq.contiguous(), eb),
                 lambda: bk.behz_tensor((f, f.contiguous(), port.ntt_q.q_col,
                                         port.ntt_q.ratio))):
        with pytest.raises(ValueError, match="contiguous"):
            call()
    got, want = port.precompute_operand(x), \
        port.precompute_operand(x.contiguous())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_mult_relin_launch_census_on_cuda(cuda):
    """One n=8192 mult+relin of fresh operands: 2 / 1 / 1 / 1 BEHZ kernel
    launches (to_bsk, tensor over both bases, fast_floor, from_bsk)."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    ctx = BfvContext(BfvParams.create(8192, seed=11), cuda)
    a, b = ctx.encrypt_many([ctx.encode([3]), ctx.encode([5])])
    ctx.get_relin_key()
    before = dict(bk.launches)
    got = ctx.multiply(a, b)
    torch.cuda.synchronize()
    assert {k: bk.launches[k] - before[k] for k in before} == {
        "behz_to_bsk": 2, "behz_tensor": 1, "behz_fast_floor": 1,
        "behz_from_bsk": 1}
    assert ctx.decode(ctx.decrypt(got))[:1] == [15]
