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
    return to_host(bz._tensor(as_residues(f1, "cpu"), as_residues(f2, "cpu"),
                              base))


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


@pytest.mark.parametrize("L", [17, 27])
def test_plain_chains_match_np64_past_16_limbs(L):
    """L >= 17: from_bsk sums L+1 >= 18 products per word, past what a
    64-bit accumulator holds unreduced (16 products below 2^60); 27 is the
    largest L of BfvParams.create (n=32768), here at n=2048."""
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
        bk.behz_tensor(x, x, port.ntt_q.q_col.to("meta"),
                       port.ntt_q.ratio.to("meta"))


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
    t = _Tables(tab, K, D)
    y = np.stack([_mul_const(_u(e_q[i]), *t.src[i, [1, 2, 0]])
                  for i in range(K)])
    out = []
    for d in range(D):
        b, ratio = t.dst[d, 0], _Tables.ratio(t.dst[d])
        conv = _convert(y, t.T, d, b, ratio)
        tb = _mul_const(_u(e_b[d]), t.dst[d, 3], t.dst[d, 4], b)
        out.append(_mul_const(_sub_mod(tb, conv, b), t.dst[d, 5],
                              t.dst[d, 6], b))
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
// Host stand-in for the CUDA runtime: a launch runs every thread of every
// block in turn (behz.cu's kernels use no barrier and no shared memory).
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 threadIdx, blockIdx, blockDim;
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
template <typename... E, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  blockDim = cfg->blockDim;
  for (unsigned b = 0; b < cfg->gridDim.x; ++b) {
    blockIdx = dim3(b);
    for (unsigned t = 0; t < cfg->blockDim.x; ++t) {
      threadIdx = dim3(t);
      kernel(args...);
    }
  }
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
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    f"-I{root}", f"-I{_build._CSRC}", src, "-o",
                    str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for f in (lib.abc_behz_to_bsk, lib.abc_behz_from_bsk):
        f.argtypes, f.restype = [vp, vp, vp, i64, i32, i32, i32, vp], i32
    lib.abc_behz_fast_floor.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                        vp]
    lib.abc_behz_tensor.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, i32,
                                    vp]
    lib.abc_behz_fast_floor.restype = lib.abc_behz_tensor.restype = i32
    return lib


@pytest.mark.parametrize("L,lead", [(1, ()), (6, (3,)), (16, ()), (17, (2,)),
                                    (27, ()), (63, ())])
def test_kernel_source_on_the_host_matches_plain(host_lib, L, lead):
    """The four kernels of csrc/behz.cu, run thread by thread on the host,
    equal their plain versions: every register width (KMAX 8 to 64), a
    broadcast operand of the tensor product, and the K > 64 refusal."""
    n, logn = 64, 6
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
    for mods, ntt in ((qs, port.ntt_q), (bsk, port.ntt_bsk)):
        f1 = as_residues(_rand(mods, lead + (2,), n, L + 4), "cpu")
        f2 = as_residues(_rand(mods, (2,), n, L + 5), "cpu")    # broadcast
        rows1 = f1.numel() // (2 * len(mods) * n)
        out = torch.empty(lead + (3, len(mods), n), dtype=torch.int32)
        run(host_lib.abc_behz_tensor, f1.data_ptr(), f2.data_ptr(),
            out.data_ptr(), ntt.q_col.data_ptr(), ntt.ratio.data_ptr(), rows1,
            1, len(mods), logn, None)
        assert torch.equal(out, bk.tensor_plain(f1, f2, ntt.q_col))
    assert host_lib.abc_behz_to_bsk(x.data_ptr(), x.data_ptr(),
                                    tab["to_bsk"].data_ptr(), 1, 65, D, logn,
                                    None) != 0


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
    (fq1, fq1c), (fq2, fq2c) = both(qs, lead + (2,), 4), both(qs, lead + (2,),
                                                               5)
    return [
        ("behz_to_bsk", lambda: port._to_bsk(x), lambda: cpu._to_bsk(xc)),
        ("behz_fast_floor", lambda: port._fast_floor(eq, eb),
         lambda: cpu._fast_floor(eqc, ebc)),
        ("behz_from_bsk", lambda: port._from_bsk(eb),
         lambda: cpu._from_bsk(ebc)),
        ("behz_tensor", lambda: port._tensor(fq1, fq2, "q"),
         lambda: cpu._tensor(fq1c, fq2c, "q")),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("n,L,lead", [(8192, 6, ()), (8192, 6, (4,)),
                                      (2048, 17, ()), (2048, 27, ())])
def test_kernels_equal_plain_on_cuda(cuda, n, L, lead):
    for name, kern, plain in _card_cases(n, L, lead, cuda):
        before = bk.launches[name]
        got = kern()
        torch.cuda.synchronize()
        assert bk.launches[name] == before + 1
        assert torch.equal(got.cpu(), plain()), name


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
                 lambda: port._tensor(f, f.contiguous(), "q")):
        with pytest.raises(ValueError, match="contiguous"):
            call()
    got, want = port.precompute_operand(x), \
        port.precompute_operand(x.contiguous())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_mult_relin_launch_census_on_cuda(cuda):
    """One n=8192 mult+relin of fresh operands: 2 / 2 / 1 / 1 BEHZ kernel
    launches (to_bsk, tensor, fast_floor, from_bsk)."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    ctx = BfvContext(BfvParams.create(8192, seed=11), cuda)
    a, b = ctx.encrypt_many([ctx.encode([3]), ctx.encode([5])])
    ctx.get_relin_key()
    before = dict(bk.launches)
    got = ctx.multiply(a, b)
    torch.cuda.synchronize()
    assert {k: bk.launches[k] - before[k] for k in before} == {
        "behz_to_bsk": 2, "behz_tensor": 2, "behz_fast_floor": 1,
        "behz_from_bsk": 1}
    assert ctx.decode(ctx.decrypt(got))[:1] == [15]
