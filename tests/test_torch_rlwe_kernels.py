"""abc_tpu_torch.ops.rlwe_kernels (K5: the Threefry uniform draw, the
switching-key composition, the signed lift with the encryption's adds, the
BFV scale-and-round): the plain torch versions, reached through
BfvContext and CkksContext, against abc_tpu word for word (np64 and its
jitted jx32 device paths on the CPU); the kernel source itself compiled for
the host against the stub runtime of tests/host_cuda and held word-equal to
the plain versions; the CPU routing; and, on a CUDA device, each kernel
against its plain version at chip_smoke.py phase 2d's shapes.

Inputs are drawn with numpy from a seed; residues are integers, so the
tolerance is exact equality.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from abc_tpu.crypto import prng as ref_prng
from abc_tpu.crypto.bfv import BfvCiphertext as RefBfvCiphertext
from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.ckks import CkksContext as RefCkksContext
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto import prng
from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import rlwe_kernels as rk
from abc_tpu_torch.ops.modarith import as_residues, ratio_table, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

HOST_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "host_cuda")
M32 = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _col(moduli, device="cpu"):
    return as_residues(np.asarray(moduli, np.uint64).reshape(-1, 1), device)


def _rand(moduli, lead, n, seed):
    """uint32 residues [*lead, len(moduli), n] with 0 and q-1 among them."""
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    x = np.random.default_rng(seed).integers(
        0, q, size=tuple(lead) + (len(moduli), n), dtype=np.uint64)
    x[..., 0] = 0
    x[..., 1::7] = q - 1
    return x.astype(np.uint32)


def _key_words(pairs):
    """int32 [..., 2] key words from uint32 pairs."""
    return as_residues(np.asarray(pairs, dtype=np.uint64), "cpu")


# ---------------------------------------------- plain versions vs the reference

@pytest.mark.parametrize("n,L", [(256, 3), (1024, 5)])
def test_uniform_plain_matches_uniform_rns_np_and_jx(n, L):
    """The plain draw of three streams at once against the reference's
    host draw of each stream and its jitted draw from key words (JAX on
    the CPU)."""
    import jax.numpy as jnp
    moduli = gen_ntt_primes(30, L, n)
    streams = ["pk", "relin/d0", "galois_5/d2"]
    words = prng.derive_keys(99, streams)
    got = to_host(rk.rns_uniform_plain(_key_words(words), _col(moduli), n))
    jx = np.asarray(ref_prng.uniform_rns_jx_keys(
        jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1]), moduli, n))
    for i, stream in enumerate(streams):
        assert tuple(words[i]) == ref_prng.derive_key(99, stream)
        np.testing.assert_array_equal(
            got[i], ref_prng.uniform_rns_np(99, stream, moduli, n))
    np.testing.assert_array_equal(got, jx)


def _bfv_pair(n, k, seed, engine="np64"):
    return (BfvContext(BfvParams.create(n, seed=seed, ks_digits=k), "cpu"),
            RefBfvContext(RefBfvParams.create(n, engine=engine, seed=seed,
                                              ks_digits=k)))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_key_batch_matches_reference_and_one_at_a_time(k):
    """materialize_keys of relin and two Galois keys, built in one batch,
    against the reference's keys and against one-at-a-time builds of a
    second context of the same seed."""
    n = 1024
    port, ref = _bfv_pair(n, k, 21)
    ids = ["relin", f"galois_{pow(3, 2, 2 * n)}", f"galois_{2 * n - 1}"]
    got = port.materialize_keys(ids)
    want = ref.materialize_keys(ids)
    alone = BfvContext(BfvParams.create(n, seed=21, ks_digits=k), "cpu")
    for kid in reversed(ids):
        one = alone.materialize_keys([kid])[kid]
        for g, w, o in zip(got[kid], want[kid], one):
            assert tuple(g.shape) == (ref.params.num_ks_digits, ref.full, n)
            np.testing.assert_array_equal(to_host(g), w, err_msg=kid)
            assert torch.equal(g, o), kid
    assert port.materialize_keys(ids[:1])["relin"] is got["relin"]


@pytest.mark.parametrize("k", [1, 2])
def test_ckks_key_batch_and_level_slices_match_reference(k):
    """A CKKS batch (relin and a Galois key in one materialize_keys) equals
    the reference's keys, and the per-level slices below full level equal
    the reference's rows."""
    n, levels = 512, 4
    kw = dict(n=n, levels=levels, seed=33, ks_digits=k)
    port = CkksContext(CkksParams.create(**kw), "cpu")
    ref = RefCkksContext(RefCkksParams.create(engine="np64", **kw))
    g = pow(3, 3, 2 * n)
    keys = port.materialize_keys(["relin", f"galois_{g}"])
    for kid, want in (("relin", ref.get_relin_key()),
                      (f"galois_{g}", ref.get_galois_key(g))):
        for h in range(2):
            np.testing.assert_array_equal(to_host(keys[kid][h]), want[h])
        for level in (levels - 1, 1):
            alpha = port._alpha_at(level)
            cols = list(range(level)) + list(range(levels, levels + k))
            for h, cut in enumerate(port._ksk_device(kid, level)):
                np.testing.assert_array_equal(to_host(cut),
                                              want[h][:alpha][:, cols])


@pytest.fixture
def jx_pair(monkeypatch):
    """(port BfvContext on the CPU, abc_tpu jx32 BfvContext with the jitted
    device keygen): n=1024, k=2, seed 8."""
    monkeypatch.setenv("ABC_TPU_DEVICE_KEYGEN", "1")
    return _bfv_pair(1024, 2, 8, engine="jx32")


def test_public_key_matches_keygen_dev_jit(jx_pair):
    port, ref = jx_pair
    np.testing.assert_array_equal(to_host(port.s_ntt_full),
                                  np.asarray(ref._dev_s_ntt_full))
    np.testing.assert_array_equal(to_host(port.pk_b_ntt),
                                  np.asarray(ref._dev_pk_b))
    np.testing.assert_array_equal(to_host(port.pk_a_ntt),
                                  np.asarray(ref._dev_pk_a))
    ids = ["relin", "galois_3"]
    got, want = port.materialize_keys(ids), ref._build_keys_batch(ids)
    for kid in ids:
        for h in range(2):
            np.testing.assert_array_equal(to_host(got[kid][h]),
                                          np.asarray(want[kid][h]))


@pytest.mark.parametrize("B", [1, 3])
def test_encrypt_many_matches_enc_jit(jx_pair, B):
    """The same draws (u, e0, e1 per ciphertext) through the port's lift,
    contraction, inverse transform and lift with the adds, against the
    reference's _enc_jit."""
    port, ref = jx_pair
    values = [[3 * b + i for i in range(5)] for b in range(B)]
    got = port.encrypt_many([port.encode(v) for v in values])
    want = ref.encrypt_many([ref.encode(v) for v in values])
    for g, w, v in zip(got, want, values):
        np.testing.assert_array_equal(to_host(g.data), np.asarray(w.data))
        assert port.decode(port.decrypt(g))[:5] == v


@pytest.mark.parametrize("size", [2, 3])
def test_decrypt_matches_dec_jit(jx_pair, size):
    """Random words of a size-2 and a size-3 ciphertext, and a product
    before relinearization: the port's contraction with [1, s, s²] and its
    scale-and-round against _dec_jit."""
    port, ref = jx_pair
    import jax.numpy as jnp
    data = _rand(port.params.data_primes, (size,), 1024, size)
    got = port.decrypt(BfvCiphertext(as_residues(data, "cpu")))
    want = ref.decrypt(RefBfvCiphertext(jnp.asarray(data)))
    np.testing.assert_array_equal(to_host(got.coeffs),
                                  np.asarray(want.coeffs))
    a, b = port.encrypt_many([port.encode([2, 3]), port.encode([5, 7])])
    prod = port.multiply(a, b, relinearize=(size == 2))
    assert prod.size == size
    want = ref.decrypt(RefBfvCiphertext(jnp.asarray(to_host(prod.data))))
    np.testing.assert_array_equal(to_host(port.decrypt(prod).coeffs),
                                  np.asarray(want.coeffs))


def test_ckks_encrypt_decrypt_match_reference():
    """CKKS: an encryption (lift, contraction, inverse, lift with the
    plaintext rows) and decryptions at full level, below it and of a size-3
    product, against the np64 reference."""
    kw = dict(n=512, levels=4, seed=12, ks_digits=2)
    port = CkksContext(CkksParams.create(**kw), "cpu")
    ref = RefCkksContext(RefCkksParams.create(engine="np64", **kw))
    vals = [0.5, -1.25, 2.0]
    ct, rct = port.encrypt(port.encode(vals)), ref.encrypt(ref.encode(vals))
    np.testing.assert_array_equal(to_host(ct.data), rct.data)
    for c, r in ((ct, rct), (port.mod_drop_to(ct, 2), ref.mod_drop_to(rct, 2)),
                 (port.multiply(ct, ct, rescale=False, relinearize=False),
                  ref.multiply(rct, rct, rescale=False, relinearize=False))):
        got, want = port.decrypt(c), ref.decrypt(r)
        assert got.level == want.level
        np.testing.assert_array_equal(got.coeffs_rns, want.coeffs_rns)


# ---------------------- the kernel source, compiled for the host (g++)

def _host_build(tmp_path_factory, sms):
    """csrc/rlwe.cu compiled by g++ against tests/host_cuda's stub runtime
    (a launch runs its blocks in turn, a std::thread per thread), on a
    card of `sms` SMs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("rlwe_host") / f"librlwe_host{sms}.so"
    src = [s for s in _build.SOURCES if s.endswith("rlwe.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}",
                    f"-DHOST_CUDA_SMS={sms}", src, "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_rlwe(lib)
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build on the stub's card of an H100's 132 SMs."""
    return _host_build(tmp_path_factory, 132)


@pytest.fixture(scope="module")
def host_lib_one_sm(tmp_path_factory):
    """The host build on a card of one SM, whose lift plans take two limb
    rows a thread from 2048 output quads."""
    return _host_build(tmp_path_factory, 1)


def _plan(lib, kernel, rows, R, n):
    info = (ctypes.c_longlong * 6)()
    assert lib.abc_rlwe_plan(kernel, rows, R, n.bit_length() - 1, info) == 0
    return tuple(info)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_uniform(lib, keys, q, ratio, n):
    out = torch.empty(tuple(keys.shape[:-1]) + (q.shape[0], n),
                      dtype=torch.int32)
    assert lib.abc_rns_uniform(keys.data_ptr(), out.data_ptr(), q.data_ptr(),
                               ratio.data_ptr(), keys.numel() // 2,
                               q.shape[0], n.bit_length() - 1, None) == 0
    return out


def _host_compose(lib, keys, e, s, q, ratio, fac=None, tgt=None, perms=None):
    K, A, R, n = e.shape
    b, a = torch.empty_like(e), torch.empty_like(e)
    assert lib.abc_ksk_compose(
        keys.data_ptr(), e.data_ptr(), s.data_ptr(), _ptr(fac), _ptr(tgt),
        _ptr(perms), q.data_ptr(), ratio.data_ptr(), b.data_ptr(),
        a.data_ptr(), K, A, R, n.bit_length() - 1, None) == 0
    return b, a


def _host_lift(lib, v, q, base=None, msg=None, delta=None):
    R, n = q.shape[0], v.shape[-1]
    out = torch.empty(tuple(v.shape[:-1]) + (R, n), dtype=torch.int32)
    assert lib.abc_rlwe_lift(v.data_ptr(), _ptr(base), _ptr(msg), _ptr(delta),
                             q.data_ptr(), out.data_ptr(),
                             v.numel() // n, R, n.bit_length() - 1,
                             None) == 0
    return out


def _host_dec_round(lib, v, tab):
    """One call of the host build: (m, flag), the flag 1 if any of its
    words is set, else 0. Every word is written by the call (they start at
    7), each 0 or 1."""
    L, n = v.shape[-2:]
    m = torch.empty(tuple(v.shape[:-2]) + (n,), dtype=torch.int32)
    flag = torch.full((rk.flag_words(v.numel() // L),), 7, dtype=torch.int32)
    assert lib.abc_bfv_dec_round(v.data_ptr(), tab.words.data_ptr(),
                                 m.data_ptr(), flag.data_ptr(), flag.numel(),
                                 v.numel() // (L * n), L, tab.t,
                                 n.bit_length() - 1, None) == 0
    assert set(flag.tolist()) <= {0, 1}
    return m, flag.any().to(torch.int32)


# key words of every kind: all-zero, all-one and the known-answer keys of
# tests/test_torch_keygen.py, then random ones
KAT_KEYS = [(0, 0), (M32, M32), (0x13198A2E, 0x03707344), (0, M32),
            (M32, 0)]


def _keys(count, seed):
    rng = np.random.default_rng(seed)
    pairs = KAT_KEYS + [tuple(int(x) for x in rng.integers(0, 1 << 32, 2))
                        for _ in range(max(0, count - len(KAT_KEYS)))]
    return _key_words(pairs[:count])


@pytest.mark.parametrize("n,R,rows", [(4, 1, 5), (8, 3, 5), (64, 5, 7),
                                      (512, 2, 3), (256, 14, 6)])
def test_uniform_source_on_the_host(host_lib, n, R, rows):
    """rns_uniform on the host: key words 0 and 0xFFFFFFFF, the known-answer
    keys and random ones, n from 4 to 512, against the plain draw; its first
    word of key (0, 0) is the known answer (0x6B200159, 0x99BA4EFE) of
    counter (0, 0) reduced mod q_0."""
    moduli = gen_ntt_primes(30, R, max(n, 64))
    q, ratio = _col(moduli), ratio_table(moduli, "cpu")
    keys = _keys(rows, n + R)
    got = _host_uniform(host_lib, keys, q, ratio, n)
    assert torch.equal(got, rk.rns_uniform_plain(keys, q, n))
    assert int(got[0, 0, 0]) == ((0x6B200159 << 32) | 0x99BA4EFE) % moduli[0]


@pytest.mark.parametrize("n,K,A,R,kinds", [
    (4, 1, 1, 3, None), (64, 1, 1, 6, None), (8, 3, 2, 4, (-1, 0, 1)),
    (64, 2, 6, 7, (-1, 0)), (256, 4, 3, 5, (1, -1, 0, 2)),
    (512, 1, 2, 3, (0,))])
@pytest.mark.parametrize("edge", [None, "zero", "max"])
def test_compose_source_on_the_host(host_lib, n, K, A, R, kinds, edge):
    """ksk_compose on the host: the public key's form (no target term) and
    switching keys toward s² and Galois targets in one launch, n from 4 to
    512; errors and secret at random, all 0 or all q-1, key words 0 or
    0xFFFFFFFF among them."""
    moduli = gen_ntt_primes(30, R, max(n, 64))
    q, ratio = _col(moduli), ratio_table(moduli, "cpu")
    keys = _keys(K * A, n + K).reshape(K, A, 2)
    e = as_residues(_rand(moduli, (K, A), n, n + A), "cpu")
    s = as_residues(_rand(moduli + moduli[:1], (), n, n + 1), "cpu")
    if edge is not None:
        qm = torch.tensor(moduli, dtype=torch.int32).reshape(-1, 1)
        e = (torch.zeros_like(e) if edge == "zero" else
             (qm - 1).expand(e.shape).contiguous())
        s[:R] = 0 if edge == "zero" else (qm - 1)
    fac = tgt = perms = None
    if kinds is not None:
        fac = rk.shoup_pairs(_rand(moduli, (A,), 1, 7), moduli, "cpu")
        tgt = torch.tensor(kinds, dtype=torch.int32)
        rng = np.random.default_rng(n)
        perms = torch.from_numpy(np.stack([rng.permutation(n)
                                           for _ in range(3)]))
    got = _host_compose(host_lib, keys, e, s, q, ratio, fac, tgt, perms)
    want = rk.ksk_compose_plain(keys, e, s, q, fac, tgt, perms)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,lead,R", [(4, (3,), 2), (64, (2, 2), 6),
                                      (512, (5,), 3), (128, (3, 4), 14),
                                      (512, (1,), 27), (64, (3,), 5),
                                      (256, (64,), 7), (128, (2, 3), 13)])
@pytest.mark.parametrize("form", ["lift", "base", "bfv", "ckks"])
@pytest.mark.parametrize("edge", [None, "zero", "max"])
@pytest.mark.parametrize("sms", [132, 1])
def test_lift_source_on_the_host(request, n, lead, R, form, edge, sms):
    """rlwe_lift on the host: the lift alone, with a base, and the
    encryption's two forms (Δ·m on the even rows; plaintext rows on the
    even rows); v of ±19 and 0 at random, all 0, or ±19 with base
    and message at q-1 (every sum past q and 2q). Rows 1, 3, 5, 6, 12
    and 64 (odd counts: a last ciphertext's c0 without its c1), R from 2
    to 27; on a card of 132 SMs every launch takes a limb row a thread, on
    a card of one SM those of 2048 output quads or more take two (a last
    group of one row where R is odd)."""
    lib = request.getfixturevalue("host_lib" if sms == 132 else
                                  "host_lib_one_sm")
    rows = int(np.prod(lead))
    G = _plan(lib, 2, rows, R, n)[0]
    assert G == (2 if sms == 1 and rows * R * n // 4 >= 2048 else 1)
    moduli = gen_ntt_primes(30, R, max(n, 64))
    t = gen_ntt_primes(20, 1, max(n, 64), exclude=moduli)[0]
    q = _col(moduli)
    rng = np.random.default_rng(n + R)
    v = rng.integers(-19, 20, size=lead + (n,))
    v.reshape(-1)[:3] = [19, -19, 0]
    base = msg = delta = None
    mrows = -(-int(np.prod(lead)) // 2)
    qm = torch.tensor(moduli, dtype=torch.int32).reshape(-1, 1)
    if form != "lift":
        base = as_residues(_rand(moduli, lead, n, 5), "cpu")
    if form == "bfv":
        msg = as_residues(rng.integers(0, t, size=(mrows, n)), "cpu")
        delta = rk.shoup_pairs(_rand(moduli, (), 1, 3), moduli, "cpu")
    if form == "ckks":
        msg = as_residues(_rand(moduli, (mrows,), n, 6), "cpu")
    if edge == "zero":
        v[...] = 0
    elif edge == "max":
        v = np.where(np.arange(n) % 2, 19, -19) * np.ones(lead + (n,), int)
        if base is not None:
            base = (qm - 1).expand(base.shape).contiguous()
        if form == "ckks":
            msg = (qm - 1).expand(msg.shape).contiguous()
        if form == "bfv":
            msg = torch.full_like(msg, t - 1)
    v8 = torch.from_numpy(v.astype(np.int8))
    got = _host_lift(lib, v8, q, base, msg, delta)
    assert torch.equal(got, rk.rlwe_lift_plain(v8, q, base, msg, delta))


@pytest.mark.parametrize("n,L", [(4, 1), (8, 3), (64, 3), (256, 6),
                                 (512, 13), (32, 27), (16, 65), (256, 40)])
def test_dec_round_source_on_the_host(host_lib, n, L):
    """bfv_dec_round on the host against the plain version: random words,
    v = 0 and v = q-1, and columns whose fraction lies exactly 2^31 + d for
    d = 0 (rounds up), ±4095 (flag on) and ±4096 (flag off), next to m = t-1
    and m = 3 (chip_smoke.boundary_residues, from L = 3: one prime's
    product is too coarse to place a fraction to the unit), L from 1 to
    65 (the kernel stages 32 limbs at a time: 40 and 65 take two and three
    chunks)."""
    qs = gen_ntt_primes(30, L, max(n, 64))
    t = gen_ntt_primes(20, 1, max(n, 64), exclude=qs)[0]
    tab = rk.DecRound(qs, t, "cpu")
    rnd = as_residues(_rand(qs, (), n, n + L), "cpu")
    cases = [rnd, torch.zeros_like(rnd),
             _col(qs).expand(L, n).contiguous() - 1]
    edges = [(d, m) for d in (0, 4095, -4095, 4096, -4096)
             for m in (t - 1, 3)] if L >= 3 else []
    from chip_smoke import boundary_residues
    for d, m in [(None, None)] * len(cases) + edges:
        if d is None:
            x = cases.pop()
        else:
            x = torch.zeros_like(rnd)
            x[:, 1:2] = boundary_residues(qs, tab, m, d)
        got_m, got_flag = _host_dec_round(host_lib, x, tab)
        want_m, want_flag = rk.bfv_dec_round_plain(x, tab)
        assert torch.equal(got_m, want_m)
        assert bool(got_flag) == bool(want_flag)
        if d is not None:
            assert bool(got_flag) is (abs(d) < rk.DEC_MARGIN)
            assert int(got_m[1]) == ((m + 1) % t if d >= 0 else m)


@pytest.mark.parametrize("n,L,rows", [(4, 2, 3), (8, 5, 5), (64, 13, 3),
                                      (16, 27, 2), (32, 65, 3), (128, 6, 3)])
def test_dec_round_batches_on_the_host(host_lib, n, L, rows):
    """bfv_dec_round on the host over rows of ciphertexts whose quads do not
    fill the last warp (a warp takes 4 quads) or block (64 coefficients):
    rows n of 12, 40, 192, 32, 96 and 384, L up to 65, random words with 0
    and q-1 among them, against the plain version row by row and as one
    batch."""
    qs = gen_ntt_primes(30, L, max(n, 64))
    t = gen_ntt_primes(20, 1, max(n, 64), exclude=qs)[0]
    tab = rk.DecRound(qs, t, "cpu")
    x = as_residues(_rand(qs, (rows,), n, n * L + rows), "cpu")
    x[..., 0] = 0
    x[-1, :, -1:] = _col(qs) - 1
    got_m, got_flag = _host_dec_round(host_lib, x, tab)
    want_m, want_flag = rk.bfv_dec_round_plain(x, tab)
    assert torch.equal(got_m, want_m)
    assert bool(got_flag) == bool(want_flag)
    for r in range(rows):
        assert torch.equal(got_m[r], rk.bfv_dec_round_plain(x[r], tab)[0])


@pytest.mark.parametrize("L,n,rows", [(3, 8, 1), (13, 512, 1), (6, 64, 4),
                                      (27, 32, 5), (65, 16, 9)])
def test_dec_round_flag_is_each_calls_own(host_lib, L, n, rows):
    """The flag is written by the launch (no memset): a flagged call, then
    an unflagged one on the same table, reads unflagged; the flagged
    coefficient in the first or the last of several blocks; the words
    equal the plain version's throughout."""
    qs = gen_ntt_primes(30, L, 64)
    t = gen_ntt_primes(20, 1, 64, exclude=qs)[0]
    tab = rk.DecRound(qs, t, "cpu")
    from chip_smoke import boundary_residues
    near = boundary_residues(qs, tab, t - 1, 4095)
    far = boundary_residues(qs, tab, 3, -4096)
    for at in ((0, 1), (rows - 1, n - 1)):
        x = torch.zeros((rows, L, n), dtype=torch.int32)
        x[..., :1] = far
        x[at[0], :, at[1]:at[1] + 1] = near
        for v, flagged in ((x, True), (torch.zeros_like(x), False),
                           (x, True), (x.roll(1, dims=-1) * 0 + far, False)):
            got_m, got_flag = _host_dec_round(host_lib, v, tab)
            want_m, want_flag = rk.bfv_dec_round_plain(v, tab)
            assert torch.equal(got_m, want_m)
            assert int(got_flag) == int(flagged) == int(want_flag)


def test_host_launch_info_and_refusals(host_lib):
    """abc_rlwe_plan: a quad a thread (rlwe_lift: one limb row a thread
    under a full card, two past it; bfv_dec_round: a quad's limbs over 8
    lanes, 64 coefficients a block: its flag words), 128 a block; shapes
    the kernels do not take are refused."""
    info = (ctypes.c_longlong * 6)()
    for kernel in range(3):
        assert _plan(host_lib, kernel, 1, 14, 8192)[:4] == \
            ((1, 14) if kernel == 2 else (0, 0)) + (128, 14 * 8192 // 4 // 128)
    # the 19 keys' errors fill the card: two limb rows a thread
    assert _plan(host_lib, 2, 19 * 14, 14, 16384)[:4] == \
        (2, 7, 128, 19 * 14 * 7 * 4096 // 128)
    for rows, L, n in ((1, 13, 16384), (3, 2, 4), (5, 6, 8192)):
        assert _plan(host_lib, 3, rows, L, n)[:4] == \
            (0, 0, 128, rk.flag_words(rows * n))
    assert host_lib.abc_rlwe_plan(4, 14, 13, 13, info) != 0
    assert host_lib.abc_rns_uniform(None, None, None, None, 1, 3, 1,
                                    None) != 0
    assert host_lib.abc_rns_uniform(None, None, None, None, 1, 1 << 20, 13,
                                    None) != 0          # counters past 2^32
    assert host_lib.abc_ksk_compose(None, None, None, 1, None, None, None,
                                    None, None, None, 1, 1, 3, 13,
                                    None) != 0          # factors, no targets
    assert host_lib.abc_rlwe_lift(None, None, None, 1, None, None, 1, 3, 13,
                                  None) != 0            # delta, no message
    assert host_lib.abc_bfv_dec_round(None, None, None, None, 128, 1, 3, 1,
                                      13, None) != 0    # t < 2
    assert host_lib.abc_bfv_dec_round(None, None, None, None, 127, 1, 3,
                                      65537, 13, None) != 0   # a word short
    assert host_lib.abc_bfv_dec_round(None, None, None, None, 1 << 25,
                                      1 << 18, 3, 65537, 13,
                                      None) != 0   # 2^31 coefficients
    assert host_lib.abc_rlwe_lift(None, None, None, None, None, None,
                                  1 << 18, 1, 15, None) != 0  # 2^31 quads


# --------------------------------------------------------------- the routing

def test_cpu_route_launches_nothing():
    """Keygen, a batch of keys, an encryption, a decryption and the uniform
    regeneration of a restored context on CPU tensors run the plain
    versions."""
    before = dict(rk.launches)
    ctx = BfvContext(BfvParams.create(1024, seed=4), "cpu")
    keys = ctx.materialize_keys(["relin", "galois_3"])
    assert ctx.decode(ctx.decrypt(ctx.encrypt(ctx.encode([7]))))[0] == 7
    again = BfvContext(BfvParams.create(1024, seed=4), "cpu")
    again.install_keys(None, ctx.pk_b_ntt, None,
                       {kid: (b, None) for kid, (b, _) in keys.items()},
                       public_seed=ctx.public_seed)
    assert torch.equal(again.pk_a_ntt, ctx.pk_a_ntt)
    assert all(torch.equal(again._keys[kid][1], keys[kid][1])
               for kid in keys)
    assert rk.launches == before
    assert set(before) == {"rns_uniform", "ksk_compose", "rlwe_lift",
                           "bfv_dec_round"}


def test_a_tensor_off_the_cpu_is_never_taken_by_the_plain_path():
    """Only a CPU tensor takes a plain version: any other device goes to the
    kernels' checks (here meta tensors, refused)."""
    moduli = gen_ntt_primes(30, 3, 64)
    q, ratio = _col(moduli, "meta"), ratio_table(moduli, "meta")
    keys = torch.empty((2, 3, 2), dtype=torch.int32, device="meta")
    e = torch.empty((2, 3, 3, 64), dtype=torch.int32, device="meta")
    v = torch.empty((2, 64), dtype=torch.int8, device="meta")
    tab = rk.DecRound(moduli, 65537, "meta")
    for call in (lambda: rk.rns_uniform(keys, q, ratio, 64),
                 lambda: rk.ksk_compose(keys, e, e[0, 0], q, ratio),
                 lambda: rk.rlwe_lift(v, q),
                 lambda: rk.bfv_dec_round(e[0], tab)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_tables_have_the_source_layout():
    """The packed words have csrc/rlwe.cu's sizes: the scale-and-round's
    five words a limb, a Shoup pair per constant."""
    qs = gen_ntt_primes(30, 4, 64)
    tab = rk.DecRound(qs, 65537, "cpu")
    words = to_host(tab.words).reshape(4, rk.DEC_REC)
    assert words[:, 0].tolist() == qs
    assert words[:, 3].tolist() == [(65537 << 64) // q >> 32 for q in qs]
    pairs = rk.shoup_pairs(np.asarray([[5], [7], [11], [13]]), qs, "cpu")
    assert tuple(pairs.shape) == (4, 2)
    assert to_host(pairs)[:, 1].tolist() == [
        (w << 32) // q for w, q in zip((5, 7, 11, 13), qs)]


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("what,scheme,n,L,k,K,B", [
    ("pk", "bfv", 8192, 6, 1, 0, 0), ("pk", "bfv", 16384, 13, 1, 0, 0),
    ("keys", "bfv", 8192, 6, 1, 1, 0), ("keys", "bfv", 8192, 6, 2, 1, 0),
    ("keys", "ckks", 32768, 8, 2, 2, 0), ("keys", "bfv", 16384, 13, 1, 19, 0),
    ("enc", "bfv", 8192, 6, 1, 0, 1), ("enc", "bfv", 8192, 6, 1, 0, 64),
    ("dec", "bfv", 8192, 6, 1, 0, 0), ("dec", "bfv", 16384, 13, 1, 0, 0)])
def test_kernels_equal_plain_on_cuda(cuda, what, scheme, n, L, k, K, B):
    """Each kernel on the card against its plain version (on the card) at
    chip_smoke.py phase 2d's shapes, one launch per call (the
    scale-and-round's flag read as set where any of its words is)."""
    import chip_smoke
    for label, (name, kern, plain, *_rest) in chip_smoke.rlwe_calls(
            what, scheme, n, L, k, K, B, None, cuda).items():
        before = rk.launches[name]
        read = chip_smoke.dec_words if name == "bfv_dec_round" else \
            chip_smoke.words
        got, want = read(kern()), read(plain())
        torch.cuda.synchronize()
        assert rk.launches[name] == before + 1, label
        assert torch.equal(got.cpu(), want.cpu()), label


@pytest.mark.gpu
def test_context_launch_census_on_cuda(cuda):
    """Keygen is 2 lifts and 1 composition; a batch of keys 1 lift and 1
    composition; an encryption of any batch 2 lifts; a decryption 1
    scale-and-round; a uniform regeneration 1 draw. The card's words equal
    the CPU context's."""
    params = BfvParams.create(8192, seed=6)
    before = dict(rk.launches)
    ctx = BfvContext(params, cuda)
    assert rk.launches["rlwe_lift"] - before["rlwe_lift"] == 2
    assert rk.launches["ksk_compose"] - before["ksk_compose"] == 1
    cpu = BfvContext(params, "cpu")
    ids = ["relin", "galois_3", "galois_5"]
    before = dict(rk.launches)
    keys = ctx.materialize_keys(ids)
    assert rk.launches["ksk_compose"] - before["ksk_compose"] == 1
    want = cpu.materialize_keys(ids)
    for kid in ids:
        assert torch.equal(keys[kid][0].cpu(), want[kid][0])
    before = dict(rk.launches)
    cts = ctx.encrypt_many([ctx.encode([i]) for i in range(4)])
    assert rk.launches["rlwe_lift"] - before["rlwe_lift"] == 2
    assert ctx.decode(ctx.decrypt(cts[3]))[0] == 3
    assert rk.launches["bfv_dec_round"] - before["bfv_dec_round"] == 1
    before = dict(rk.launches)
    ctx.install_keys(cpu.s_coeffs, to_host(ctx.pk_b_ntt), None,
                     {kid: (to_host(b), None) for kid, (b, _) in keys.items()},
                     public_seed=ctx.public_seed)
    assert rk.launches["rns_uniform"] - before["rns_uniform"] == 2
    for kid in ids:
        assert torch.equal(ctx._keys[kid][1].cpu(), want[kid][1])
