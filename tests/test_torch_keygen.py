"""abc_tpu_torch key generation, encryption and decryption on the context's
device, word for word against abc_tpu (ports of tests/test_prng.py,
tests/test_device_keygen.py and
test_bfv.py::test_device_key_arrays_bit_exact_vs_host).

The port draws what the reference draws: numpy Generator draws for the
small samples, Threefry-2x32 counters for every uniform polynomial. So a
context of the same seed must hold the same words; the tolerance is none.
"""

import numpy as np
import pytest
import torch

from abc_tpu.crypto import prng as ref_prng
from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto import prng
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import rlwe_kernels as rk
from abc_tpu_torch.ops.modarith import as_residues, ratio_table, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

# primes in [2^29, 2^30), as tests/test_prng.py
MODULI = [536903681, 537133057, 537395201]
M32 = 0xFFFFFFFF


def _words(values):
    return torch.tensor(values, dtype=torch.int64)


def _uniform(k0, k1, moduli, n):
    """rns_uniform of key words k0, k1 (ints, or nested lists of one shape)
    on CPU tensors: [..., L, n]."""
    keys = as_residues(np.stack([np.asarray(k0, dtype=np.uint64),
                                 np.asarray(k1, dtype=np.uint64)], axis=-1),
                       "cpu")
    q = as_residues(np.asarray(moduli, np.uint64).reshape(-1, 1), "cpu")
    return rk.rns_uniform(keys, q, ratio_table(moduli, "cpu"), n)


# ------------------------------------------------------------------ Threefry

@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((M32, M32), (M32, M32), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
], ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(key, ctr, want):
    """Random123's known-answer vectors for Threefry-2x32, 20 rounds."""
    x0, x1 = rk.threefry2x32(_words(key[0]), _words(key[1]),
                             _words([ctr[0]]), _words([ctr[1]]))
    assert (int(x0[0]), int(x1[0])) == want


@pytest.mark.parametrize("seed", [0, 123, 2 ** 63 - 1])
def test_threefry_matches_reference_on_the_same_counters(seed):
    rng = np.random.default_rng(seed)
    k0, k1 = (int(v) for v in rng.integers(0, 1 << 32, 2))
    c0, c1 = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
              for _ in range(2))
    c0[:2], c1[:2] = (0, M32), (M32, 0)
    want = ref_prng.threefry2x32(np, k0, k1, c0.astype(np.uint32),
                                 c1.astype(np.uint32))
    got = rk.threefry2x32(_words(k0), _words(k1),
                          torch.from_numpy(c0.astype(np.int64)),
                          torch.from_numpy(c1.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and int(g.min()) >= 0
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)


@pytest.mark.parametrize("stream", ["pk", "galois_3/d2", "enc/17",
                                    "plumless", "buckeroo"])
def test_host_words_match_reference(stream):
    """derive_key, split_domain and seeded_rng are the reference's words
    ("plumless"/"buckeroo" collide under crc32 and must not collide
    here)."""
    seed = 987654321
    assert prng.derive_key(seed, stream) == ref_prng.derive_key(seed, stream)
    assert prng.split_domain(seed, stream) == \
        ref_prng.split_domain(seed, stream)
    np.testing.assert_array_equal(
        prng.seeded_rng(seed, stream).integers(0, 1 << 30, 16),
        ref_prng.seeded_rng(seed, stream).integers(0, 1 << 30, 16))
    assert prng.derive_key(123, "plumless") != prng.derive_key(123, "buckeroo")


@pytest.mark.parametrize("stream", ["pk", "galois_3/d2", "enc/17"])
def test_uniform_rns_matches_reference_host_path(stream):
    want = ref_prng.uniform_rns_np(987654321, stream, MODULI, 512)
    k0, k1 = prng.derive_key(987654321, stream)
    got = _uniform(k0, k1, MODULI, 512)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 512)
    np.testing.assert_array_equal(to_host(got), want)


def test_uniform_rns_batched_keys_match_per_stream_calls():
    """[K, α] key words → [K, α, L, n]: every row is its own stream."""
    streams = [[f"relin/d{i}" for i in range(3)],
               [f"galois_5/d{i}" for i in range(3)]]
    keys = [[prng.derive_key(7, s) for s in row] for row in streams]
    k0 = [[k[0] for k in row] for row in keys]
    k1 = [[k[1] for k in row] for row in keys]
    got = _uniform(k0, k1, MODULI, 128)
    assert tuple(got.shape) == (2, 3, 3, 128)
    for j, row in enumerate(streams):
        for i, s in enumerate(row):
            np.testing.assert_array_equal(
                to_host(got[j, i]), ref_prng.uniform_rns_np(7, s, MODULI, 128))


def test_uniform_rns_in_range_and_spread():
    k0, k1 = prng.derive_key(7, "x")
    u = to_host(_uniform(k0, k1, MODULI, 256))
    for row, q in zip(u, MODULI):
        assert row.max() < q
        assert abs(row.astype(np.float64).mean() / q - 0.5) < 0.1


# ------------------------------------------------------------------- contexts

def _pair(n, k, seed):
    return (BfvContext(BfvParams.create(n, seed=seed, ks_digits=k), "cpu"),
            RefBfvContext(RefBfvParams.create(n, engine="np64", seed=seed,
                                              ks_digits=k)))


def _hold_context(port, ref):
    """Secret, public key, relin key, two Galois keys, an encryption and a
    decryption: the same words on both sides."""
    n = ref.params.n
    np.testing.assert_array_equal(port.s_coeffs, ref.s_coeffs)
    np.testing.assert_array_equal(to_host(port.s_ntt_full), ref.s_ntt_full)
    np.testing.assert_array_equal(to_host(port.pk_b_ntt), ref.pk_b_ntt)
    np.testing.assert_array_equal(to_host(port.pk_a_ntt), ref.pk_a_ntt)
    ids = ["relin", f"galois_{pow(3, 1, 2 * n)}", f"galois_{2 * n - 1}"]
    got = port.materialize_keys(ids)
    want = ref._build_keys_batch(ids)
    for kid in ids:
        for g, w in zip(got[kid], want[kid]):
            assert tuple(g.shape) == (ref.params.num_ks_digits, ref.full, n)
            np.testing.assert_array_equal(to_host(g), w, err_msg=kid)
    values = [3, -1, 4, 1, -5, 9]
    pt, rpt = port.encode(values), ref.encode(values)
    np.testing.assert_array_equal(to_host(pt.coeffs), rpt.coeffs)
    ct, rct = port.encrypt(pt), ref.encrypt(rpt)
    np.testing.assert_array_equal(to_host(ct.data), rct.data)
    dec, rdec = port.decrypt(ct), ref.decrypt(rct)
    np.testing.assert_array_equal(to_host(dec.coeffs), rdec.coeffs)
    assert port.decode(dec)[:6] == ref.decode(rdec)[:6] == values
    assert port.noise_budget(ct) == ref.noise_budget(rct)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("seed", [7, 42])
def test_context_words_match_np64(seed, n, k):
    _hold_context(*_pair(n, k, seed))


def test_context_words_match_np64_n8192():
    _hold_context(*_pair(8192, 1, 11))


def test_device_key_arrays_bit_exact_vs_host():
    """The case of test_bfv.py of that name: seed 19, k=2, relin and one
    Galois key through materialize_keys, asserted on the key arrays."""
    port, ref = _pair(1024, 2, 19)
    ids = ["relin", f"galois_{pow(3, 1, 2048)}"]
    got, want = port.materialize_keys(ids), ref.materialize_keys(ids)
    assert got.keys() == want.keys()
    for kid in ids:
        np.testing.assert_array_equal(to_host(got[kid][0]), want[kid][0])
        np.testing.assert_array_equal(to_host(got[kid][1]), want[kid][1])
    assert port.get_relin_key() is got["relin"]          # built once


def test_keygen_round_trip_and_ops():
    """The sequence of test_device_keygen.py::test_device_keygen_bit_exact
    on the port's own keys."""
    ctx = BfvContext(BfvParams.create(1024, seed=42), "cpu")
    ct = ctx.encrypt(ctx.encode([3, 1, 4]))
    assert ctx.decode(ctx.decrypt(ct))[:3] == [3, 1, 4]
    assert ctx.decode(ctx.decrypt(ctx.multiply(ct, ct)))[:3] == [9, 1, 16]
    assert ctx.decode(ctx.decrypt(ctx.rotate_rows(ct, 1)))[:2] == [1, 4]


def test_public_seed_is_not_master_or_secret_domain():
    ctx = BfvContext(BfvParams.create(1024, seed=77), "cpu")
    assert ctx.public_seed != 77
    assert ctx.public_seed == prng.split_domain(77, "public")
    assert ctx.public_seed != ctx._sec_seed
    again = BfvContext(BfvParams.create(1024, seed=77), "cpu")
    assert torch.equal(ctx.pk_a_ntt, again.pk_a_ntt)
    assert torch.equal(ctx.pk_b_ntt, again.pk_b_ntt)
    assert torch.equal(ctx.encrypt(ctx.encode([1, 2, 3])).data,
                       again.encrypt(again.encode([1, 2, 3])).data)


def test_unseeded_contexts_differ():
    a = BfvContext(BfvParams.create(1024), "cpu")
    b = BfvContext(BfvParams.create(1024), "cpu")
    assert not torch.equal(a.pk_a_ntt, b.pk_a_ntt)
    ct = a.encrypt(a.encode([5, 6]))
    assert a.decode(a.decrypt(ct))[:2] == [5, 6]


# -------------------------------------------------------------------- decrypt

@pytest.mark.parametrize("size", [2, 3])
def test_decrypt_paths_agree(size):
    """The fixed-point device path, the exact bigint path and the
    reference's decrypt give one plaintext, for size-2 and size-3
    ciphertexts; the budget is the reference's."""
    port, ref = _pair(1024, 1, 5)
    a, b = [9, -8, 7], [-1, 2, 300]
    pa, pb = port.encrypt_many([port.encode(a), port.encode(b)])
    ra, rb = ref.encrypt_many([ref.encode(a), ref.encode(b)])
    ct = port.multiply(pa, pb, relinearize=(size == 2))
    rct = ref.multiply(ra, rb, relinearize=(size == 2))
    assert ct.size == size
    fast = port.decrypt(ct)
    exact, budget = port._decrypt_exact(to_host(port._dot_secret(ct)))
    assert torch.equal(fast.coeffs, exact.coeffs)
    np.testing.assert_array_equal(to_host(fast.coeffs),
                                  ref.decrypt(rct).coeffs)
    assert budget == ref.noise_budget(rct) == port.noise_budget(ct)
    assert port.decode(fast)[:3] == [x * y for x, y in zip(a, b)]


def test_decrypt_at_noise_capacity_takes_the_exact_path(monkeypatch):
    """A coefficient half way between two plaintext values (v = ⌊q·(2m+1)/2t⌋
    in c0, c1 = 0) trips the boundary flag, and the exact bigint path
    decides; one a quarter of the way does not, and both paths agree."""
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.ops.modarith import as_residues
    port, _ = _pair(1024, 1, 5)
    q_big, t = port.params.q, port.params.plain_modulus
    primes = port.params.data_primes
    calls = []
    real = port._decrypt_exact
    monkeypatch.setattr(port, "_decrypt_exact",
                        lambda v: calls.append(1) or real(v))
    for numer, denom, flagged in ((2 * 1234 + 1, 2 * t, True),
                                  (4 * 1234 + 1, 4 * t, False)):
        v0 = q_big * numer // denom
        data = np.zeros((2, len(primes), 1024), dtype=np.uint32)
        data[0, :, 0] = [v0 % p for p in primes]
        ct = BfvCiphertext(as_residues(data, "cpu"))
        del calls[:]
        pt = port.decrypt(ct)
        assert bool(calls) is flagged
        assert torch.equal(pt.coeffs,
                           real(to_host(port._dot_secret(ct)))[0].coeffs)
        assert int(pt.coeffs[0]) in (1234, 1235) and not pt.coeffs[1:].any()
