"""abc_tpu_torch.ops.modarith — the torch engine against the reference
engines np64 and jx32, word for word, at the preset primes.

Inputs are drawn with numpy from a seed; residues are integers, so the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from abc_tpu.crypto.params import BfvParams
from abc_tpu.ops.modarith import barrett_mu, jx32, np64, shoup
from abc_tpu_torch.ops.modarith import as_residues, t64, to_host

WIDTH = 512


def _case(n, seed=0):
    """Preset coefficient primes for ring degree n, and random operands."""
    moduli = BfvParams.create(n).coeff_modulus
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    a, b, w = (rng.integers(0, q, size=(len(moduli), WIDTH), dtype=np.uint64)
               for _ in range(3))
    a[:, 0] = 0                                   # neg/sub edge cases
    b[:, 1] = a[:, 1]
    a[:, 2] = q[:, 0] - 1
    mu = np.asarray([barrett_mu(int(p)) for p in moduli],
                    dtype=np.uint32).reshape(-1, 1)
    wsh = np.vectorize(lambda v, p: shoup(int(v), int(p)), otypes=[np.uint64])(
        w, q).astype(np.uint32)
    u32 = lambda x: x.astype(np.uint32)           # noqa: E731
    return u32(q), u32(a), u32(b), u32(w), wsh, mu


OPS = {
    "add": lambda e, a, b, w, wsh, q, mu: e.add(a, b, q),
    "sub": lambda e, a, b, w, wsh, q, mu: e.sub(a, b, q),
    "neg": lambda e, a, b, w, wsh, q, mu: e.neg(a, q),
    "mul": lambda e, a, b, w, wsh, q, mu: e.mul(a, b, q, mu),
    "mul_shoup": lambda e, a, b, w, wsh, q, mu: e.mul_shoup(a, w, wsh, q),
}


@pytest.mark.parametrize("n", [1024, 8192, 16384])
@pytest.mark.parametrize("op", sorted(OPS))
def test_torch_engine_matches_np64_and_jx32(op, n):
    jnp = pytest.importorskip("jax.numpy")
    q, a, b, w, wsh, mu = _case(n, seed=n)
    args = (a, b, w, wsh, q, mu)
    want = OPS[op](np64, *args)
    got_jx = np.asarray(OPS[op](jx32, *[jnp.asarray(x) for x in args]))
    got = OPS[op](t64, *[as_residues(x, "cpu") for x in args])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got_jx, want)
    np.testing.assert_array_equal(to_host(got), want)


def test_sum_mod_matches_np64_accumulation():
    from abc_tpu.crypto.behz import _acc_mod
    q, a, *_ = _case(8192, seed=3)
    a64, q64 = a.astype(np.uint64), q.astype(np.uint64)
    terms = np.stack([a64, a64[::-1] % q64, a64 * 7 % q64]
                     ).astype(np.uint32)                  # [3, L, W]
    want = _acc_mod(terms, q, np64, axis=0)
    got = t64.sum_mod(as_residues(terms, "cpu"), as_residues(q, "cpu"))
    np.testing.assert_array_equal(to_host(got), want)


def test_words_round_trip_bit_for_bit():
    """Shoup companions use all 32 bits; int32 storage keeps the bits."""
    words = np.asarray([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                       dtype=np.uint32)
    t = as_residues(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_host(t), words)


@pytest.mark.parametrize("n", [1024, 8192, 16384])
def test_barrett_mu_and_shoup_are_the_reference_s(n):
    """The port's own table helpers give the reference's words, at the
    preset primes and at the 20-bit plain modulus (mu placeholder 0)."""
    from abc_tpu_torch.ops import modarith as port
    params = BfvParams.create(n)
    for q in params.coeff_modulus + [params.plain_modulus]:
        assert port.barrett_mu(q) == barrett_mu(q)
        for w in (0, 1, q // 3, q - 1):
            assert port.shoup(w, q) == shoup(w, q)
    with pytest.raises(ValueError):
        port.barrett_mu(1 << 30)
