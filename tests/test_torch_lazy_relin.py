"""Lazy relinearization and transparent rotation hoisting on the port's
factory (the port of tests/test_lazy_relin.py): the same handle-level op
sequences run on the port (CPU, n=1024) and on abc_tpu's np64 factory of the
same seed. The op counters are the reference test's numbers and equal the
reference's, the decrypted slots equal the oracle, and the result words are
identical (no tolerance). The whole-program graph leans on these counters:
they move while a program is walked and never at a replay.
"""

import numpy as np
import pytest

import abc_tpu.runtime.values as ref_values
import abc_tpu.utils.datatype as ref_datatype
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.values import Cleartext
from abc_tpu_torch.utils.datatype import Type
from helpers import run_program
from test_torch_slice import _ref_counters, _run_program_port, _words


class _Side:
    """One factory with its package's Cleartext, counters reset on demand."""

    def __init__(self, factory, cleartext, int_type):
        self.factory, self._cleartext, self._int = factory, cleartext, int_type

    def enc(self, vals):
        return self.factory.create_ciphertext(self.plain(vals))

    def plain(self, vals):
        return self._cleartext([int(v) for v in vals], self._int)

    def reset(self):
        for k in self.factory.context.counters:
            self.factory.context.counters[k] = 0

    @property
    def counters(self):
        return dict(self.factory.context.counters)


def _sides():
    return (_Side(BfvCiphertextFactory(slots=1024, seed=17, device="cpu"),
                  Cleartext, Type.INT),
            _Side(RefFactory(slots=1024, seed=17, engine="np64"),
                  ref_values.Cleartext, ref_datatype.Type.INT))


def _sum_of_products(s):
    """sum_k (a_k * b_k) decrypted directly: 4 multiplies, 0 relins."""
    rng = np.random.default_rng(0)
    av, bv = rng.integers(0, 50, (4, 8)), rng.integers(0, 50, (4, 8))
    cts = [s.enc(a) for a in av] + [s.enc(b) for b in bv]
    s.reset()
    acc = cts[0].multiply(cts[4])
    for k in range(1, 4):
        acc = acc.add(cts[k].multiply(cts[4 + k]))
    want = (av.astype(np.int64) * bv.astype(np.int64)).sum(axis=0)
    return [acc], [list(want)], {"mult": 4, "relin": 0, "galois": 0}


def _product_then_rotate(s):
    """(a*b) rotated: the deferred key switch fires exactly once."""
    a, b = s.enc(range(1, 9)), s.enc(range(2, 10))
    s.reset()
    out = a.multiply(b).rotate_rows(1)
    return [out], [[(i + 1) * (i + 2) for i in range(1, 8)]], \
        {"relin": 1, "galois": 1}


def _tree_of_products(s):
    """(a*b)*(c*d): each inner product relinearizes once when consumed by
    the outer multiply; the outer product itself is never relinearized."""
    cts = [s.enc([v] * 4) for v in (2, 3, 5, 7)]
    s.reset()
    out = cts[0].multiply(cts[1]).multiply(cts[2].multiply(cts[3]))
    return [out], [[2 * 3 * 5 * 7]], {"mult": 3, "relin": 2}


def _mixed_size_add_and_plain_ops(s):
    """size-3 (+|-) size-2 aligns by zero-padding; plaintext ops apply to
    size-3 operands without forcing a key switch."""
    a, b, x = s.enc([3] * 4), s.enc([4] * 4), s.enc([10] * 4)
    s.reset()
    prod = a.multiply(b)                       # size 3
    first = prod.add(x)                        # 3 + 2 -> pad
    t = x.subtract(prod)                       # 2 - 3 -> pad
    t = t.add_plain(s.plain([1] * 4))
    t = t.multiply_plain(s.plain([2] * 4))
    u = t.subtract_plain(s.plain([5] * 4)).subtract_from_plain(
        s.plain([100] * 4))
    return [first, t, u], [[22], [(10 - 12 + 1) * 2], [100 - (-2 - 5)]], \
        {"relin": 0, "mult": 1}


def _rotations_share_decomposition(s):
    """k rotations of the SAME ciphertext: 1 decomposition, k-1 cache hits
    (transparent hoisting in BfvContext.apply_galois)."""
    ct = s.enc(range(16))
    s.reset()
    outs = [ct.rotate_rows(k) for k in (1, 2, 3, 5)]
    return outs, [[k] for k in (1, 2, 3, 5)], \
        {"galois": 4, "decomp": 1, "decomp_hit": 3}


def _rotation_cache_distinguishes_ciphertexts(s):
    """Rotating DIFFERENT ciphertexts never false-hits the cache."""
    a, b = s.enc(range(8)), s.enc(range(8, 16))
    s.reset()
    return [a.rotate_rows(1), b.rotate_rows(1)], [[1], [9]], \
        {"decomp": 2, "decomp_hit": 0}


def _repeated_multiplicand_shares_operand_ntt(s):
    """A ciphertext multiplied repeatedly lifts+transforms ONCE (the
    operand-NTT cache, BfvContext._operand_cached)."""
    a = s.enc([3] * 4)
    xs = [s.enc([v] * 4) for v in (2, 4, 5)]
    s.reset()
    outs = [x.multiply(a) for x in xs]           # a is the shared factor
    return outs, [[3 * v] for v in (2, 4, 5)], \
        {"mult": 3, "op_ntt": 4, "op_ntt_hit": 2}


def _squaring_shares_the_operand(s):
    a = s.enc([3] * 4)
    s.reset()
    return [a.multiply(a)], [[9]], {"mult": 1, "op_ntt": 1, "op_ntt_hit": 0}


def _column_rotation_after_product(s):
    a, b = s.enc([2] * 4), s.enc([6] * 4)
    s.reset()
    return [a.multiply(b).rotate_columns()], [[12]], \
        {"relin": 1, "galois": 1, "decomp": 1}


SEQUENCES = [_sum_of_products, _product_then_rotate, _tree_of_products,
             _mixed_size_add_and_plain_ops, _rotations_share_decomposition,
             _rotation_cache_distinguishes_ciphertexts,
             _repeated_multiplicand_shares_operand_ntt,
             _squaring_shares_the_operand, _column_rotation_after_product]


@pytest.mark.parametrize("sequence", SEQUENCES,
                         ids=[f.__name__.lstrip("_") for f in SEQUENCES])
def test_op_counts_words_and_decryption(sequence):
    port, ref = _sides()
    outs, wants, counts = sequence(port)
    port_counters = port.counters
    ref_outs, _, _ = sequence(ref)
    assert _ref_counters(port_counters) == ref.counters
    assert {k: port_counters[k] for k in counts} == counts
    for out, ref_out, want in zip(outs, ref_outs, wants):
        np.testing.assert_array_equal(_words(out), _words(ref_out))
        assert list(port.factory.decrypt(out)[:len(want)]) == want


def test_noise_budget_reads_size3():
    """noiseBits works on the pre-relin size-3 form (lower noise than the
    relinearized form: the key-switch error has not been added yet), and
    reads the reference's bits."""
    port, ref = _sides()
    bits = []
    for s in (port, ref):
        prod = s.enc([5] * 4).multiply(s.enc([6] * 4))
        nb3 = prod.noise_bits()
        nb2 = type(prod)(s.factory.context.relinearize(prod.ct),
                         s.factory).noise_bits()
        assert nb3 >= nb2 > 0
        bits.append((nb3, nb2))
    assert bits[0] == bits[1]


def test_executor_program_counts():
    """A DSL program whose body is a sum of rotated products through the
    three-AST executor protocol: 1 decomposition (the second rotation of x
    cache-hits), 0 relinearizations (the size-3 sum is decrypted
    directly)."""
    port, ref = _sides()
    src = ("secret int x = {1, 2, 3, 4};",
           "secret int y = x *** rotate(x, 1) +++ x *** rotate(x, 2);"
           " return y;", "y = y;")
    _, out = _run_program_port(*src, port.factory)
    _, ref_out = run_program(*src, factory=ref.factory)
    c = port.counters
    assert _ref_counters(c) == ref.counters
    assert (c["galois"], c["decomp"], c["decomp_hit"], c["mult"],
            c["relin"]) == (2, 1, 1, 2, 0)
    np.testing.assert_array_equal(_words(out[0][1]), _words(ref_out[0][1]))
    assert port.factory.decrypt(out[0][1])[0] == 1 * 2 + 1 * 3
