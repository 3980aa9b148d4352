"""abc_tpu_torch BFV evaluation against the reference, word for word.

The port builds its own context on CPU tensors (plain NTT) from the seed;
the reference side is an abc_tpu jx32 context of the same seed (n=1024), or
np64 for one mult+relin at n=8192. Same seed → same keys and same
ciphertexts, so every result must be bit-identical.
"""

import numpy as np
import pytest
import torch

from abc_tpu.crypto.bfv import BfvCiphertext as RefBfvCiphertext
from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto import ntt as port_ntt
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

VALS_A, VALS_B = [1, -2, 3000, 4], [9, 8, -7, 6]
SCALAR = -8             # a constant of LaplaceSharpening's weights


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def pair(request):
    """(port context on CPU, reference jx32 context), n=1024, seed 7."""
    pytest.importorskip("jax")
    k = request.param
    ref_jx = RefBfvContext(RefBfvParams.create(1024, seed=7, engine="jx32",
                                               ks_digits=k))
    return BfvContext(BfvParams.create(1024, seed=7, ks_digits=k),
                      "cpu"), ref_jx


def _same(port_ct, ref_ct):
    np.testing.assert_array_equal(to_host(port_ct.data),
                                  np.asarray(ref_ct.data))


def _hoisted(c, a, b, pt):
    return c.hoisted_rotations(a, [1, 3, 0, 512 + 2])


CASES = {
    # the sequence of test_bfv.py::test_jx32_engine_bit_exact_full_pipeline
    "add_mult_rotate": lambda c, a, b, pt: [
        c.rotate_rows(c.multiply(c.add(a, b), b), 2)],
    "multiply_plain": lambda c, a, b, pt: [c.multiply_plain(a, pt)],
    # every slot one value: the port's one elementwise pass against the
    # reference's transforms, of a size-2 and of a size-3 ciphertext
    "multiply_plain_scalar": lambda c, a, b, pt: [
        c.multiply_plain(x, c.encode([SCALAR] * c.params.n))
        for x in (a, c.multiply(a, b, relinearize=False))],
    "rotate_columns": lambda c, a, b, pt: [c.rotate_columns(a)],
    "hoisted_rotations": _hoisted,
    "plain_ops": lambda c, a, b, pt: [
        c.add_plain(a, pt), c.sub_plain(a, pt), c.sub_from_plain(a, pt),
        c.negate(a), c.sub(a, b)],
    "lazy_relin": lambda c, a, b, pt: [
        c.multiply(a, b, relinearize=False),
        c.relinearize(c.multiply(a, a, relinearize=False))],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ops_bit_exact_vs_jx32(pair, case):
    port, ref = pair
    a, b = port.encrypt(port.encode(VALS_A)), port.encrypt(port.encode(VALS_B))
    ra, rb = ref.encrypt(ref.encode(VALS_A)), ref.encrypt(ref.encode(VALS_B))
    _same(a, ra)
    _same(b, rb)
    got = CASES[case](port, a, b, port.encode(VALS_B))
    want = CASES[case](ref, ra, rb, ref.encode(VALS_B))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    if case == "add_mult_rotate":
        expected = [(x + y) * y for x, y in zip(VALS_A, VALS_B)][2:]
        assert port.decode(port.decrypt(got[0]))[:2] == expected
    if case == "multiply_plain_scalar":
        n = port.params.n
        assert port.decode(port.decrypt(got[0])) == \
            _centred([SCALAR * x for x in VALS_A] + [0] * (n - 4), port)
        assert port.decode(port.decrypt(got[1])) == _centred(
            [SCALAR * x * y for x, y in zip(VALS_A, VALS_B)] + [0] * (n - 4),
            port)


def _centred(values, ctx):
    """Residues mod t as decode gives them: in (−t/2, t/2]."""
    t = ctx.params.plain_modulus
    return [v % t - t if v % t > t // 2 else v % t for v in values]


@pytest.fixture(scope="module")
def port1024():
    return BfvContext(BfvParams.create(1024, seed=5), "cpu")


@pytest.mark.parametrize("c", [0, 1, -1, 2, -8, "drawn"])
def test_encode_of_a_constant_is_the_constant_polynomial(port1024, c):
    """The premise of the scalar product: under batching the slot vector
    that holds c everywhere encodes to the polynomial c mod t, and encode
    marks it."""
    n, t = port1024.params.n, port1024.params.plain_modulus
    if c == "drawn":
        c = int(np.random.default_rng(5).integers(-t, t))
    pt = port1024.encode([c] * n)
    want = [c % t] + [0] * (n - 1)
    assert to_host(pt.coeffs).tolist() == want
    assert pt.scalar == c % t
    assert port1024.decode(pt) == _centred([c] * n, port1024)


@pytest.mark.parametrize("values,scalar", [
    ("two_values", None), ("last_differs", None), ("short_non_zero", None),
    ("short_zeros", 0)])
def test_encode_of_other_vectors(port1024, values, scalar):
    """Two distinct values, or a short vector whose zero padding differs
    from its non-zero value, leave `scalar` None; zeros padded with zeros
    are the constant 0."""
    n = port1024.params.n
    vals = {"two_values": [3, 4] * (n // 2),
            "last_differs": [3] * (n - 1) + [4],
            "short_non_zero": [7, 7], "short_zeros": [0, 0]}[values]
    assert port1024.encode(vals).scalar == scalar


def test_mult_relin_ntt_census():
    """One mult+relin of fresh operands: 5 forward and 3 inverse transform
    calls, 4(2L+2) + L(L+1) forward and 3(2L+2) + 2(L+1) inverse limb rows
    (154 rows at the n=8192 preset's L=6)."""
    port = BfvContext(BfvParams.create(1024, seed=3), "cpu")
    a, b = port.encrypt_many([port.encode([1, 2]), port.encode([3, 4])])
    port.get_relin_key()
    port._get_behz()
    calls = {"fwd": [], "inv": []}

    def counting(which, fn):
        def wrapped(x, *args):
            calls[which].append(x.numel() // x.shape[-1])
            return fn(x, *args)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(port_ntt, "ntt_fwd", counting("fwd", nk.ntt_fwd))
    mp.setattr(port_ntt, "ntt_inv", counting("inv", nk.ntt_inv))
    try:
        port.multiply(a, b)
    finally:
        mp.undo()
    L = port.params.L
    assert len(calls["fwd"]) == 5 and len(calls["inv"]) == 3
    assert sum(calls["fwd"]) == 4 * (2 * L + 2) + L * (L + 1)
    assert sum(calls["inv"]) == 3 * (2 * L + 2) + 2 * (L + 1)


def test_plain_product_ntt_census():
    """A product by a scalar plaintext is one elementwise product and no
    transform; by a vector plaintext, 2 forward and 1 inverse transform
    calls around it. Each moves its own counter by one."""
    port = BfvContext(BfvParams.create(1024, seed=3), "cpu")
    a = port.encrypt(port.encode([1, 2]))
    n = port.params.n
    calls = {"fwd": 0, "inv": 0, "mul": 0}

    def counting(which, fn):
        def wrapped(*args, **kw):
            calls[which] += 1
            return fn(*args, **kw)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(port_ntt, "ntt_fwd", counting("fwd", nk.ntt_fwd))
    mp.setattr(port_ntt, "ntt_inv", counting("inv", nk.ntt_inv))
    mp.setattr(ew, "mul", counting("mul", ew.mul))
    try:
        for pt, fwd, inv in ((port.encode([5] * n), 0, 0),
                             (port.encode([5, 6]), 2, 1)):
            kind = "plain_product" if fwd else "plain_scalar"
            before = dict(calls), dict(port.counters)
            port.multiply_plain(a, pt)
            assert {k: calls[k] - before[0][k] for k in calls} == \
                {"fwd": fwd, "inv": inv, "mul": 1}
            assert {k: v - before[1][k] for k, v in port.counters.items()
                    if v != before[1][k]} == {kind: 1}
    finally:
        mp.undo()


def _mult_relin_vs_np64(device, k):
    ref = RefBfvContext(RefBfvParams.create(8192, seed=11, engine="np64",
                                            ks_digits=k))
    port = BfvContext(BfvParams.create(8192, seed=11, ks_digits=k), device)
    a, b = port.encrypt_many([port.encode([3, 4, 5]),
                              port.encode([7, -2, 9])])
    got = port.multiply(a, b)
    want = ref.multiply(RefBfvCiphertext(to_host(a.data)),
                        RefBfvCiphertext(to_host(b.data)))
    np.testing.assert_array_equal(to_host(got.data), want.data)
    assert port.decode(port.decrypt(got))[:3] == [21, -8, 45]
    return port, a, b


@pytest.mark.parametrize("k", [1, 2])
def test_mult_relin_n8192_bit_exact_vs_np64(k):
    _mult_relin_vs_np64("cpu", k)


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_mult_relin_n8192_on_cuda(cuda, k):
    port, a, b = _mult_relin_vs_np64(cuda, k)
    c, d = port.encrypt_many([port.encode([1]), port.encode([2])])
    before = dict(nk.launches)
    port.multiply(c, d)
    torch.cuda.synchronize()
    assert nk.launches["ntt_fwd"] - before["ntt_fwd"] == 5
    assert nk.launches["ntt_inv"] - before["ntt_inv"] == 3
