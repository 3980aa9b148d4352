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
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

VALS_A, VALS_B = [1, -2, 3000, 4], [9, 8, -7, 6]


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
