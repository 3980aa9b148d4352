"""The batch contract of abc_tpu_torch's BFV evaluation half: a leading axis
of B independent ciphertexts, [B, 2, L, n] or [B, 3, L, n], gives, row for
row, the words of B separate calls.

Held against the reference (abc_tpu): the same numpy-seeded inputs at n=1024
go through B separate calls of an np64 context of the same seed, and through
`jax.vmap` of a jx32 context as the reference's bench batches them; and
against B separate calls of the port itself. Tolerance: none, the words are
equal.
"""

import numpy as np
import pytest
import torch

from abc_tpu.crypto.bfv import BfvCiphertext as RefBfvCiphertext
from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops.modarith import to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

N, SEED, BMAX = 1024, 17, 3


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def world(request):
    """(port context on the CPU, reference np64 context of the same seed,
    a [BMAX, 2, L, n] batch, b [BMAX, 2, L, n]): fresh encryptions of
    numpy-seeded values."""
    k = request.param
    port = BfvContext(BfvParams.create(N, seed=SEED, ks_digits=k), "cpu")
    ref = RefBfvContext(RefBfvParams.create(N, seed=SEED, engine="np64",
                                            ks_digits=k))
    rng = np.random.default_rng(SEED + k)
    vals = rng.integers(-50, 50, size=(2 * BMAX, 8)).tolist()
    cts = port.encrypt_many([port.encode(v) for v in vals])
    data = torch.stack([c.data for c in cts])
    return port, ref, data[:BMAX], data[BMAX:], vals


def _ref(t):
    return RefBfvCiphertext(to_host(t))


def _same(got, want_rows):
    """got: a batched port tensor; want_rows: one array per row."""
    assert got.shape[0] == len(want_rows)
    for i, want in enumerate(want_rows):
        assert np.array_equal(to_host(got[i]), np.asarray(want)), f"row {i}"


@pytest.mark.parametrize("B", [1, 3])
def test_multiply_batch_equals_separate_reference_calls(world, B):
    port, ref, a, b, vals = world
    got = port.multiply(BfvCiphertext(a[:B]), BfvCiphertext(b[:B]))
    assert got.size == 2 and got.data.shape == a[:B].shape
    _same(got.data, [ref.multiply(_ref(a[i]), _ref(b[i])).data
                     for i in range(B)])
    want = [x * y for x, y in zip(vals[0], vals[BMAX])]
    assert port.decode(port.decrypt(BfvCiphertext(got.data[0])))[:8] == want


@pytest.mark.parametrize("B", [1, 3])
def test_rotate_rows_batch_equals_separate_reference_calls(world, B):
    port, ref, a, _, _ = world
    got = port.rotate_rows(BfvCiphertext(a[:B]), 3)
    _same(got.data, [ref.rotate_rows(_ref(a[i]), 3).data for i in range(B)])
    got = port.rotate_columns(BfvCiphertext(a[:B]))
    _same(got.data, [ref.rotate_columns(_ref(a[i])).data for i in range(B)])


def test_relinearize_size3_batch_equals_separate_reference_calls(world):
    port, ref, a, b, _ = world
    ct3 = port.multiply(BfvCiphertext(a), BfvCiphertext(b), relinearize=False)
    assert ct3.size == 3 and ct3.data.shape[0] == BMAX
    _same(ct3.data, [ref.multiply(_ref(a[i]), _ref(b[i]),
                                  relinearize=False).data
                     for i in range(BMAX)])
    got = port.relinearize(ct3)
    assert got.size == 2
    _same(got.data, [ref.relinearize(_ref(ct3.data[i])).data
                     for i in range(BMAX)])


def test_multiply_batch_equals_vmap_of_jx32(world):
    """The reference's own batching (bench.py: jax.vmap of the jx32 step)
    gives the words of the port's batch axis."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    port, _, a, b, _ = world
    k = port.params.ks_digits
    jx = RefBfvContext(RefBfvParams.create(N, seed=SEED, engine="jx32",
                                           ks_digits=k))
    jx.ensure_eval_ready()
    jx.get_relin_key()

    def mult(x, y):
        return jx.multiply(RefBfvCiphertext(x), RefBfvCiphertext(y)).data

    want = jax.jit(jax.vmap(mult))(jnp.asarray(to_host(a)),
                                   jnp.asarray(to_host(b)))
    got = port.multiply(BfvCiphertext(a), BfvCiphertext(b))
    assert np.array_equal(to_host(got.data), np.asarray(want))


OPS = {
    "multiply": lambda c, a, b, pt: c.multiply(a, b),
    "square": lambda c, a, b, pt: c.square(a),
    "multiply_lazy": lambda c, a, b, pt: c.multiply(a, b, relinearize=False),
    "rotate_rows": lambda c, a, b, pt: c.rotate_rows(a, 5),
    "rotate_columns": lambda c, a, b, pt: c.rotate_columns(a),
    "hoisted": lambda c, a, b, pt: c.hoisted_rotations(a, [1, 0, 7])[2],
    "add": lambda c, a, b, pt: c.add(a, b),
    "sub": lambda c, a, b, pt: c.sub(a, b),
    "negate": lambda c, a, b, pt: c.negate(a),
    "add_plain": lambda c, a, b, pt: c.add_plain(a, pt),
    "sub_plain": lambda c, a, b, pt: c.sub_plain(a, pt),
    "sub_from_plain": lambda c, a, b, pt: c.sub_from_plain(a, pt),
    "multiply_plain": lambda c, a, b, pt: c.multiply_plain(a, pt),
    "hamming_step": lambda c, a, b, pt: c.add(
        c.square(c.sub(a, b)), c.rotate_rows(c.square(c.sub(a, b)), 2)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_batch_rows_equal_separate_port_calls(world, op):
    port, _, a, b, vals = world
    pt = port.encode(vals[1])
    with port.fresh_caches():
        got = OPS[op](port, BfvCiphertext(a), BfvCiphertext(b), pt)
    for i in range(BMAX):
        with port.fresh_caches():
            want = OPS[op](port, BfvCiphertext(a[i]), BfvCiphertext(b[i]),
                           pt)
        assert got.size == want.size
        assert torch.equal(got.data[i], want.data), f"{op} row {i}"


@pytest.mark.parametrize("size", [2, 3])
def test_multiply_plain_scalar_batch(world, size):
    """A batch [B, size, L, n] times a plaintext whose slots all hold one
    value: row for row the words of separate calls, of the transform path
    written out here, and of the reference's separate calls; each row
    decrypts to c·x mod t slot by slot."""
    port, ref, a, b, vals = world
    n, t, L = N, port.params.plain_modulus, port.params.L
    c = int(np.random.default_rng(SEED).integers(-t // 2, t // 2))
    pt = port.encode([c] * n)
    assert pt.scalar == c % t
    data = a if size == 2 else port.multiply(
        BfvCiphertext(a), BfvCiphertext(b), relinearize=False).data
    got = port.multiply_plain(BfvCiphertext(data), pt).data
    assert got.shape == data.shape
    ntt = port.ntt_q
    oracle = ntt.inv(ew.mul(ntt.fwd(data),
                            ntt.fwd(pt.coeffs.expand(L, -1).contiguous()),
                            port.q_q, ntt.ratio))
    assert torch.equal(got, oracle)
    for i in range(BMAX):
        want = port.multiply_plain(BfvCiphertext(data[i]), pt)
        assert torch.equal(got[i], want.data), f"row {i}"
    _same(got, [ref.multiply_plain(_ref(data[i]), ref.encode([c] * n)).data
                for i in range(BMAX)])
    for i in range(BMAX):
        x = vals[i] if size == 2 else [
            u * v for u, v in zip(vals[i], vals[BMAX + i])]
        want = [(c * v) % t for v in x + [0] * (n - len(x))]
        got_slots = port.decode(port.decrypt(BfvCiphertext(got[i])),
                                signed=False)
        assert got_slots == want, f"row {i}"


def test_two_leading_axes(world):
    """Any number of leading axes: [2, 2, 2, L, n] through multiply."""
    port, _, a, b, _ = world
    a4 = torch.stack([a[:2], a[1:3]])
    b4 = torch.stack([b[:2], b[1:3]])
    got = port.multiply(BfvCiphertext(a4), BfvCiphertext(b4))
    want = port.multiply(BfvCiphertext(a[2]), BfvCiphertext(b[2]))
    assert got.data.shape == a4.shape
    assert torch.equal(got.data[1, 1], want.data)


def test_size_reads_the_ciphertext_axis(world):
    _, _, a, _, _ = world
    assert BfvCiphertext(a).size == 2 and BfvCiphertext(a[0]).size == 2
    assert BfvCiphertext(torch.zeros(5, 3, 4, 8, dtype=torch.int32)).size == 3
