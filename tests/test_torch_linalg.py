"""Hoisted rotations + BSGS packed matrix-vector product of the port
(abc_tpu_torch.crypto.linalg): the port of tests/test_linalg.py, all four
cases, on the CPU. Oracle protocol: decrypt-and-compare against numpy (exact
for BFV, the reference test's 1e-2 for CKKS); and against abc_tpu's np64
context of the same seed, the result words are identical (no tolerance)."""

import numpy as np
import pytest

from abc_tpu.crypto import linalg as ref_linalg
from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.ckks import CkksContext as RefCkksContext
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.linalg import (matvec_bsgs, matvec_bsgs_ckks,
                                         matvec_naive)
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.utils.errors import RuntimeExecutionError

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")


def _ctx(n=256):
    return BfvContext(BfvParams.create(n, seed=5), "cpu")


def _ref(n=256):
    return RefBfvContext(RefBfvParams.create(n, seed=5, engine="np64"))


def test_hoisted_rotations_match_sequential():
    ctx, ref = _ctx(2048), _ref(2048)
    vals = list(range(1, 9))
    ct = ctx.encrypt(ctx.encode(vals))
    rct = ref.encrypt(ref.encode(vals))
    steps = [0, 1, 2, 5, -3]
    hoisted = ctx.hoisted_rotations(ct, steps)
    for s, h, rh in zip(steps, hoisted, ref.hoisted_rotations(rct, steps)):
        want = ctx.decode(ctx.decrypt(ctx.rotate_rows(ct, s)))[:8]
        got = ctx.decode(ctx.decrypt(h))[:8]
        assert got == want, (s, got, want)
        assert ctx.noise_budget(h) > 20
        np.testing.assert_array_equal(to_host(h.data), rh.data)


def test_matvec_bsgs_matches_numpy():
    ctx, ref = _ctx(1024), _ref(1024)
    k = 512
    rng = np.random.default_rng(0)
    mat = rng.integers(-3, 4, size=(k, k))
    x = rng.integers(-5, 6, size=k)
    ct = ctx.encrypt(ctx.encode([int(v) for v in x] * 2))
    out = matvec_bsgs(ctx, ct, mat)
    got = np.asarray(ctx.decode(ctx.decrypt(out))[:k])
    np.testing.assert_array_equal(got, mat @ x)
    rct = ref.encrypt(ref.encode([int(v) for v in x] * 2))
    np.testing.assert_array_equal(
        to_host(out.data), ref_linalg.matvec_bsgs(ref, rct, mat).data)
    assert ctx.counters["decomp"] == ref.counters["decomp"]
    with pytest.raises(RuntimeExecutionError, match="square matrix"):
        matvec_bsgs(ctx, ct, mat[:, :5])


def test_matvec_naive_matches_numpy():
    ctx = _ctx(1024)
    k = 512
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 3, size=(k, k))
    x = rng.integers(0, 4, size=k)
    ct = ctx.encrypt(ctx.encode([int(v) for v in x] * 2))
    out = matvec_naive(ctx, ct, mat)
    got = np.asarray(ctx.decode(ctx.decrypt(out))[:k])
    np.testing.assert_array_equal(got, mat @ x)
    assert ctx.counters["decomp"] == 1          # one hoisted decomposition


def test_matvec_bsgs_ckks_matches_numpy():
    """CKKS BSGS matvec: encrypted mat @ x over the n/2 complex slots
    matches the numpy product, with O(sqrt k) key switches — g baby
    rotations sharing one hoisted decomposition + ~k/g giant rotations."""
    ctx = CkksContext(CkksParams.create(512, levels=3, seed=3), "cpu")
    ref = RefCkksContext(RefCkksParams.create(512, levels=3, engine="np64",
                                              seed=3))
    k = ctx.params.slot_count
    rng = np.random.default_rng(0)
    mat = rng.uniform(-1, 1, (k, k))
    vec = rng.uniform(-1, 1, k)
    ct = ctx.encrypt(ctx.encode(vec, level=ctx.params.L))
    rct = ref.encrypt(ref.encode(vec, level=ref.params.L))
    for c in (ctx, ref):
        for key in c.counters:
            c.counters[key] = 0
    y = matvec_bsgs_ckks(ctx, ct, mat)
    got = np.real(ctx.decode(ctx.decrypt(y)))
    assert np.max(np.abs(got - mat @ vec)) < 1e-2
    g = int(np.sqrt(k))
    # baby (g-1 nonzero) + giant (k//g - 1 nonzero) rotations, not k-1
    assert ctx.counters["galois"] <= 2 * g + 2 < k - 1
    assert ctx.counters["decomp"] <= k // g + 1   # one shared baby decomp
    ry = ref_linalg.matvec_bsgs_ckks(ref, rct, mat)
    np.testing.assert_array_equal(to_host(y.data), ry.data)
    assert (y.level, y.scale) == (ry.level, ry.scale)
    assert ctx.counters == ref.counters
    with pytest.raises(RuntimeExecutionError, match="square matrix"):
        matvec_bsgs_ckks(ctx, ct, mat[:4, :4])
