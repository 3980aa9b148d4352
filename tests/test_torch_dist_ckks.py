"""The port's coefficient-sharded CKKS multiply + relin
(abc_tpu_torch.parallel.dist_ckks) against abc_tpu: the cases of
tests/test_dist_ckks.py on LocalComm meshes, word-identical
(np.testing.assert_array_equal) to the single-device
CkksContext.multiply(..., rescale=False) of the port and to abc_tpu's
DistCkksMultiplier on its virtual devices; decrypted values to the
reference test's tolerance (0.05, CKKS noise at scale 2^25, n=128).
"""

import numpy as np
import pytest
import torch

from abc_tpu_torch.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
from abc_tpu_torch.parallel.mesh import coeff_mesh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_multiply_matches_local(D):
    import jax
    from jax.sharding import Mesh
    from abc_tpu.crypto.ckks import CkksContext as RefCtx
    from abc_tpu.crypto.ckks import CkksParams as RefParams
    from abc_tpu.parallel.dist_ckks import DistCkksMultiplier as RefDist

    n, levels = 128, 3
    ctx = CkksContext(CkksParams.create(n, levels=levels, seed=11), "cpu")
    dist = DistCkksMultiplier(ctx, coeff_mesh(D, device="cpu"))
    vals = np.linspace(-1.0, 1.0, n // 2)
    a = ctx.encrypt(ctx.encode(vals))
    b = ctx.encrypt(ctx.encode(vals[::-1].copy()))
    got = to_host(dist(a.data, b.data))
    want = ctx.multiply(a, b, rescale=False).data
    np.testing.assert_array_equal(got, to_host(want))

    ref = RefCtx(RefParams.create(n, levels=levels, engine="jx32", seed=11))
    ref.get_relin_key()
    ra = ref.encrypt(ref.encode(vals))
    rb = ref.encrypt(ref.encode(vals[::-1].copy()))
    np.testing.assert_array_equal(np.asarray(ra.data), to_host(a.data))
    rdist = RefDist(ref, Mesh(np.asarray(jax.devices()[:D]), ("coeff",)))
    rgot = jax.jit(rdist)(jax.numpy.asarray(np.asarray(ra.data)),
                          jax.numpy.asarray(np.asarray(rb.data)))
    np.testing.assert_array_equal(got, np.asarray(rgot))


def test_sharded_multiply_decrypts_correctly():
    n, levels, D = 128, 3, 8
    ctx = CkksContext(CkksParams.create(n, levels=levels, seed=12), "cpu")
    dist = DistCkksMultiplier(ctx, coeff_mesh(D, device="cpu"))
    vals = np.linspace(0.1, 0.9, n // 2)
    a = ctx.encrypt(ctx.encode(vals))
    b = ctx.encrypt(ctx.encode(vals))
    out = dist(a.data, b.data)
    ct = CkksCiphertext(out, a.level, a.scale * b.scale)
    got = ctx.decode(ctx.decrypt(ct)).real[:n // 2]
    np.testing.assert_allclose(got, vals * vals, atol=0.05)
    # 4 transforms of 3 exchange stages, 2 chunks each
    assert dist.mesh.census["collective-permute"]["ops"] == 5 * 3 * 2


def test_refuses_hybrid_digits_and_other_devices():
    ctx = CkksContext(CkksParams.create(128, levels=4, seed=1, ks_digits=2),
                      "cpu")
    with pytest.raises(ValueError, match="k=1"):
        DistCkksMultiplier(ctx, coeff_mesh(2, device="cpu"))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_sharded_multiply_on_cuda(cuda):
    """The reference's production shape (n=32768, levels=8, k=1) on 8
    shards of the card: S = 4096; the words of the single-device op; 5
    forward and 4 inverse launches (one per transform, all shards)."""
    n = 32768
    ctx = CkksContext(CkksParams.create(n, levels=8, seed=23), cuda)
    dist = DistCkksMultiplier(ctx, coeff_mesh(8, device=cuda))
    vals = np.linspace(0.1, 0.9, 64)
    a = ctx.encrypt(ctx.encode(vals))
    b = ctx.encrypt(ctx.encode(vals))
    before = dict(nk.launches)
    got = dist(a.data, b.data)
    assert nk.launches["ntt_fwd"] - before["ntt_fwd"] == 3
    assert nk.launches["ntt_inv"] - before["ntt_inv"] == 2
    assert torch.equal(got, ctx.multiply(a, b, rescale=False).data)
