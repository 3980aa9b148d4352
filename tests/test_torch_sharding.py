"""Limb sharding of the port (abc_tpu_torch.parallel.sharding and
BfvContext.set_limb_sharding) against abc_tpu: the cases of
tests/test_sharding.py on a LocalComm mesh of 8 shards (dp=2 × limb=4) at
n=1024, each word-identical (np.testing.assert_array_equal on the words; no
tolerance: residues are canonical) to abc_tpu's sharded functions on its 8
virtual devices and to the single-device port, plus the context's limb mode
and its refusals. The DistComm form runs in tests/test_torch_multihost.py.
"""

import numpy as np
import pytest
import torch

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.parallel import (make_mesh, sharded_key_switch,
                                    sharded_rotate_rows)
from abc_tpu_torch.parallel.mesh import coeff_mesh
from abc_tpu_torch.utils.errors import RuntimeExecutionError


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(L=4, n=1024, seed=3, ks_digits=1):
    t = gen_ntt_primes(20, 1, n)[0]
    primes = gen_ntt_primes(30, L + ks_digits, n, exclude=[t])
    return BfvParams(n=n, coeff_modulus=primes, plain_modulus=t,
                     engine="jx32", seed=seed, ks_digits=ks_digits)


def make_ctx(device="cpu", **kw):
    return BfvContext(_params(**kw), device)


def _ref(**kw):
    """abc_tpu's context of the same parameters and seed (jx32), its mesh of
    8 virtual devices, and its sharding module."""
    import jax
    from abc_tpu.crypto.bfv import BfvContext as RefContext
    from abc_tpu.crypto.params import BfvParams as RefParams
    from abc_tpu.parallel import sharding
    p = _params(**kw)
    ref = RefContext(RefParams(n=p.n, coeff_modulus=p.coeff_modulus,
                               plain_modulus=p.plain_modulus, engine="jx32",
                               seed=p.seed))
    return jax, ref, sharding.make_mesh(dp=2, limb=4), sharding


def test_local_mesh_has_eight_shards():
    """The counterpart of the reference's 8 virtual devices: 8 shards of a
    dp × limb mesh on one device."""
    mesh = make_mesh(dp=2, limb=4, device="cpu")
    assert mesh.size == 8 and mesh.shape == {"dp": 2, "limb": 4}
    assert mesh.is_local and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        from abc_tpu_torch.parallel.mesh import LocalComm

        class Fake(LocalComm):
            world = 4
        make_mesh(dp=2, limb=4, comm=Fake("cpu"))


def test_sharded_rotation_bit_exact():
    ctx = make_ctx()
    mesh = make_mesh(dp=2, limb=4, device="cpu")
    vals = list(range(16))
    ct = ctx.encrypt(ctx.encode(vals))
    single = ctx.rotate_rows(ct, 3).data
    sharded = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    assert torch.equal(sharded, single)
    assert ctx.decode(ctx.decrypt(BfvCiphertext(sharded)))[:10] == vals[3:13]
    assert mesh.census["all-reduce"]["ops"] == 2

    jax, ref, ref_mesh, sharding = _ref()
    rct = ref.encrypt(ref.encode(vals))
    np.testing.assert_array_equal(np.asarray(rct.data), to_host(ct.data))
    got = jax.jit(lambda d: sharding.sharded_rotate_rows(
        ref, ref_mesh, d, 3))(jax.numpy.asarray(np.asarray(rct.data)))
    np.testing.assert_array_equal(np.asarray(got), to_host(sharded))


def test_sharded_key_switch_jits():
    ctx = make_ctx()
    mesh = make_mesh(dp=1, limb=4, device="cpu")
    ct = ctx.encrypt(ctx.encode([1, 2, 3]))
    ksk = ctx.get_relin_key()
    d = ct.data[1]
    k0, k1 = sharded_key_switch(ctx, mesh, d, ksk)
    rk0, rk1 = ctx._key_switch(d, ksk)
    assert torch.equal(k0, rk0) and torch.equal(k1, rk1)

    jax, ref, _, sharding = _ref()
    rmesh = sharding.make_mesh(dp=1, limb=4)
    rct = ref.encrypt(ref.encode([1, 2, 3]))
    rksk = ref.get_relin_key()
    g0, g1 = jax.jit(lambda x: sharding.sharded_key_switch(
        ref, rmesh, x, rksk))(jax.numpy.asarray(np.asarray(rct.data))[1])
    np.testing.assert_array_equal(np.asarray(g0), to_host(k0))
    np.testing.assert_array_equal(np.asarray(g1), to_host(k1))


def test_local_partials_and_psum_make_the_key_switch_contraction():
    """Each limb shard's partial accumulators are abc_tpu's
    _local_key_switch_partials of the same rows (with and without the
    hoisted Galois permutation), and _psum_mod of the four gives the
    single-device contraction."""
    from abc_tpu_torch.parallel.sharding import (_local_key_switch_partials,
                                                 _psum_mod)
    ctx = make_ctx()
    mesh = make_mesh(dp=1, limb=4, device="cpu")
    ct = ctx.encrypt(ctx.encode([5, 6, 7]))
    d = ct.data[1]
    g = pow(3, 2, 2 * ctx.params.n)
    jax, ref, _, sharding = _ref()
    rct = ref.encrypt(ref.encode([5, 6, 7]))
    rd = jax.numpy.asarray(np.asarray(rct.data))[1]
    for key, rkey, perm, rperm in (
            (ctx.get_relin_key(), ref.get_relin_key(), None, None),
            (ctx.get_galois_key(g), ref.get_galois_key(g),
             ctx._galois_perm_eval(g), ref._galois_perm_eval(g))):
        parts = [_local_key_switch_partials(
            ctx, d[i:i + 1], key[0][i:i + 1], key[1][i:i + 1], perm)
            for i in range(4)]
        for i, (pb, pa) in enumerate(parts):
            rb, ra = sharding._local_key_switch_partials(
                ref, rd[i:i + 1], rkey[0][i:i + 1], rkey[1][i:i + 1], rperm)
            np.testing.assert_array_equal(np.asarray(rb), to_host(pb))
            np.testing.assert_array_equal(np.asarray(ra), to_host(pa))
        D = ctx._lift_ntt(d)
        if perm is not None:
            D = D.index_select(-1, perm)
        want = ctx._ks_partials(D, *key)
        q = ctx._tab["q_full"].reshape(-1, 1)
        for h in range(2):
            got = _psum_mod(torch.stack([p[h] for p in parts]), q, mesh,
                            "limb")
            assert torch.equal(got, want[h])
    with pytest.raises(ValueError, match="k=1"):
        c = make_ctx(L=4, ks_digits=2)
        _local_key_switch_partials(c, d, *key)


def test_sharded_functions_take_a_batch():
    """dp rows: [B, 2, L, n] in one call equals B calls."""
    ctx = make_ctx()
    mesh = make_mesh(dp=2, limb=4, device="cpu")
    cts = ctx.encrypt_many([ctx.encode([i, i + 1]) for i in range(3)])
    batch = torch.stack([c.data for c in cts])
    out = sharded_rotate_rows(ctx, mesh, batch, 1)
    for i, c in enumerate(cts):
        assert torch.equal(out[i], ctx.rotate_rows(c, 1).data)


def test_context_limb_mode_keeps_every_key_switch_word_exact():
    """set_limb_sharding applies to every key switch the context runs:
    relinearization, rotations, hoisted rotations, on a batch too."""
    ctx = make_ctx()
    mesh = make_mesh(dp=2, limb=4, device="cpu")
    a, b = ctx.encrypt_many([ctx.encode([1, 2, 3]), ctx.encode([4, 5, 6])])
    batch = BfvCiphertext(torch.stack([a.data, b.data]))
    with ctx.fresh_caches():
        want = (ctx.multiply(a, b).data, ctx.rotate_rows(a, 2).data,
                [r.data for r in ctx.hoisted_rotations(b, [1, 5])],
                ctx.rotate_columns(batch).data)
    with ctx.fresh_caches(), ctx.limb_sharded(mesh):
        assert ctx._limb_axis == "limb" and ctx._limb_size == 4
        got = (ctx.multiply(a, b).data, ctx.rotate_rows(a, 2).data,
               [r.data for r in ctx.hoisted_rotations(b, [1, 5])],
               ctx.rotate_columns(batch).data)
    assert ctx._limb_axis is None and ctx._limb_mesh is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(x, y) for x, y in zip(got[2], want[2]))
    assert torch.equal(got[3], want[3])
    assert mesh.census["all-reduce"]["ops"] == 2 * 5


def test_single_device_words_and_launches_unchanged():
    """With no limb axis set, a key switch launches what it did before (one
    forward transform of the L·(L+1) digit rows, one inverse of 2·(L+1))
    and its words are abc_tpu's."""
    from abc_tpu.crypto.bfv import BfvContext as RefContext
    from abc_tpu.crypto.params import BfvParams as RefParams

    ctx = make_ctx()
    ct = ctx.encrypt(ctx.encode([7, 8, 9]))
    before = dict(nk.launches)
    rot = ctx.rotate_rows(ct, 1).data
    assert nk.launches == before          # CPU calls never count
    p = _params()
    ref = RefContext(RefParams(n=p.n, coeff_modulus=p.coeff_modulus,
                               plain_modulus=p.plain_modulus, engine="np64",
                               seed=p.seed))
    rct = ref.encrypt(ref.encode([7, 8, 9]))
    np.testing.assert_array_equal(np.asarray(ref.rotate_rows(rct, 1).data),
                                  to_host(rot))


def test_set_limb_sharding_refusals():
    mesh = make_mesh(dp=2, limb=4, device="cpu")
    with pytest.raises(RuntimeExecutionError, match="ks_digits=1"):
        make_ctx(L=4, ks_digits=2).set_limb_sharding("limb", 4, mesh)
    with pytest.raises(RuntimeExecutionError, match="must divide L"):
        make_ctx(L=6).set_limb_sharding("limb", 4, mesh)
    ctx = make_ctx()
    with pytest.raises(RuntimeExecutionError, match="needs the mesh"):
        ctx.set_limb_sharding("limb", 4)
    with pytest.raises(RuntimeExecutionError, match="needs the mesh"):
        ctx.set_limb_sharding("limb", 4, coeff_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="must divide L"):
        sharded_key_switch(make_ctx(L=6), mesh, torch.zeros(6, 1024,
                                                            dtype=torch.int32),
                           (None, None))
    with pytest.raises(ValueError, match="k=1"):
        c = make_ctx(L=4, ks_digits=2)
        sharded_rotate_rows(c, mesh, c.encrypt(c.encode([1])).data, 1)


def test_sharded_keys_switch_only_under_their_sharding():
    """shard_keys keeps a rank's digit rows; a key switch outside limb mode
    then refuses instead of broadcasting a partial key."""
    ctx = make_ctx()
    ct = ctx.encrypt(ctx.encode([1, 2]))
    ctx.get_relin_key()
    ctx.shard_keys(make_mesh(dp=1, limb=4, device="cpu"))
    with pytest.raises(RuntimeExecutionError, match="shard_keys"):
        ctx.multiply(ct, ct)


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_sharded_key_switch_and_rotation_on_cuda(cuda):
    """n=8192, 8 + 1 primes on dp=2 × limb=4 shards of the card: the words
    of the single-device kernels path and of the port's CPU run; the digit
    transforms of all shards go in one launch."""
    ctx = make_ctx(cuda, L=8, n=8192, seed=17)
    cpu = make_ctx("cpu", L=8, n=8192, seed=17)
    mesh = make_mesh(dp=2, limb=4, device=cuda)
    ct = ctx.encrypt(ctx.encode(list(range(16))))
    ksk = ctx.get_relin_key()
    before = dict(nk.launches)
    k0, k1 = sharded_key_switch(ctx, mesh, ct.data[1], ksk)
    assert nk.launches["ntt_fwd"] == before["ntt_fwd"] + 1
    assert nk.launches["ntt_inv"] == before["ntt_inv"] + 1
    r0, r1 = ctx._key_switch(ct.data[1], ksk)
    assert torch.equal(k0, r0) and torch.equal(k1, r1)
    rot = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    assert torch.equal(rot, ctx.rotate_rows(ct, 3).data)
    cct = cpu.encrypt(cpu.encode(list(range(16))))
    assert torch.equal(rot.cpu(), cpu.rotate_rows(cct, 3).data)
