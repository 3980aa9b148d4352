"""The port's coefficient-sharded NTT (abc_tpu_torch.parallel.dist_ntt)
against abc_tpu: every case of tests/test_dist_ntt.py (D ∈ {2, 4, 8},
pipeline_chunks, the exchange census) on LocalComm meshes, each
word-identical (np.testing.assert_array_equal; residues are canonical) to
the single-device NttContext of the port and to abc_tpu's DistNttContext on
its virtual devices; the per-shard tables compared word for word with the
reference's; and on the card, the shards' local stages on the NTT kernels
at S ≥ 1024, held against the plain versions.
"""

import numpy as np
import pytest
import torch

from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import as_residues, to_host
from abc_tpu_torch.parallel.dist_ntt import DistNttContext
from abc_tpu_torch.parallel.mesh import coeff_mesh
from abc_tpu_torch.parallel.report import collective_report


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ctx(n, L=3, device="cpu"):
    moduli = gen_ntt_primes(30, L, n)
    return NttContext(n, moduli, device), moduli


def _rand(moduli, n, batch=(), seed=0):
    L = len(moduli)
    rng = np.random.default_rng(seed)
    hi = np.asarray(moduli, dtype=np.uint64).reshape(L, 1)
    return rng.integers(0, hi, size=batch + (L, n),
                        dtype=np.uint64).astype(np.uint32)


def _t(a, device="cpu"):
    return as_residues(a, device)


def _ref(n, moduli, D, pipeline_chunks=2):
    """abc_tpu's DistNttContext and its mesh of D virtual devices."""
    import jax
    from jax.sharding import Mesh
    from abc_tpu.crypto.ntt import NttContext as RefNtt
    from abc_tpu.parallel.dist_ntt import DistNttContext as RefDist
    rctx = RefNtt(n, moduli, engine="jx32")
    return jax, RefDist(rctx, D, pipeline_chunks=pipeline_chunks), \
        Mesh(np.asarray(jax.devices()[:D]), ("coeff",))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_fwd_matches_local(D):
    n = 256
    ctx, moduli = _ctx(n)
    dist = DistNttContext(ctx, D)
    a = _rand(moduli, n)
    got = to_host(dist.make_fwd(coeff_mesh(D, device="cpu"))(_t(a)))
    np.testing.assert_array_equal(got, to_host(ctx.fwd(_t(a))))
    jax, rdist, rmesh = _ref(n, moduli, D)
    want = jax.jit(rdist.make_fwd(rmesh))(jax.numpy.asarray(a))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("D", [2, 8])
def test_inv_roundtrip(D):
    n = 128
    ctx, moduli = _ctx(n, L=2)
    dist = DistNttContext(ctx, D)
    a = _rand(moduli, n, seed=1)
    mesh = coeff_mesh(D, device="cpu")
    back = dist.make_inv(mesh)(dist.make_fwd(mesh)(_t(a)))
    np.testing.assert_array_equal(to_host(back), a)


def test_inv_matches_local():
    n, D = 256, 4
    ctx, moduli = _ctx(n)
    dist = DistNttContext(ctx, D)
    a = _rand(moduli, n, seed=2)
    got = to_host(dist.make_inv(coeff_mesh(D, device="cpu"))(_t(a)))
    np.testing.assert_array_equal(got, to_host(ctx.inv(_t(a))))
    jax, rdist, rmesh = _ref(n, moduli, D)
    want = jax.jit(rdist.make_inv(rmesh))(jax.numpy.asarray(a))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_batched_ciphertext_shapes():
    """[k, L, n] ciphertext layout: leading axes are batch axes."""
    n, D = 128, 8
    ctx, moduli = _ctx(n, L=2)
    dist = DistNttContext(ctx, D)
    a = _rand(moduli, n, batch=(2,), seed=3)
    got = dist.make_fwd(coeff_mesh(D, device="cpu"))(_t(a))
    np.testing.assert_array_equal(to_host(got), to_host(ctx.fwd(_t(a))))


def test_negacyclic_mul_matches_local():
    n, D = 256, 8
    ctx, moduli = _ctx(n)
    dist = DistNttContext(ctx, D)
    a = _rand(moduli, n, seed=4)
    b = _rand(moduli, n, seed=5)
    got = to_host(dist.make_negacyclic_mul(coeff_mesh(D, device="cpu"))(
        _t(a), _t(b)))
    np.testing.assert_array_equal(
        got, to_host(ctx.negacyclic_mul(_t(a), _t(b))))
    jax, rdist, rmesh = _ref(n, moduli, D)
    want = jax.jit(rdist.make_negacyclic_mul(rmesh))(
        jax.numpy.asarray(a), jax.numpy.asarray(b))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_pipelined_exchanges_bit_exact(nc):
    """Chunked exchange pipelining must not change a single bit: nc
    independent (exchange → butterfly) chains per cross stage, same math."""
    n, D = 256, 8
    ctx, moduli = _ctx(n)
    dist = DistNttContext(ctx, D, pipeline_chunks=nc)
    a = _rand(moduli, n, seed=7)
    mesh = coeff_mesh(D, device="cpu")
    got = dist.make_fwd(mesh)(_t(a))
    np.testing.assert_array_equal(to_host(got), to_host(ctx.fwd(_t(a))))
    np.testing.assert_array_equal(to_host(dist.make_inv(mesh)(got)), a)


def test_pipelined_exchange_census():
    """nc exchanges per cross stage, with the SAME total payload bytes as
    the sequential schedule (the reference reads this from the HLO; the
    port's mesh counts what it runs)."""
    n, D = 256, 8
    ctx, moduli = _ctx(n)
    a = _t(_rand(moduli, n, seed=8))
    stats = {}
    for nc in (1, 2):
        dist = DistNttContext(ctx, D, pipeline_chunks=nc)
        mesh = coeff_mesh(D, device="cpu")
        stats[nc] = collective_report(mesh, dist.make_fwd(mesh),
                                      a)["collective-permute"]
    logD = 3
    assert stats[1]["ops"] == logD          # sequential: 1 exchange/stage
    assert stats[2]["ops"] == 2 * logD      # pipelined: nc exchanges/stage
    assert stats[1]["bytes"] == stats[2]["bytes"] == logD * 3 * (n // D) * 4


@pytest.mark.parametrize("D", [2, 8])
def test_tables_equal_the_reference(D):
    """cross_f/fs/i/is and loc_f/fs/i/is word for word as numpy arrays."""
    n = 256
    ctx, moduli = _ctx(n)
    dist = DistNttContext(ctx, D)
    _, rdist, _ = _ref(n, moduli, D)
    for name in ("cross_f", "cross_fs", "cross_i", "cross_is", "loc_f",
                 "loc_fs", "loc_i", "loc_is"):
        np.testing.assert_array_equal(to_host(getattr(dist, name)),
                                      np.asarray(getattr(rdist, name)),
                                      err_msg=name)


def test_refusals():
    ctx, _ = _ctx(256)
    with pytest.raises(ValueError, match="power of two"):
        DistNttContext(ctx, 3)
    with pytest.raises(ValueError, match="pipeline_chunks"):
        DistNttContext(ctx, 8, pipeline_chunks=3)
    with pytest.raises(ValueError, match="4 shards, the tables 8"):
        DistNttContext(ctx, 8).make_fwd(coeff_mesh(4, device="cpu"))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n, D", [(8192, 8), (32768, 8)])
def test_dist_ntt_on_cuda(cuda, n, D):
    """One launch per direction for all D shards (S = n/D ≥ 1024), the words
    of the single-device kernels and of the port's CPU run; the shard-table
    launches against the plain versions."""
    ctx, moduli = _ctx(n, L=8, device=cuda)
    dist = DistNttContext(ctx, D)
    mesh = coeff_mesh(D, device=cuda)
    a = _rand(moduli, n, seed=9)
    x = _t(a, cuda)
    before = dict(nk.launches)
    f = dist.make_fwd(mesh)(x)
    assert nk.launches["ntt_fwd"] == before["ntt_fwd"] + 1
    assert torch.equal(f, ctx.fwd(x))
    assert torch.equal(dist.make_inv(mesh)(f), x)
    cpu_ctx, _ = _ctx(n, L=8)
    assert torch.equal(f.cpu(), cpu_ctx.fwd(_t(a)))
    b = dist.bind(mesh)
    flat = mesh.scatter(x, "coeff", dim=-1).contiguous().flatten(-3, -2)
    assert torch.equal(nk.ntt_fwd(flat, b["q"], b["loc_f"], b["loc_fs"]),
                       nk.fwd_ntt_plain(flat, b["q"], b["loc_f"]))
    assert torch.equal(
        nk.ntt_inv(flat, b["q"], b["loc_i"], b["loc_is"], b["unit"],
                   b["unit_sh"]),
        nk.inv_ntt_plain(flat, b["q"], b["loc_i"], b["unit"]))
