"""abc_tpu_torch NTT: the plain torch transforms against the reference
(Pallas kernels in interpret mode, the jx32 stage loop, the np64 oracle), the
CPU routing of the kernel wrappers, and — on a CUDA device — the
hand-written kernels against their plain versions.

Inputs are drawn with numpy from a seed; residues are integers, so the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from abc_tpu.crypto.ntt import NttContext as RefNttContext
from abc_tpu.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import as_residues, to_host


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(moduli, n, batch=(), seed=0):
    L = len(moduli)
    rng = np.random.default_rng(seed)
    hi = np.asarray(moduli, dtype=np.uint64).reshape(L, 1)
    return rng.integers(0, hi, size=batch + (L, n),
                        dtype=np.uint64).astype(np.uint32)


def _plain(ctx, which, x):
    if which == "fwd":
        return nk.fwd_ntt_plain(x, ctx.q, ctx.fwd_tw)
    return nk.inv_ntt_plain(x, ctx.q, ctx.inv_tw, ctx.n_inv)


@pytest.mark.parametrize("which", ["fwd", "inv"])
@pytest.mark.parametrize("n", [256, 2048])
def test_plain_matches_pallas_interpret(n, which):
    """The TPU kernels (pallas_fwd_ntt / pallas_inv_ntt) run through the
    Pallas interpreter, as tests/test_pallas_ntt.py runs them."""
    jnp = pytest.importorskip("jax.numpy")
    from abc_tpu.ops import pallas_ntt as pn
    moduli = gen_ntt_primes(30, 2, n)
    ref = RefNttContext(n, moduli, engine="jx32")
    (fpw, fps, flw, fls, ipw, ips, ilw, ils, ninv, ninv_sh) = \
        [jnp.asarray(t) for t in pn.get_tables(ref)]
    q = jnp.asarray(np.asarray(moduli, dtype=np.uint32))
    a = _rand(moduli, n, batch=(2,), seed=n)
    if which == "fwd":
        want = pn.pallas_fwd_ntt(jnp.asarray(a), q, fpw, fps, flw, fls, n=n,
                                 interpret=True)
    else:
        want = pn.pallas_inv_ntt(jnp.asarray(a), q, ipw, ips, ilw, ils, ninv,
                                 ninv_sh, n=n, interpret=True)
    got = _plain(NttContext(n, moduli, "cpu"), which, as_residues(a, "cpu"))
    np.testing.assert_array_equal(to_host(got), np.asarray(want))


@pytest.mark.parametrize("n,q", [(1024, None), (8192, None), (2048, "t"),
                                 (16384, "t")])
def test_twiddle_tables_are_the_reference_s(n, q):
    """The port computes its own ψ^brv tables, Shoup companions and n⁻¹:
    the reference's words, for a 30-bit prime and for the 20-bit plain
    modulus (the encoder's transform)."""
    from abc_tpu.crypto.ntt import _limb_tables as ref_tables
    from abc_tpu.crypto.ntt import eval_perm_tables as ref_perm
    from abc_tpu_torch.crypto import ntt as port
    q = gen_ntt_primes(20, 1, n)[0] if q == "t" else \
        gen_ntt_primes(30, 3, n)[2]
    got, want = port._limb_tables(n, q), ref_tables(n, q)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    (e, pos), (ref_e, ref_pos) = port.eval_perm_tables(n), ref_perm(n)
    np.testing.assert_array_equal(e, ref_e)
    np.testing.assert_array_equal(pos[1::2], ref_pos[1::2])   # odd exponents


def test_plain_matches_jx32_stage_loop():
    jnp = pytest.importorskip("jax.numpy")
    n = 1024
    moduli = gen_ntt_primes(30, 3, n)
    ref = RefNttContext(n, moduli, engine="jx32")
    ctx = NttContext(n, moduli, "cpu")
    a = _rand(moduli, n, batch=(3,), seed=1)
    at = as_residues(a, "cpu")
    np.testing.assert_array_equal(to_host(ctx.fwd(at)),
                                  np.asarray(ref.fwd(jnp.asarray(a))))
    np.testing.assert_array_equal(to_host(ctx.inv(at)),
                                  np.asarray(ref.inv(jnp.asarray(a))))


@pytest.mark.parametrize("n,L,batch", [(1024, 5, (2, 3)), (8192, 7, (3,)),
                                       (16384, 14, (2,))])
def test_plain_matches_np64_with_batch_dims(n, L, batch):
    moduli = gen_ntt_primes(30, L, n)
    ref = RefNttContext(n, moduli, engine="np64")
    ctx = NttContext(n, moduli, "cpu")
    a = _rand(moduli, n, batch=batch, seed=L)
    at = as_residues(a, "cpu")
    f = ctx.fwd(at)
    np.testing.assert_array_equal(to_host(f), ref.fwd(a))
    np.testing.assert_array_equal(to_host(ctx.inv(at)), ref.inv(a))
    np.testing.assert_array_equal(to_host(ctx.inv(f)), a)
    b = as_residues(_rand(moduli, n, seed=L + 1), "cpu")
    np.testing.assert_array_equal(
        to_host(ctx.negacyclic_mul(at[(0,) * len(batch)], b)),
        ref.negacyclic_mul(a[(0,) * len(batch)], to_host(b)))


def test_wrapper_routes_cpu_tensors_to_plain_without_launching():
    n = 1024
    ctx = NttContext(n, gen_ntt_primes(30, 2, n), "cpu")
    a = as_residues(_rand(ctx.moduli, n, seed=4), "cpu")
    before = dict(nk.launches)
    got = nk.ntt_fwd(a, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
    back = nk.ntt_inv(got, ctx.q, ctx.inv_tw, ctx.inv_tw_sh, ctx.n_inv,
                      ctx.n_inv_sh)
    assert torch.equal(got, _plain(ctx, "fwd", a))
    assert torch.equal(back, a)
    assert nk.launches == before


def test_wrapper_refuses_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not computed by the plain version."""
    n = 1024
    ctx = NttContext(n, gen_ntt_primes(30, 2, n), "cpu")
    a = torch.empty((2, n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nk.ntt_fwd(a, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)


# ------------------------------------------------------- leveled views

@pytest.mark.parametrize("indices", [[0, 1, 2], [0], [0, 1, 5, 6], [3, 6],
                                     list(range(7))],
                         ids=["prefix", "one_row", "prefix_and_specials",
                              "gather", "all_rows"])
def test_subset_view_equals_a_fresh_context_of_those_moduli(indices):
    """NttContext.subset(indices): the tables and transforms of a context
    built for exactly those moduli (and of the reference's own subset view),
    with contiguous tables of the view's own row count, which is what the
    kernels take."""
    n = 1024
    moduli = gen_ntt_primes(30, 7, n)
    parent = NttContext(n, moduli, "cpu")
    view = parent.subset(indices)
    fresh = NttContext(n, [moduli[i] for i in indices], "cpu")
    assert view.moduli == fresh.moduli and view.n == n
    for name in ("fwd_tw", "fwd_tw_sh", "inv_tw", "inv_tw_sh", "n_inv",
                 "n_inv_sh", "q", "q_col"):
        got = getattr(view, name)
        assert torch.equal(got, getattr(fresh, name)), name
        assert got.is_contiguous() and got.shape[0] == len(indices)
    rng = np.random.default_rng(7)
    x = np.stack([rng.integers(0, q, size=(2, n)) for q in view.moduli],
                 axis=1).astype(np.uint32)                 # [2, L', n]
    xt = as_residues(x, "cpu")
    ref_view = RefNttContext(n, moduli, engine="np64").subset(indices)
    np.testing.assert_array_equal(to_host(view.fwd(xt)), ref_view.fwd(x))
    np.testing.assert_array_equal(to_host(view.inv(xt)), ref_view.inv(x))
    assert torch.equal(view.inv(view.fwd(xt)), xt)
    assert torch.equal(view.pointwise_mul(xt, xt), fresh.pointwise_mul(xt, xt))


def test_subset_views_are_cached_and_prefixes_are_zero_copy():
    n = 1024
    parent = NttContext(n, gen_ntt_primes(30, 5, n), "cpu")
    a = parent.subset([0, 1, 2])
    assert parent.subset((0, 1, 2)) is a and parent.subset(range(3)) is a
    assert a.fwd_tw.data_ptr() == parent.fwd_tw.data_ptr()     # a slice
    b = parent.subset([0, 1, 4])
    assert b is parent.subset([0, 1, 4]) and b is not a
    assert b.fwd_tw.data_ptr() != parent.fwd_tw.data_ptr()     # one gather
    assert a.subset([0, 2]).moduli == [parent.moduli[0], parent.moduli[2]]


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n,L,batch", [(8192, 6, 1), (8192, 7, 6),
                                       (16384, 14, 8), (32768, 2, 1),
                                       (8192, 6, 2), (8192, 8, 3),
                                       (16384, 14, 1), (1024, 1, 1)])
def test_kernels_match_plain_on_cuda(cuda, n, L, batch):
    moduli = gen_ntt_primes(30, L, n)
    ctx = NttContext(n, moduli, cuda)
    a = as_residues(_rand(moduli, n, batch=(batch,), seed=n + L), cuda)
    before = dict(nk.launches)
    f = ctx.fwd(a)
    back = ctx.inv(f)
    torch.cuda.synchronize()
    assert nk.launches["ntt_fwd"] == before["ntt_fwd"] + 1
    assert nk.launches["ntt_inv"] == before["ntt_inv"] + 1
    assert torch.equal(f, _plain(ctx, "fwd", a))
    assert torch.equal(ctx.inv(a), _plain(ctx, "inv", a))
    assert torch.equal(back, a)
    ref = RefNttContext(n, moduli, engine="np64")
    np.testing.assert_array_equal(to_host(f), ref.fwd(to_host(a)))


@pytest.mark.gpu
def test_kernel_wrapper_checks_operands_on_cuda(cuda):
    n = 1024
    ctx = NttContext(n, gen_ntt_primes(30, 2, n), cuda)
    a = as_residues(_rand(ctx.moduli, n, seed=5), cuda)
    with pytest.raises(TypeError):
        nk.ntt_fwd(a.to(torch.int64), ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
    with pytest.raises(ValueError):
        nk.ntt_fwd(a.t().contiguous().t(), ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
    with pytest.raises(ValueError):
        nk.ntt_fwd(a[:1], ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
    flat = torch.zeros(2 * n + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        nk.ntt_fwd(flat[1:].reshape(2, n), ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,ctas", [
    (12, 8192, 8), (14, 8192, 8), (16, 8192, 8), (18, 8192, 8),
    (24, 8192, 4), (42, 8192, 4), (48, 8192, 2), (96, 8192, 1),
    (14, 16384, 8), (112, 16384, 1), (1, 1024, 1), (1, 2048, 2),
    (1, 32768, 8)])
def test_cluster_size_is_a_function_of_the_shape(cuda, rows, n, ctas):
    """The smallest power of two ≤ 8 that gives rows·C ≥ 96 CTAs, while a
    CTA keeps at least 1024 coefficients."""
    assert nk.cluster_size(rows, n) == ctas


@pytest.mark.gpu
@pytest.mark.parametrize("indices,batch", [(list(range(8)), 2),
                                           (list(range(10)), 4),
                                           ([0, 1, 2, 8, 9], 2),
                                           ([0, 1, 2], 3)])
def test_subset_views_run_the_kernels_on_cuda(cuda, indices, batch):
    """The CKKS shapes at n=32768: a leveled view's tables go to the kernels
    (no fallback) and give the plain version's words."""
    n = 32768
    parent = NttContext(n, gen_ntt_primes(30, 10, n), cuda)
    view = parent.subset(indices)
    rng = np.random.default_rng(5)
    x = as_residues(np.stack(
        [rng.integers(0, q, size=(batch, n)) for q in view.moduli],
        axis=1).astype(np.uint32), cuda)
    before = dict(nk.launches)
    f, i = view.fwd(x), view.inv(x)
    assert nk.launches == {"ntt_fwd": before["ntt_fwd"] + 1,
                           "ntt_inv": before["ntt_inv"] + 1}
    assert torch.equal(f, nk.fwd_ntt_plain(x, view.q, view.fwd_tw))
    assert torch.equal(i, nk.inv_ntt_plain(x, view.q, view.inv_tw,
                                           view.n_inv))
