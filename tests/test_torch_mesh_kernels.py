"""abc_tpu_torch.ops.mesh_kernels (K8: the distributed NTT's exchange
combine and the modular psum over a shard axis) and the mesh paths that run
on them and on the port's other kernels (parallel/dist_ntt.py,
dist_ckks.py, mesh.py, dryrun.py):

* csrc/mesh.cu compiled for the host with g++ against the stub runtime of
  tests/host_cuda, every form held word-equal to its plain version: both
  directions, both sides of a pair, D ∈ {2, 4, 8} shards on one process
  and one shard of D ∈ {2, 4, 8} with the block it received, chunks
  of a shard's columns and whole shards, operands read and written at
  their strides, the folded n⁻¹, and the psum over 1-8 shards (every word
  q − 1 at D = 8) and of all-reduced int64 words;
* the CPU route of DistNttContext (fwd, inv, negacyclic_mul at D ∈ {1, 2,
  4, 8}), DistCkksMultiplier, sharded_key_switch and the dry run's step
  against abc_tpu's np64 contexts of the same seed, with no launch;
* the refusals, and on a CUDA device every form against its plain version.

Inputs are drawn with numpy from a seed (n ∈ {64, 256}), with 0 and q − 1
among them; residues are integers, so the tolerance is exact equality.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import behz_kernels as bk
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops import mesh_kernels as mk
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import as_residues, to_host
from abc_tpu_torch.parallel import make_mesh, sharded_key_switch
from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
from abc_tpu_torch.parallel.dist_ntt import DistNttContext
from abc_tpu_torch.parallel.dryrun import make_multichip_step
from abc_tpu_torch.parallel.mesh import coeff_mesh

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

HOST_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "host_cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(moduli, shape, seed, edge=None):
    """int32 residues of `shape` ([..., L, C]) over the L moduli, with 0 and
    q-1 among them, or all 0 (`edge` "zero") or all q-1 ("max")."""
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    if edge == "zero":
        x = np.zeros(shape, dtype=np.uint64)
    elif edge == "max":
        x = np.broadcast_to(q - 1, shape).copy()
    else:
        x = np.random.default_rng(seed).integers(0, q, size=shape,
                                                 dtype=np.uint64)
        x[..., 0] = 0
        x[..., 1::5] = q - 1
    return as_residues(x, "cpu")


def _dist(n, D, L=3):
    moduli = gen_ntt_primes(30, L, n)
    return DistNttContext(NttContext(n, moduli, "cpu"), D), moduli


def _launches():
    return {**mk.launches, **ew.launches, **kk.launches, **bk.launches,
            **nk.launches}


# ---------------------- the kernel source, compiled for the host (g++)

@pytest.fixture(scope="module")
def host_mesh(tmp_path_factory):
    """csrc/mesh.cu compiled by g++ against tests/host_cuda's stub runtime
    (a launch runs its blocks in turn, a std::thread per thread)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("mesh_host") / "libmesh_host.so"
    src = [s for s in _build.SOURCES if s.endswith("mesh.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}", src,
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_mesh(lib)
    return lib


def _host_combine(lib, x, tw, q, t_sh, forward, partner=None, d0=0, u=None,
                  out=None):
    """One call of the host build with the arguments the wrapper passes."""
    if out is not None:
        out.fill_(-1)
    res, args = mk.combine_args(x, *tw, q, t_sh, forward, partner, d0, u,
                                out)
    if out is None:
        res.fill_(-1)
    assert lib.abc_dist_ntt_combine(*args(res), None) == 0
    return res


def _host_psum(lib, x, q, out=None):
    res, args = mk.psum_args(x, q, out)
    res.fill_(-1)
    assert lib.abc_rns_psum_mod(*args(res), None) == 0
    return res


def _stages(dist, b, forward):
    """(stage, t_sh, (w, wsh), u) of every exchange stage of one direction,
    the inverse's stage 0 with n⁻¹ folded in."""
    for s in range(dist.logD):
        yield (s, dist.D >> (s + 1), (b["fwd"] if forward else b["inv"])[s],
               None if forward or s else b["n_inv"])


@pytest.mark.parametrize("edge", [None, "zero", "max"])
@pytest.mark.parametrize("n,D", [(64, 2), (64, 8), (256, 4), (256, 8)])
def test_local_combine_on_the_host(host_mesh, n, D, edge):
    """Every shard of the axis in one launch, the partner read in place at
    shard d ^ t_sh: both directions, every stage (the inverse's last with
    n⁻¹ folded), over a batch read at mesh.scatter's strides, a chunk of
    the shards' columns, and into an output view, equal to the plain
    chain."""
    dist, moduli = _dist(n, D)
    mesh = coeff_mesh(D, device="cpu")
    b = dist.bind(mesh)
    whole = _rand(moduli, (2, len(moduli), n), n + D, edge)
    x = mesh.scatter(whole, "coeff", dim=-1)          # [2, D, L, S], a view
    S = n // D
    for forward in (True, False):
        for s, t_sh, tw, u in _stages(dist, b, forward):
            want = mk.combine_plain(x, tw[0], dist.q_col, t_sh, forward,
                                    u=None if u is None else u[0])
            got = _host_combine(host_mesh, x, tw, dist.q_col, t_sh, forward,
                                u=u)
            assert torch.equal(got, want), (forward, s)
            if S >= 8:                                 # a chunk, in place
                c = x.chunk(2, dim=-1)[1]
                buf = torch.empty(x.shape, dtype=torch.int32)
                _host_combine(host_mesh, c, tw, dist.q_col, t_sh, forward,
                              u=u, out=buf.chunk(2, dim=-1)[1])
                assert torch.equal(buf[..., S // 2:], want[..., S // 2:]), \
                    (forward, s, "chunk")
            # the shard axis behind the rows in the output
            moved = torch.empty((D, 2) + tuple(x.shape[2:]),
                                dtype=torch.int32)
            _host_combine(host_mesh, x, tw, dist.q_col, t_sh, forward, u=u,
                          out=moved.movedim(0, 1))
            assert torch.equal(moved.movedim(0, 1), want), (forward, s)


@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_rank_combine_on_the_host(host_mesh, D, nc):
    """One shard at each position d0 of the axis with the block it
    received (a DistComm rank), whole or in chunks, both directions,
    equal to the plain chain. (One shard alone, D = 1, has no exchange
    stage: test_dist_ntt_route_matches_np64 holds that path.)"""
    n = 256
    dist, moduli = _dist(n, D)
    local = dist.bind(coeff_mesh(D, device="cpu"))
    L, S = len(moduli), n // D
    for d0 in range(D):
        x = _rand(moduli, (3, L, S), 100 + d0)
        p = _rand(moduli, (3, L, S), 200 + d0)
        for forward in (True, False):
            for s, t_sh, tw, u in _stages(dist, local, forward):
                rank_tw = tuple(t[d0] for t in tw)     # the rank's [L, 1]
                want = mk.combine_plain(x, rank_tw[0], dist.q_col, t_sh,
                                        forward, partner=p, d0=d0,
                                        u=None if u is None else u[0])
                res = torch.empty(x.shape, dtype=torch.int32)
                for c, pc, o in zip(x.chunk(nc, -1), p.chunk(nc, -1),
                                    res.chunk(nc, -1)):
                    _host_combine(host_mesh, c, rank_tw, dist.q_col, t_sh,
                                  forward, partner=pc.contiguous(), d0=d0,
                                  u=u, out=o)
                assert torch.equal(res, want), (d0, forward, s)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_psum_on_the_host(host_mesh, n, D):
    """Σ over 1-8 shards mod q: random residues, every word q - 1, a half
    of a key switch's accumulators read at its stride and written into a
    view of the summed halves; the int64 form on sums an all_reduce of
    the same shards makes."""
    moduli = gen_ntt_primes(30, 5, n)
    q = as_residues(np.asarray(moduli, np.uint32).reshape(-1, 1), "cpu")
    L = len(moduli)
    for edge in (None, "max", "zero"):
        x = _rand(moduli, (3, D, L, n), n + D, edge)
        want = mk.psum_plain(x, q)
        assert torch.equal(_host_psum(host_mesh, x, q), want), edge
        wide = x.to(torch.int64).sum(dim=-3)
        assert torch.equal(_host_psum(host_mesh, wide, q), want), edge
    acc = _rand(moduli, (2, D, 2, L, n), 7)           # [B, D, 2, L, n]
    summed = torch.empty((2, 2, L, n), dtype=torch.int32)
    for h in (0, 1):
        _host_psum(host_mesh, acc[..., h, :, :], q, out=summed[..., h, :, :])
    assert torch.equal(summed, torch.stack(
        [mk.psum_plain(acc[..., h, :, :], q) for h in (0, 1)], dim=-3))
    big = torch.from_numpy(np.random.default_rng(D).integers(
        0, 2 ** 62, size=(L, n), dtype=np.int64))
    assert torch.equal(_host_psum(host_mesh, big, q), mk.psum_plain(big, q))


def test_host_refusals(host_mesh):
    """Operands the kernels do not take are refused, by the wrapper's
    checks and by the entry points: shards of fewer than 4 coefficients
    (a DistNttContext admits S = 2: the CPU route takes it, the kernel
    refuses it), leading axes that do not collapse, a forward scaled on
    its u side, a partner of another shape, an output of another shape."""
    dist, moduli = _dist(64, 8)
    b = dist.bind(coeff_mesh(8, device="cpu"))
    x = coeff_mesh(8, device="cpu").scatter(
        _rand(moduli, (2, 3, 64), 1), "coeff", dim=-1)
    with pytest.raises(ValueError, match="power of two >= 4"):
        mk.combine_args(x[..., :2], *b["fwd"][0], dist.q_col, 4, True)
    crossed = _rand(moduli, (2, 2, 8, 3, 8), 2).transpose(0, 1)
    with pytest.raises(ValueError, match="one stride"):
        mk.combine_args(crossed, *b["fwd"][0], dist.q_col, 4, True)
    with pytest.raises(ValueError, match="only the inverse"):
        mk.combine_args(x, *b["fwd"][0], dist.q_col, 4, True,
                        u=b["n_inv"])
    with pytest.raises(ValueError, match="partner"):
        mk.combine_args(x[0, 0], *(t[0] for t in b["fwd"][0]), dist.q_col,
                        4, True, partner=x[0, 1, :2])
    with pytest.raises(ValueError, match="table w"):
        mk.combine_args(x, b["fwd"][0][0][:4], b["fwd"][0][1], dist.q_col,
                        4, True)
    with pytest.raises(ValueError, match="out"):
        mk.psum_args(x, dist.q_col, out=torch.empty(3, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two >= 4"):
        mk.psum_args(x[..., :2], dist.q_col)
    res, args = mk.combine_args(x, *b["fwd"][0], dist.q_col, 4, True)
    good = list(args(res))
    for at, bad in ((9, 3),         # pxor neither 0 nor t_sh
                    (24, 3),        # t_sh not a power of two
                    (21, 0)):       # no shard
        call = list(good)
        call[at] = bad
        assert host_mesh.abc_dist_ntt_combine(*call, None) != 0, at
    # the S = 2 route on the CPU: the words of one device's transform
    small, _ = _dist(16, 8)
    a = _rand(small.ctx.moduli, (3, 16), 3)
    mesh = coeff_mesh(8, device="cpu")
    assert torch.equal(small.make_fwd(mesh)(a), small.ctx.fwd(a))


def test_a_tensor_off_the_cpu_is_never_taken_by_the_plain_path():
    """Only a CPU tensor takes a plain version: any other device goes to the
    kernel's checks (here meta tensors, refused)."""
    dist, _ = _dist(64, 4)
    b = dist.bind(coeff_mesh(4, device="cpu"))
    x = torch.empty((2, 4, 3, 16), dtype=torch.int32, device="meta")
    q = torch.empty((3, 1), dtype=torch.int32, device="meta")
    for call in (lambda: mk.dist_ntt_combine(x, b["fwd"][0], q, 2, True),
                 lambda: mk.rns_psum_mod(x, q)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_launch_counters_name_every_kernel():
    assert set(mk.launches) == {"dist_ntt_combine", "rns_psum_mod"}


# ------------------------------- the CPU route of the mesh paths vs abc_tpu

@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_dist_ntt_route_matches_np64(D):
    """fwd, inv and negacyclic_mul over D shards equal abc_tpu's np64
    NttContext (one device) word for word, launching nothing."""
    from abc_tpu.crypto.ntt import NttContext as RefNtt
    n = 256
    dist, moduli = _dist(n, D)
    ref = RefNtt(n, moduli, engine="np64")
    mesh = coeff_mesh(D, device="cpu")
    a = _rand(moduli, (2, 3, n), 11)
    c = _rand(moduli, (2, 3, n), 12)
    before = _launches()
    got = (dist.make_fwd(mesh)(a), dist.make_inv(mesh)(a),
           dist.make_negacyclic_mul(mesh)(a, c))
    assert _launches() == before
    ha, hc = to_host(a), to_host(c)
    for g, w in zip(got, (ref.fwd(ha), ref.inv(ha),
                          ref.negacyclic_mul(ha, hc))):
        np.testing.assert_array_equal(to_host(g), np.asarray(w))


@pytest.mark.parametrize("D", [1, 2, 8])
def test_dist_ckks_route_matches_np64(D):
    """DistCkksMultiplier on D shards equals abc_tpu's np64
    CkksContext.multiply(rescale=False) of the same seed, launching
    nothing."""
    from abc_tpu.crypto.ckks import CkksContext as RefCtx
    from abc_tpu.crypto.ckks import CkksParams as RefParams
    n, levels = 128, 3
    ctx = CkksContext(CkksParams.create(n, levels=levels, seed=11), "cpu")
    dmul = DistCkksMultiplier(ctx, coeff_mesh(D, device="cpu"))
    ref = RefCtx(RefParams.create(n, levels=levels, engine="np64", seed=11))
    vals = np.linspace(-1.0, 1.0, n // 2)
    a, b = (ctx.encrypt(ctx.encode(v)) for v in (vals, vals[::-1].copy()))
    ra, rb = (ref.encrypt(ref.encode(v)) for v in (vals, vals[::-1].copy()))
    np.testing.assert_array_equal(to_host(a.data), np.asarray(ra.data))
    before = _launches()
    got = dmul(a.data, b.data)
    assert _launches() == before
    np.testing.assert_array_equal(
        to_host(got), np.asarray(ref.multiply(ra, rb, rescale=False).data))


def _bfv_pair(n=256, limbs=4, seed=11):
    """(port BfvContext on the CPU, abc_tpu np64 BfvContext): the dry run's
    parameters (parallel/dryrun.build_context) at n, `limbs` data primes."""
    from abc_tpu.crypto.bfv import BfvContext as RefBfv
    from abc_tpu.crypto.params import BfvParams as RefParams
    t = gen_ntt_primes(20, 1, n)[0]
    primes = gen_ntt_primes(30, limbs + 1, n, exclude=[t])
    return (BfvContext(BfvParams(n=n, coeff_modulus=primes, plain_modulus=t,
                                 engine="jx32", seed=seed), "cpu"),
            RefBfv(RefParams(n=n, coeff_modulus=primes, plain_modulus=t,
                             engine="np64", seed=seed)))


@pytest.mark.parametrize("dp,limb", [(1, 4), (2, 2)])
def test_sharded_key_switch_and_dry_run_step_match_np64(dp, limb):
    """sharded_key_switch (its psum the mesh kernel's plain route) and the
    dry run's step (its add the elementwise kernel's, its rotation
    limb-sharded) equal abc_tpu's np64 single-device words, launching
    nothing."""
    ctx, ref = _bfv_pair()
    mesh = make_mesh(dp=dp, limb=limb, device="cpu")
    cts = ctx.encrypt_many([ctx.encode([i + 1, 2 * i]) for i in range(4)])
    rcts = ref.encrypt_many([ref.encode([i + 1, 2 * i]) for i in range(4)])
    np.testing.assert_array_equal(to_host(cts[0].data),
                                  np.asarray(rcts[0].data))
    before = _launches()
    k0, k1 = sharded_key_switch(ctx, mesh, cts[0].data[1],
                                ctx.get_relin_key())
    a = torch.stack([c.data for c in cts[:2]])
    bb = torch.stack([c.data for c in cts[2:]])
    g = pow(3, 1, 2 * ctx.params.n)
    out = make_multichip_step(ctx, mesh)(a, bb, *ctx.get_galois_key(g))
    assert _launches() == before
    r0, r1 = ref._key_switch(np.asarray(rcts[0].data)[1],
                             ref.get_relin_key())
    np.testing.assert_array_equal(to_host(k0), np.asarray(r0))
    np.testing.assert_array_equal(to_host(k1), np.asarray(r1))
    rows = range(2)[mesh.local_slice("dp", 2)]
    for i, r in enumerate(rows):
        s = ref.add(rcts[r], rcts[2 + r])
        np.testing.assert_array_equal(
            to_host(out[i]), np.asarray(ref.rotate_rows(s, 1).data))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n,D,L", [(32768, 8, 8), (32768, 8, 9),
                                   (8192, 4, 8)])
def test_every_form_equals_plain_on_cuda(cuda, n, D, L):
    """The combine over every stage of both directions (all shards in one
    launch; one shard with a received block, in 2 chunks) and the psum in
    both forms on the card, each against its plain version."""
    moduli = gen_ntt_primes(30, L, n)
    dist = DistNttContext(NttContext(n, moduli, cuda), D)
    mesh = coeff_mesh(D, device=cuda)
    b = dist.bind(mesh)
    x = mesh.scatter(_rand(moduli, (2, L, n), 5).to(cuda), "coeff", dim=-1)
    for forward in (True, False):
        for s, t_sh, tw, u in _stages(dist, b, forward):
            before = mk.launches["dist_ntt_combine"]
            got = mk.dist_ntt_combine(x, tw, dist.q_col, t_sh, forward, u=u)
            assert mk.launches["dist_ntt_combine"] == before + 1
            want = mk.combine_plain(x.cpu(), tw[0].cpu(), dist.q_col.cpu(),
                                    t_sh, forward,
                                    u=None if u is None else u[0].cpu())
            assert torch.equal(got.cpu(), want), (forward, s)
            for d0 in (0, D - 1):
                rt = tuple(t[d0] for t in tw)
                part = x[:, d0 ^ t_sh].contiguous()
                res = torch.empty(x[:, d0].shape, dtype=torch.int32,
                                  device=cuda)
                for c, pc, o in zip(x[:, d0].chunk(2, -1),
                                    part.chunk(2, -1), res.chunk(2, -1)):
                    mk.dist_ntt_combine(c, rt, dist.q_col, t_sh, forward,
                                        partner=pc.contiguous(), d0=d0,
                                        u=u, out=o)
                assert torch.equal(res.cpu(), want[:, d0]), (forward, d0)
    q = dist.q_col
    for edge in (None, "max"):
        acc = _rand(moduli, (D, L, n // D), 3, edge).to(cuda)
        want = mk.psum_plain(acc.cpu(), q.cpu())
        assert torch.equal(mk.rns_psum_mod(acc, q).cpu(), want)
        wide = acc.to(torch.int64).sum(dim=-3)
        assert torch.equal(mk.rns_psum_mod(wide, q).cpu(), want)
