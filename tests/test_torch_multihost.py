"""The port across processes (abc_tpu_torch.parallel.multihost, DistComm over
gloo): the cases of tests/test_multihost.py with 2 and 4 spawned ranks
(2 "hosts" of 1 and of 2 ranks) on the CPU. Every rank writes the words it
computed; they are held here against the same computation on a LocalComm
mesh of the same shape and against abc_tpu's np64 single-device words of
the same seeds (np.testing.assert_array_equal; residues are canonical), for
both mesh layouts of the sharded BFV step, the compiled hamming program, the
limb-sharded key switch and rotation, the distributed NTT and the
coefficient-sharded CKKS multiply. Each launch has its own 120 s limit,
takes a free port, and raises with the worker's stderr when a rank fails.
"""

import numpy as np
import pytest
import torch

from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.parallel import multihost
from abc_tpu_torch.parallel.dryrun import build_context, make_multichip_step
from abc_tpu_torch.parallel.mesh import coeff_mesh
from abc_tpu_torch.parallel.sharding import (make_mesh, sharded_key_switch,
                                             sharded_rotate_rows)

N = 256
BFV_LIMBS = 2


def _ref_bfv(ctx):
    """abc_tpu's np64 context of a port context's parameters and seed."""
    from abc_tpu.crypto.bfv import BfvContext as RefContext
    from abc_tpu.crypto.params import BfvParams as RefParams
    p = ctx.params
    return RefContext(RefParams(n=p.n, coeff_modulus=p.coeff_modulus,
                                plain_modulus=p.plain_modulus,
                                engine="np64", seed=p.seed))


@pytest.fixture(scope="module", params=[1, 2], ids=["2ranks", "4ranks"])
def run(request, tmp_path_factory):
    local = request.param
    words_dir = tmp_path_factory.mktemp(f"w{local}")
    results = multihost.launch(nproc=2, local_devices=local, n=N,
                               tasks=multihost.TASKS, timeout_s=120,
                               bfv_limbs=BFV_LIMBS, device="cpu",
                               words_dir=str(words_dir))
    words = [dict(np.load(words_dir / f"rank{r}.npz"))
             for r in range(2 * local)]
    return local, results, words


def test_reports_of_every_rank(run):
    """Both BFV layouts, the compiled program and CKKS coefficient sharding
    run across the ranks and decrypt (the asserts fire in the workers)."""
    local, results, _ = run
    world = 2 * local
    assert [r["process_id"] for r in results] == list(range(world))
    for r in results:
        assert r["process_count"] == world and r["backend"] == "gloo"
        assert r["barrier"] == {"world": world, "mesh": world}
        bd = r["bfv_batch_over_dcn"]
        assert bd["mesh"] == {"dp": 2, "limb": local}
        # every ciphertext of the batch decrypted by exactly one host
        assert bd["ct_shards_checked_all_hosts"] == bd["batch"]
        assert "all-reduce" in bd["collectives"]
        ld = r["bfv_limb_over_dcn"]
        assert ld["mesh"] == {"dp": local, "limb": 2}
        # limb spans hosts: every host decrypts the whole batch
        assert ld["ct_shards_checked_all_hosts"] == ld["batch"] * 2
        assert "all-reduce" in ld["collectives"]
        cp = r["compiled_program"]
        assert cp["ct_shards_checked_all_hosts"] == cp["batch"]
        # each rank holds only its L/limb digit rows of every key
        assert set(cp["key_digit_rows_held"].values()) == {cp["L"] // local}
        assert "all-reduce" in cp["collectives"]
        ck = r["ckks_coeff_sharded"]
        assert ck["max_err"] < 0.05
        assert ck["collectives"]["collective-permute"]["ops"] > 0
        assert ck["collectives"]["all-gather"]["ops"] == 1
    for key in ("bfv_batch_over_dcn", "bfv_limb_over_dcn"):
        assert len({tuple(r[key]["shard_checksums"]) for r in results}) == 1


def test_bfv_layouts_word_equal(run):
    """Each rank's rows of the sharded step equal a LocalComm mesh of the
    same shape and abc_tpu's rotate_rows(a + b, 1) (np64)."""
    local, results, words = run
    for layout, (dp, limb) in (("batch_over_dcn", (2, local)),
                               ("limb_over_dcn", (local, 2))):
        B = 2 * dp
        ctx = build_context(n=N, data_limbs=limb * (-(-BFV_LIMBS // limb)),
                            seed=11, device="cpu")
        vals = [[(i + j + 1) % 7 + 1 for j in range(4)] for i in range(B)]
        enc = ctx.encrypt_many([ctx.encode(v) for v in vals] * 2)
        a = torch.stack([c.data for c in enc[:B]])
        b = torch.stack([c.data for c in enc[B:]])
        local_out = to_host(make_multichip_step(
            ctx, make_mesh(dp, limb, device="cpu"))(
                a, b, *ctx.get_galois_key(pow(3, 1, 2 * N))))
        ref = _ref_bfv(ctx)
        rcts = [ref.encrypt(ref.encode(v)) for v in vals + vals]
        ref_out = np.stack([np.asarray(ref.rotate_rows(
            ref.add(rcts[i], rcts[B + i]), 1).data) for i in range(B)])
        np.testing.assert_array_equal(local_out, ref_out)
        for w in words:
            rows = w[f"bfv_{layout}.rows"]
            np.testing.assert_array_equal(w[f"bfv_{layout}.out"],
                                          local_out[rows])


def test_compiled_program_word_equal(run):
    from abc_tpu_torch.parallel.dryrun import HAMMING
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program

    local, _, words = run
    rng = np.random.default_rng(7)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(4)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(4)]
    ctx = build_context(n=N, data_limbs=local * (-(-4 // local)), seed=33,
                        device="cpu")
    jp = jit_compile_program(
        HAMMING,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", BfvCiphertextFactory(context=ctx),
        mesh=make_mesh(2, local, device="cpu"),
        batch_values={"x": xs, "y": ys})
    local_out = to_host(jp.run_raw(jp.secret_inputs)["out"])
    for w in words:
        np.testing.assert_array_equal(
            w["compiled_program.out"],
            local_out[w["compiled_program.rows"]])


def test_keyswitch_and_rotation_word_equal(run):
    local, _, words = run
    ctx = build_context(n=N, data_limbs=local * (-(-BFV_LIMBS // local)),
                        seed=17, device="cpu")
    ct = ctx.encrypt(ctx.encode(list(range(16))))
    mesh = make_mesh(2, local, device="cpu")
    k0, k1 = sharded_key_switch(ctx, mesh, ct.data[1], ctx.get_relin_key())
    rot = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    ref = _ref_bfv(ctx)
    rct = ref.encrypt(ref.encode(list(range(16))))
    rk0, rk1 = ref._key_switch(np.asarray(rct.data)[1], ref.get_relin_key())
    np.testing.assert_array_equal(to_host(k0), np.asarray(rk0))
    np.testing.assert_array_equal(to_host(k1), np.asarray(rk1))
    np.testing.assert_array_equal(to_host(rot),
                                  np.asarray(ref.rotate_rows(rct, 3).data))
    for w in words:
        np.testing.assert_array_equal(w["keyswitch.k0"], to_host(k0))
        np.testing.assert_array_equal(w["keyswitch.k1"], to_host(k1))
        np.testing.assert_array_equal(w["keyswitch.rot"], to_host(rot))


def test_distributed_ntt_word_equal(run):
    from abc_tpu.crypto.ntt import NttContext as RefNtt
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext

    local, _, words = run
    D = 2 * local
    moduli = gen_ntt_primes(30, 3, N)
    dist = DistNttContext(NttContext(N, moduli, "cpu"), D)
    mesh = coeff_mesh(D, device="cpu")
    x, y = multihost.ntt_inputs(moduli, N, 0, "cpu")
    want = {"fwd": to_host(dist.make_fwd(mesh)(x)),
            "inv": to_host(dist.make_inv(mesh)(x)),
            "mul": to_host(dist.make_negacyclic_mul(mesh)(x, y))}
    ref = RefNtt(N, moduli, engine="np64")
    xh, yh = to_host(x), to_host(y)
    np.testing.assert_array_equal(want["fwd"], np.asarray(ref.fwd(xh)))
    np.testing.assert_array_equal(want["inv"], np.asarray(ref.inv(xh)))
    np.testing.assert_array_equal(want["mul"],
                                  np.asarray(ref.negacyclic_mul(xh, yh)))
    for w in words:
        for k, v in want.items():
            np.testing.assert_array_equal(w[f"ntt.{k}"], v)


def test_ckks_coefficient_sharded_word_equal(run):
    from abc_tpu.crypto.ckks import CkksContext as RefCtx
    from abc_tpu.crypto.ckks import CkksParams as RefParams
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier

    local, _, words = run
    ctx = CkksContext(CkksParams.create(N, levels=3, seed=13), "cpu")
    vals = np.linspace(0.1, 0.9, N // 2)
    a = ctx.encrypt(ctx.encode(vals))
    b = ctx.encrypt(ctx.encode(vals))
    want = to_host(DistCkksMultiplier(ctx, coeff_mesh(2 * local,
                                                      device="cpu"))(
        a.data, b.data))
    ref = RefCtx(RefParams.create(N, levels=3, engine="np64", seed=13))
    ra = ref.encrypt(ref.encode(vals))
    rb = ref.encrypt(ref.encode(vals))
    np.testing.assert_array_equal(
        want, np.asarray(ref.multiply(ra, rb, rescale=False).data))
    for w in words:
        np.testing.assert_array_equal(w["ckks_coeff_sharded.out"], want)


def test_a_failing_rank_raises_with_its_error():
    """A worker that dies is reported with its error, not waited for."""
    with pytest.raises(RuntimeError, match="power of two"):
        multihost.launch(nproc=1, local_devices=1, tasks=("ntt",), n=3,
                         timeout_s=60, device="cpu")


def test_more_ranks_than_cards_refuses_before_init(monkeypatch):
    import torch.distributed as dist
    from abc_tpu_torch.parallel.mesh import init_process_group_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        init_process_group_for("127.0.0.1:1", 2, 0, "cuda")
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        init_process_group_for("127.0.0.1:1", 4, 3, "cuda",
                               ranks_per_machine=2)
    with pytest.raises(ValueError, match="machines of 3"):
        init_process_group_for("127.0.0.1:1", 4, 0, "cuda",
                               ranks_per_machine=3)
    assert not dist.is_initialized()


def test_entry_points_default_to_the_card():
    import inspect
    from abc_tpu_torch.parallel.mesh import init_process_group_for
    for fn in (multihost.init_multihost, multihost.launch,
               init_process_group_for):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("rank", range(4))
def test_two_machines_of_two_cards_map_ranks_to_local_cards(monkeypatch,
                                                           rank):
    """A world of 4 over 2 machines of 2 cards: each machine needs only its
    own 2 cards, rank r takes card r % 2, and rank_device() (what the
    communicator, the barrier and the capture probe run on) names it."""
    import torch.distributed as dist
    from abc_tpu_torch.parallel import mesh as mesh_mod

    current = {}
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: current.update(card=i))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["card"])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    multihost.init_multihost("127.0.0.1:1", 4, rank, ranks_per_machine=2)
    assert current["card"] == rank % 2
    (backend,), kw = calls[0]
    assert backend == "nccl" and kw["world_size"] == 4 \
        and kw["rank"] == rank
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    assert mesh_mod.rank_device() == torch.device("cuda", rank % 2)
    comm = mesh_mod.DistComm()
    assert (comm.rank, comm.world) == (rank, 4)
    assert comm.device == torch.device("cuda", rank % 2)


@pytest.mark.gpu
def test_nccl_ranks_word_equal_to_local_comm(tmp_path):
    """One rank per card over NCCL (a world of 1 on one card): the sharded
    key switch and rotation at n=8192 with 8 data primes and the distributed
    NTT at n=8192 give the words of a LocalComm mesh on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext

    world = torch.cuda.device_count()
    results = multihost.launch(nproc=1, local_devices=world,
                               tasks=("keyswitch", "ntt"), device="cuda",
                               n_bfv=8192, bfv_limbs=8, n_ntt=8192,
                               ntt_limbs=4, timeout_s=120,
                               words_dir=str(tmp_path))
    assert results[0]["backend"] == "nccl"
    dev = torch.device("cuda")
    ctx = build_context(n=8192, data_limbs=8, seed=17, device=dev)
    ct = ctx.encrypt(ctx.encode(list(range(16))))
    mesh = make_mesh(2, 4, device=dev)
    k0, _ = sharded_key_switch(ctx, mesh, ct.data[1], ctx.get_relin_key())
    rot = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    moduli = gen_ntt_primes(30, 4, 8192)
    dist = DistNttContext(NttContext(8192, moduli, dev), 8)
    x, _ = multihost.ntt_inputs(moduli, 8192, 0, dev)
    fwd = dist.make_fwd(coeff_mesh(8, device=dev))(x)
    for r in range(world):
        w = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(w["keyswitch.k0"], to_host(k0))
        np.testing.assert_array_equal(w["keyswitch.rot"], to_host(rot))
        np.testing.assert_array_equal(w["ntt.fwd"], to_host(fwd))
