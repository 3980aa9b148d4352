"""Multi-process execution over torch.distributed (port of
abc_tpu/parallel/multihost.py).

The reference runs jax.distributed workers, each a "host" with
`local_devices` virtual chips, and spans one mesh over all of them. Here
every shard is a process (a rank of torch.distributed, parallel/mesh.py:
DistComm), and a reference host of `local_devices` chips becomes a group of
that many consecutive ranks: rank = host · local_devices + chip.

  * `init_multihost` — init_process_group for one rank from a `host:port`
    coordinator; the backend follows the device (NCCL on a card, by
    default, gloo on the CPU; more ranks on a machine than its CUDA
    devices raises).
  * The two mesh layouts of the BFV batched-rotation step
    (parallel/dryrun.py):
      - `batch-over-dcn`: dp = hosts (each host owns a batch shard; no
        traffic between hosts in the step), limb = the chips of a host
        (the key-switch psum inside a host).
      - `limb-over-dcn`: limb = hosts, so the key-switch psum crosses hosts.
  * CKKS coefficient sharding over every rank: the distributed NTT's
    exchanges cross the host boundary (parallel/dist_ntt.py).
  * A launcher (`python -m abc_tpu_torch.parallel.multihost launch --nproc
    N --local-devices C`) that spawns N·C worker processes on this machine,
    collects their JSON reports and prints a summary; `launch(...)` is the
    same from Python, with a choice of tasks: the reference's three, the
    limb-sharded key switch and the distributed NTT alone, `mesh_kernels`
    (the rank forms of the mesh kernels against their plain versions) and
    `capture_probe` (can an NCCL all_reduce be held by a CUDA graph?).
    Each rank reports the mesh kernels it launched (`launches`).

Every worker decrypts the output rows it holds, and a gather over the
process group cross-checks what all ranks saw. With `words_dir` each rank
also writes the words it computed (rank<r>.npz), so that a caller can hold
them against other runs.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

TASKS = ("layouts", "compiled", "ckks", "keyswitch", "ntt")


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device: str = "cuda",
                   ranks_per_machine: Optional[int] = None) -> None:
    """torch.distributed for one worker process (parallel.mesh.
    init_process_group_for): `coordinator_address` is `host:port`; on cuda
    a machine runs `ranks_per_machine` consecutive ranks, one per card
    (default: every rank on this machine)."""
    from abc_tpu_torch.parallel.mesh import init_process_group_for
    init_process_group_for(coordinator_address, num_processes, process_id,
                           device, ranks_per_machine)


def host_chip_mesh(layout: str = "batch-over-dcn", local_devices: int = 1):
    """A (dp × limb) mesh of every rank, hosts of `local_devices`
    consecutive ranks.

    batch-over-dcn: dp = hosts, limb = a host's chips (psum inside a host).
    limb-over-dcn:  dp = a host's chips, limb = hosts (psum across hosts).
    """
    from abc_tpu_torch.parallel.mesh import DistComm, Mesh
    comm = DistComm()
    grid = np.arange(comm.world).reshape(comm.world // local_devices,
                                         local_devices)
    if layout == "batch-over-dcn":
        return Mesh(grid, ("dp", "limb"), comm)
    if layout == "limb-over-dcn":
        return Mesh(grid.T, ("dp", "limb"), comm)
    raise ValueError(f"unknown layout {layout!r}")


def _gather_objects(obj) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _host_checked(rows: Sequence[int], local_devices: int) -> int:
    """Rows decrypted by all hosts together, each host counting the rows
    its ranks hold once (the reference's dedupe of a host's replicated
    shards)."""
    per_rank = _gather_objects(list(rows))
    hosts: Dict[int, set] = {}
    for r, got in enumerate(per_rank):
        hosts.setdefault(r // local_devices, set()).update(got)
    return sum(len(v) for v in hosts.values())


def _checksum(t: torch.Tensor) -> int:
    from abc_tpu_torch.ops.modarith import to_host
    return int(to_host(t).astype(np.uint64).sum() % (2 ** 31))


def run_multihost_bfv(layout: str, n: int = 256, data_limbs: int = None,
                      batch_per_dp: int = 2, local_devices: int = 1,
                      repeats: int = 3, verbose: bool = True):
    """The sharded BFV step (add + Galois rotation with sharded key switch)
    on a mesh of every rank; returns (report, this rank's output rows) and
    asserts the decryption of every row the rank holds."""
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.parallel.dryrun import (
        _ms_per_call, build_context, make_multichip_step,
    )
    from abc_tpu_torch.parallel.report import collective_report

    mesh = host_chip_mesh(layout, local_devices)
    dp, limb = mesh.shape["dp"], mesh.shape["limb"]
    if data_limbs is None:
        data_limbs = limb
    else:          # round up to a multiple of the limb mesh axis
        data_limbs = limb * (-(-data_limbs // limb))
    ctx = build_context(n=n, data_limbs=data_limbs, seed=11,
                        device=mesh.device)
    B = batch_per_dp * dp
    batch_vals = [[(i + j + 1) % 7 + 1 for j in range(4)] for i in range(B)]
    # deterministic on every rank (same seed) → the same ciphertexts
    enc = ctx.encrypt_many([ctx.encode(v) for v in batch_vals] * 2)
    a = torch.stack([c.data for c in enc[:B]])
    b = torch.stack([c.data for c in enc[B:]])
    kb, ka = ctx.get_galois_key(pow(3, 1, 2 * n))
    step = make_multichip_step(ctx, mesh)
    out = step(a, b, kb, ka)
    rows = list(range(B))[mesh.local_slice("dp", B)]
    for i, r in enumerate(rows):
        got = ctx.decode(ctx.decrypt(BfvCiphertext(out[i])))[:3]
        expected = [2 * v for v in batch_vals[r][1:4]]
        if got != expected:
            raise AssertionError(f"rank {mesh.comm.rank} row {r}: {got} != "
                                 f"{expected}")
    report = {
        "layout": layout, "nproc": mesh.size // local_devices,
        "mesh": {"dp": dp, "limb": limb},
        "n": n, "L": ctx.params.L, "batch": B,
        "step_ms": _ms_per_call(lambda: step(a, b, kb, ka), mesh.device,
                                reps=repeats),
        "timer": f"host clock, eager, {mesh.device.type}",
        "ct_shards_checked_this_rank": len(rows),
        "ct_shards_checked_all_hosts": _host_checked(rows, local_devices),
        "shard_checksums": _gather_objects(_checksum(out)),
        "collectives": collective_report(mesh, step, a, b, kb, ka),
    }
    if verbose and mesh.comm.rank == 0:
        print("multihost BFV OK:", json.dumps(report), flush=True)
    return report, {"out": out, "rows": np.asarray(rows)}


def run_multihost_compiled(n: int = 256, local_devices: int = 1,
                           verbose: bool = True):
    """The compiled hamming workload (full pipeline, runtime/jit_executor
    mesh mode) on a dp × limb mesh of every rank: dp = hosts (one batch
    shard per host, no bytes between hosts), limb = a host's ranks. Every
    rank compiles the same program with the same seeds, and decrypts the
    rows it holds against the oracle."""
    from abc_tpu_torch.parallel.dryrun import HAMMING, build_context
    from abc_tpu_torch.parallel.report import collective_report
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program

    mesh = host_chip_mesh("batch-over-dcn", local_devices)
    dp, limb = mesh.shape["dp"], mesh.shape["limb"]
    # ≥4 data limbs (multiple of the limb axis): the hamming circuit needs
    # ~60 noise bits + the 20-bit plaintext, beyond a 2-limb chain
    ctx = build_context(n=n, data_limbs=limb * (-(-4 // limb)), seed=33,
                        device=mesh.device)
    B = 2 * dp
    rng = np.random.default_rng(7)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    jp = jit_compile_program(
        HAMMING,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", BfvCiphertextFactory(context=ctx), mesh=mesh,
        batch_values={"x": xs, "y": ys})
    raw = jp.run_raw(jp.secret_inputs)
    oracle = [sum(int(a != b) for a, b in zip(x, y))
              for x, y in zip(xs, ys)]
    got = [row[0] for row in jp.decrypt_outputs(raw)["out"]]
    if got != [oracle[r] for r in jp.rows]:
        raise AssertionError(f"rank {mesh.comm.rank} rows {jp.rows}: {got} "
                             f"!= {oracle}")
    report = {
        "workload": "hamming via full pipeline (jit_compile_program mesh)",
        "nproc": mesh.size // local_devices, "mesh": {"dp": dp, "limb": limb},
        "n": n, "L": ctx.params.L, "batch": B,
        "ct_shards_checked_this_rank": len(jp.rows),
        "ct_shards_checked_all_hosts": _host_checked(jp.rows, local_devices),
        "key_digit_rows_held": {k: int(v[0].shape[0])
                                for k, v in ctx._keys.items()},
        "collectives": collective_report(mesh, jp.run_eager,
                                         jp.secret_inputs),
    }
    if verbose and mesh.comm.rank == 0:
        print("multihost COMPILED-PROGRAM OK:", json.dumps(report),
              flush=True)
    return report, {"out": raw["out"], "rows": np.asarray(jp.rows)}


def run_multihost_ckks(n: int = 256, levels: int = 3, verbose: bool = True):
    """CKKS multiply+relin with the coefficients sharded over EVERY rank:
    the distributed NTT's exchanges cross hosts. The product is gathered
    whole on every rank, which decrypts it."""
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu_torch.parallel.mesh import DistComm, coeff_mesh
    from abc_tpu_torch.parallel.report import collective_report

    mesh = coeff_mesh(comm=DistComm())
    params = CkksParams.create(n, levels=levels, seed=13)
    ctx = CkksContext(params, mesh.device)
    dist = DistCkksMultiplier(ctx, mesh)
    vals = np.linspace(0.1, 0.9, n // 2)
    ca = ctx.encrypt(ctx.encode(vals))
    cb = ctx.encrypt(ctx.encode(vals))
    prod = dist(ca.data, cb.data)
    ct = CkksCiphertext(prod, params.L, params.scale * params.scale)
    got = ctx.decode(ctx.decrypt(ct)).real[:n // 2]
    err = float(np.max(np.abs(got - vals * vals)))
    if not err < 0.05:
        raise AssertionError(f"coeff-shard mismatch across ranks: err={err}")
    report = {
        "nproc": mesh.size, "coeff_devices": mesh.size, "n": n,
        "L": params.L, "max_err": err,
        "collectives": collective_report(mesh, dist, ca.data, cb.data),
    }
    if verbose and mesh.comm.rank == 0:
        print("multihost CKKS OK:", json.dumps(report), flush=True)
    return report, {"out": prod}


def run_multihost_keyswitch(n: int = 256, data_limbs: int = 4,
                            local_devices: int = 1, seed: int = 17):
    """sharded_key_switch (relin key) and sharded_rotate_rows (3 steps) of
    one encryption on the batch-over-dcn mesh of every rank; every rank
    ends with the whole results."""
    from abc_tpu_torch.parallel.dryrun import build_context
    from abc_tpu_torch.parallel.report import collective_report
    from abc_tpu_torch.parallel.sharding import (sharded_key_switch,
                                                 sharded_rotate_rows)

    mesh = host_chip_mesh("batch-over-dcn", local_devices)
    limb = mesh.shape["limb"]
    ctx = build_context(n=n, data_limbs=limb * (-(-data_limbs // limb)),
                        seed=seed, device=mesh.device)
    ct = ctx.encrypt(ctx.encode(list(range(16))))
    ksk = ctx.get_relin_key()
    k0, k1 = sharded_key_switch(ctx, mesh, ct.data[1], ksk)
    rot = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    report = {"mesh": dict(mesh.shape), "n": n, "L": ctx.params.L,
              "collectives": collective_report(
                  mesh, sharded_key_switch, ctx, mesh, ct.data[1], ksk)}
    return report, {"k0": k0, "k1": k1, "rot": rot}


def run_multihost_ntt(n: int = 256, limbs: int = 3, seed: int = 0,
                      pipeline_chunks: int = 2):
    """The distributed NTT over every rank: fwd, inv and negacyclic_mul of
    seeded inputs ([limbs, n]), whole on every rank; inv(fwd(x)) == x."""
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext
    from abc_tpu_torch.parallel.mesh import DistComm, coeff_mesh
    from abc_tpu_torch.parallel.report import collective_report

    mesh = coeff_mesh(comm=DistComm())
    moduli = gen_ntt_primes(30, limbs, n)
    ctx = NttContext(n, moduli, mesh.device)
    dist = DistNttContext(ctx, mesh.size, pipeline_chunks=pipeline_chunks)
    x, y = ntt_inputs(moduli, n, seed, mesh.device)
    fwd, inv = dist.make_fwd(mesh), dist.make_inv(mesh)
    f = fwd(x)
    back = inv(f)
    if not torch.equal(back, x):
        raise AssertionError("distributed inv(fwd(x)) != x")
    mul = dist.make_negacyclic_mul(mesh)(x, y)
    report = {"D": mesh.size, "n": n, "L": limbs,
              "collectives": collective_report(mesh, fwd, x)}
    return report, {"fwd": f, "inv": inv(x), "mul": mul}


def run_mesh_kernels(n: int = 256, limbs: int = 3, D: int = 8,
                     seed: int = 0):
    """The DistComm forms of the mesh kernels on this rank's device, held
    against their plain versions at the shapes of a D-shard axis: the
    combine of one shard at each position d0 with a partner block (as a
    rank receives it), every stage of both directions (the inverse's last
    with n⁻¹), in 2 chunks; the psum's reduction of int64 sums of D
    shards' residues. Any world size: the partner comes from this rank's
    own seeded blocks. Returns (report, {})."""
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import mesh_kernels as mk
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext
    from abc_tpu_torch.parallel.mesh import coeff_mesh, rank_device

    dev = rank_device()
    moduli = gen_ntt_primes(30, limbs, n)
    dist = DistNttContext(NttContext(n, moduli, dev), D)
    b = dist.bind(coeff_mesh(D, device=dev))
    x, _ = ntt_inputs(moduli, n, seed, dev)
    blocks = x.reshape(limbs, D, n // D).movedim(1, 0)      # [D, L, S]
    q, qh = dist.q_col, dist.q_col.cpu()
    checked = 0
    for forward in (True, False):
        for s in range(dist.logD):
            t_sh = D >> (s + 1)
            tw = (b["fwd"] if forward else b["inv"])[s]
            u = None if forward or s else b["n_inv"]
            for d0 in range(D):
                xs, ps = blocks[d0], blocks[d0 ^ t_sh].contiguous()
                rt = tuple(t[d0] for t in tw)
                got = torch.empty(xs.shape, dtype=torch.int32, device=dev)
                for c, pc, o in zip(xs.chunk(2, -1), ps.chunk(2, -1),
                                    got.chunk(2, -1)):
                    mk.dist_ntt_combine(c, rt, q, t_sh, forward,
                                        partner=pc.contiguous(), d0=d0, u=u,
                                        out=o)
                want = mk.combine_plain(
                    xs.cpu(), rt[0].cpu(), qh, t_sh, forward,
                    partner=ps.cpu(), d0=d0,
                    u=None if u is None else u[0].cpu())
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"dist_ntt_combine (rank form) != "
                                         f"plain at stage {s}, shard {d0}, "
                                         f"forward={forward}")
                checked += 1
    wide = blocks.to(torch.int64).sum(dim=0)
    if not torch.equal(mk.rns_psum_mod(wide, q, ratio=dist.ctx.ratio).cpu(),
                       mk.psum_plain(blocks.cpu(), qh)):
        raise AssertionError("rns_psum_mod (rank form) != plain")
    return {"n": n, "L": limbs, "D": D, "combines_checked": checked,
            "psum_checked": 1}, {}


def capture_probe() -> Dict:
    """Whether this rank's collectives can be held by a CUDA graph: an int64
    all_reduce over the world captured with torch.cuda.graph, then replayed
    on fresh contents. Returns what happened (the error text where capture
    or replay refused); JittedProgram runs a DistComm rank eagerly either
    way."""
    import torch.distributed as dist
    from abc_tpu_torch.parallel.mesh import rank_device
    from abc_tpu_torch.utils.timing import capture_graph
    if dist.get_backend() != "nccl":
        return {"captured": None, "reason": "a gloo group: CPU tensors, "
                                            "no CUDA graph"}
    dev = rank_device()
    x = torch.ones(4096, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dist.all_reduce(x)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph()
    try:
        with capture_graph(g):
            dist.all_reduce(x)
        x.fill_(3)
        g.replay()
        torch.cuda.synchronize(dev)
    except RuntimeError as exc:
        return {"captured": False, "error": str(exc)[:400]}
    want = 3 * dist.get_world_size()
    return {"captured": True, "replay_sum_right": bool((x == want).all()),
            "world": dist.get_world_size()}


def ntt_inputs(moduli, n: int, seed: int, device):
    """Two [L, n] residue arrays from a numpy generator (every rank and
    every caller makes the same)."""
    from abc_tpu_torch.ops.modarith import as_residues
    rng = np.random.default_rng(seed)
    hi = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    return tuple(as_residues(rng.integers(0, hi, size=(len(moduli), n),
                                          dtype=np.uint64), device)
                 for _ in range(2))


# --------------------------------------------------------------------------
# worker / launcher CLI

def _worker_main(args) -> None:
    import torch.distributed as dist
    from abc_tpu_torch.ops.modarith import to_host

    torch.set_num_threads(1)
    init_multihost(args.coordinator, args.world, args.rank, args.device,
                   args.ranks_per_machine or args.local_devices)
    try:
        out = {"process_id": args.rank, "process_count": dist.get_world_size(),
               "global_devices": dist.get_world_size(),
               "backend": dist.get_backend()}
        words: Dict[str, np.ndarray] = {}

        def keep(name, rep_words):
            rep, w = rep_words
            out[name] = rep
            for k, v in w.items():
                words[f"{name}.{k}"] = (to_host(v) if isinstance(
                    v, torch.Tensor) else np.asarray(v))

        from abc_tpu_torch.parallel.failure import barrier
        out["barrier"] = {"world": barrier(60.0), "mesh": barrier(
            60.0, mesh=host_chip_mesh("batch-over-dcn", args.local_devices))}
        tasks = args.tasks.split(",")
        n_bfv = args.n_bfv or args.n
        limbs = args.bfv_limbs or None
        if "layouts" in tasks:
            for layout in ("batch-over-dcn", "limb-over-dcn"):
                keep("bfv_" + layout.replace("-", "_"), run_multihost_bfv(
                    layout, n=n_bfv, data_limbs=limbs,
                    local_devices=args.local_devices, verbose=False))
        if "compiled" in tasks:
            keep("compiled_program", run_multihost_compiled(
                n=min(n_bfv, 512), local_devices=args.local_devices,
                verbose=False))
        if "ckks" in tasks:
            keep("ckks_coeff_sharded", run_multihost_ckks(
                n=args.n_ckks or args.n, levels=args.levels, verbose=False))
        if "keyswitch" in tasks:
            keep("keyswitch", run_multihost_keyswitch(
                n=n_bfv, data_limbs=args.bfv_limbs or 4,
                local_devices=args.local_devices))
        if "ntt" in tasks:
            keep("ntt", run_multihost_ntt(n=args.n_ntt or args.n,
                                          limbs=args.ntt_limbs))
        if "mesh_kernels" in tasks:
            keep("mesh_kernels", run_mesh_kernels(
                n=args.n_ntt or args.n, limbs=args.ntt_limbs))
        # the mesh kernels this rank launched (its counts stay in its own
        # process)
        from abc_tpu_torch.ops import mesh_kernels as mk
        out["launches"] = dict(mk.launches)
        if args.words_dir:
            np.savez(os.path.join(args.words_dir, f"rank{args.rank}.npz"),
                     **words)
        if "capture_probe" in tasks:
            out["nccl_capture"] = capture_probe()
            print("MHRESULT " + json.dumps(out), flush=True)
            # a refused capture can leave the communicator unusable, so
            # the probe's process ends here, without a teardown collective
            os._exit(0)
        print("MHRESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, local_devices: int = 1, n: int = 256,
           tasks: Sequence[str] = ("layouts", "compiled", "ckks"),
           timeout_s: float = 900, n_bfv: int = 0, n_ckks: int = 0,
           bfv_limbs: int = 0, levels: int = 3, n_ntt: int = 0,
           ntt_limbs: int = 3, device: str = "cuda",
           words_dir: Optional[str] = None) -> List[Dict]:
    """Spawn nproc · local_devices worker processes (ranks) on this machine,
    one per "chip" of nproc "hosts", and collect their reports, sorted by
    rank. On cuda every rank takes a card of this machine: more ranks than
    cards fails in the workers' init. A worker that fails or outlives
    `timeout_s` raises here, and every worker still running is killed."""
    world = nproc * local_devices
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "abc_tpu_torch.parallel.multihost",
               "worker", "--coordinator", coordinator, "--world", str(world),
               "--rank", str(rank), "--local-devices", str(local_devices),
               "--ranks-per-machine", str(world),
               "--n", str(n), "--n-bfv", str(n_bfv), "--n-ckks", str(n_ckks),
               "--bfv-limbs", str(bfv_limbs), "--levels", str(levels),
               "--n-ntt", str(n_ntt), "--ntt-limbs", str(ntt_limbs),
               "--device", device, "--tasks", ",".join(tasks)]
        if words_dir:
            cmd += ["--words-dir", words_dir]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env))
    results = []
    deadline = time.time() + timeout_s
    try:
        for rank, p in enumerate(procs):
            remaining = max(1.0, deadline - time.time())
            try:
                stdout, stderr = p.communicate(timeout=remaining)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"multihost worker {rank} of {world} outlived "
                    f"{timeout_s} s") from None
            if p.returncode != 0:
                raise RuntimeError(
                    f"multihost worker {rank} of {world} failed "
                    f"(rc={p.returncode}):\n{stderr[-3000:]}")
            for line in stdout.splitlines():
                if line.startswith("MHRESULT "):
                    results.append(json.loads(line[len("MHRESULT "):]))
    finally:
        for q in procs:          # kill exactly the processes started here
            if q.poll() is None:
                q.kill()
                q.wait()
    results.sort(key=lambda r: r["process_id"])
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="abc_tpu_torch.parallel.multihost")
    sub = ap.add_subparsers(dest="cmd")
    w = sub.add_parser("worker")
    w.add_argument("--coordinator", required=True)
    w.add_argument("--world", type=int, required=True)
    w.add_argument("--rank", type=int, required=True)
    w.add_argument("--ranks-per-machine", type=int, default=0,
                   help="ranks on this machine, one per card (default: "
                        "--local-devices, a host per machine)")
    ln = sub.add_parser("launch")
    ln.add_argument("--nproc", type=int, default=2)
    ln.add_argument("--production", action="store_true",
                    help="BASELINE production shapes: BFV n=8192 L=8 "
                         "dp x limb, CKKS n=32768 L=8 coeff-sharded")
    ln.add_argument("--no-ckks", action="store_true")
    for p in (w, ln):
        p.add_argument("--local-devices", type=int, default=1)
        p.add_argument("--n", type=int, default=256)
        p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    w.add_argument("--n-bfv", type=int, default=0)
    w.add_argument("--n-ckks", type=int, default=0)
    w.add_argument("--bfv-limbs", type=int, default=0)
    w.add_argument("--levels", type=int, default=3)
    w.add_argument("--n-ntt", type=int, default=0)
    w.add_argument("--ntt-limbs", type=int, default=3)
    w.add_argument("--tasks", default=",".join(TASKS[:3]))
    w.add_argument("--words-dir", default="")
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        _worker_main(args)
        return
    if args.cmd != "launch":
        ap.error("give a command: launch or worker")
    kw = {}
    if args.production:
        kw = dict(n_bfv=8192, bfv_limbs=8, n_ckks=32768, levels=8,
                  timeout_s=3600)
    tasks = ("layouts", "compiled") if args.no_ckks else TASKS[:3]
    results = launch(args.nproc, args.local_devices, args.n, tasks=tasks,
                     device=args.device, **kw)
    print(json.dumps({"nproc": args.nproc, "ok": True,
                      "process0": results[0]}, indent=2))


if __name__ == "__main__":
    main()
