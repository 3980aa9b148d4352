"""The multi-shard "full step" of entry.dryrun_multichip and the sharding
tests (port of abc_tpu/parallel/dryrun.py): a batched encrypted computation
over a 2-D (dp × limb) mesh.

Per batched ciphertext pair: ct_sum = a ⊞ b, then rotate_rows(ct_sum, 1)
with the key-switch decomposition contraction sharded over "limb" (a
modular psum) while the batch is sharded over "dp". This exercises both
mesh axes with real collectives in one step.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops.modarith import t64
from abc_tpu_torch.parallel.mesh import Mesh, coeff_mesh
from abc_tpu_torch.parallel.report import collective_report
from abc_tpu_torch.parallel.sharding import make_mesh
from abc_tpu_torch.utils.timing import capture_graph

HAMMING = ("int sum = 0;"
           "for (int i = 0; i < n; i = i + 1) {"
           "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
           "}"
           "return sum;")


def build_context(n: int, data_limbs: int, seed: int = 11,
                  device="cuda") -> BfvContext:
    """BFV context with an explicit number of data limbs (so the limb mesh
    axis divides L evenly)."""
    t = gen_ntt_primes(20, 1, n)[0]
    primes = gen_ntt_primes(30, data_limbs + 1, n, exclude=[t])
    return BfvContext(BfvParams(n=n, coeff_modulus=primes, plain_modulus=t,
                                engine="jx32", seed=seed), device)


def make_multichip_step(ctx: BfvContext, mesh: Mesh, steps: int = 1
                        ) -> Callable:
    """Returns step(batch_a, batch_b, ksk_b, ksk_a) → batch_out.

    batch_*: [B, 2, L, n] whole batches (each process takes its dp rows)
    ksk_*:   [L, L+1, n] whole keys (each process reads its limb rows)
    batch_out: this process's dp rows of the result, [rows, 2, L, n].
    The rotation is the context's own hoisted one (decompose the untouched
    c1, permute the decomposition in the NTT domain) in its limb mode.
    Everything the step reads from the host is made here, so the step can
    be captured in a CUDA graph on a LocalComm mesh."""
    n = ctx.params.n
    if ctx.params.L % mesh.shape["limb"]:
        raise ValueError("limb mesh axis must divide L")
    g = pow(3, steps % (n // 2), 2 * n)
    # the rotation's device tables, cached on the context for good
    ctx._galois_perm(g)
    ctx._galois_perm_eval(g)

    def step(a, b, kb, ka):
        rows = mesh.local_slice("dp", a.shape[0])
        s = t64.add(a[rows], b[rows], ctx.q_q)
        with ctx.limb_sharded(mesh):
            return ctx._rotate_with(BfvCiphertext(s),
                                    ctx._decompose_ntt(s[:, 1]), g,
                                    (kb, ka)).data

    return step


def _dp_limb(n_devices: int):
    dp = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    return dp, n_devices // dp


def _ms_per_call(fn: Callable, device, reps: int = 5) -> float:
    """Host-clock ms of one call, the device drained around each (median of
    reps; the first call is not timed)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _event_ms(fn: Callable, device, reps: int = 10) -> float:
    """ms of one call of fn between CUDA events (median of reps)."""
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _graph_of(fn: Callable, device) -> "torch.cuda.CUDAGraph":
    """fn captured as one CUDA graph after an eager warm-up on a side
    stream; fn reads only tensors that outlive the graph."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with capture_graph(g):
        fn()
    return g


def _timing(fn: Callable, mesh: Mesh, replays: bool = False) -> Dict:
    """step ms of fn on this mesh's device: on a LocalComm CUDA mesh per
    replay of fn captured as one graph (or of fn itself when it already is
    a replay, `replays`), else per eager call on the host clock."""
    if mesh.device.type == "cuda" and mesh.is_local:
        if not replays:
            fn = _graph_of(fn, mesh.device).replay
        return {"step_ms": _event_ms(fn, mesh.device),
                "timer": "CUDA graph replay between CUDA events, median of "
                         "10"}
    return {"step_ms": _ms_per_call(fn, mesh.device),
            "timer": f"host clock, eager, {mesh.device.type}, median of 5"}


def _bfv_phase(ctx: BfvContext, mesh: Mesh, batch_vals) -> Dict:
    """The step on encryptions of batch_vals and of themselves; decrypt
    checks rotate(2·v, 1) on this process's rows."""
    n = ctx.params.n
    enc = ctx.encrypt_many([ctx.encode(v) for v in batch_vals] * 2)
    B = len(batch_vals)
    a = torch.stack([c.data for c in enc[:B]])
    b = torch.stack([c.data for c in enc[B:]])
    ksk_b, ksk_a = ctx.get_galois_key(pow(3, 1, 2 * n))
    step = make_multichip_step(ctx, mesh, steps=1)
    out = step(a, b, ksk_b, ksk_a)
    rows = range(B)[mesh.local_slice("dp", B)]
    for i, r in zip(range(out.shape[0]), rows):
        got = ctx.decode(ctx.decrypt(BfvCiphertext(out[i])))[:3]
        expected = [2 * v for v in batch_vals[r][1:4]]
        if got != expected:
            raise AssertionError(f"dryrun BFV row {r}: {got} != {expected}")
    coll = collective_report(mesh, step, a, b, ksk_b, ksk_a)
    rec = {"n": n, "L": ctx.params.L, "mesh": dict(mesh.shape), "batch": B,
           "collectives_per_step": coll,
           "axis_attribution": "all-reduce = key-switch psum over 'limb'; "
                               "'dp' moves zero bytes"}
    rec.update(_timing(lambda: step(a, b, ksk_b, ksk_a), mesh))
    return rec, out


def _program_phase(ctx: BfvContext, mesh: Mesh, seed: int) -> Dict:
    """The hamming DSL workload through the full pipeline (parse → passes
    → vectorize → whole-program capture) on the dp × limb mesh, a batch of
    input pairs over dp, every key switch limb-sharded; decrypt-checked
    against the oracle."""
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program

    rng = np.random.default_rng(seed)
    B = 2 * mesh.shape["dp"]
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    jp = jit_compile_program(
        HAMMING,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", BfvCiphertextFactory(context=ctx), mesh=mesh,
        batch_values={"x": xs, "y": ys})
    raw = jp.run_raw(jp.secret_inputs)
    got = [row[0] for row in jp.decrypt_outputs(raw)["out"]]
    oracle = [sum(int(a != b) for a, b in zip(x, y))
              for x, y in zip(xs, ys)]
    if got != [oracle[r] for r in jp.rows]:
        raise AssertionError(f"compiled-program dryrun: {got} != {oracle}")
    rec = {"workload": "hamming (full pipeline: parse->passes->vectorize->"
                       "whole-program capture)",
           "n": ctx.params.n, "mesh": dict(mesh.shape), "batch": B,
           "decrypted": got, "limb_sharded": jp._limb_ok,
           "collectives_per_step": collective_report(
               mesh, jp.run_eager, jp.secret_inputs)}
    rec.update(_timing(lambda: jp.run_raw(jp.secret_inputs), mesh,
                       replays=True))
    return rec


def _ckks_phase(n: int, levels: int, seed: int, mesh: Mesh,
                vals: np.ndarray) -> Dict:
    """CKKS multiply+relin with the coefficients sharded over every shard
    of `mesh` (a ("coeff",) mesh): distributed-NTT exchanges."""
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier

    cctx = CkksContext(CkksParams.create(n, levels=levels, seed=seed),
                       mesh.device)
    dist = DistCkksMultiplier(cctx, mesh)
    ca = cctx.encrypt(cctx.encode(vals))
    cb = cctx.encrypt(cctx.encode(vals))
    prod = dist(ca.data, cb.data)
    ct = CkksCiphertext(prod, ca.level, ca.scale * cb.scale)
    got = cctx.decode(cctx.decrypt(ct)).real[:len(vals)]
    err = float(np.max(np.abs(got - vals * vals)))
    if not err < 0.05:
        raise AssertionError(f"coefficient-sharded CKKS: max err {err}")
    rec = {"n": n, "L": cctx.params.L, "coeff_shards": mesh.shape["coeff"],
           "max_err": err,
           "collectives_per_step": collective_report(mesh, dist, ca.data,
                                                     cb.data),
           "axis_attribution": "collective-permute = distributed-NTT "
                               "butterfly exchanges over 'coeff'"}
    rec.update(_timing(lambda: dist(ca.data, cb.data), mesh))
    return rec


def run_production_dryrun(n_devices: int, device="cuda",
                          verbose: bool = True) -> dict:
    """Production-shape dryrun (BASELINE configs 2/5 sizes) on n_devices
    shards of one device:

      * BFV n=8192 batched rotate step on the dp × limb mesh — the
        key-switch decomposition contraction psums over "limb";
      * the hamming program at n=8192 through jit_compile_program on it;
      * CKKS n=32768 (BASELINE config 5) multiply+relin with coefficients
        sharded over all n_devices shards — distributed-NTT exchanges.

    Returns (and prints) per-phase step times and collective censuses."""
    dp, limb = _dp_limb(n_devices)
    mesh = make_mesh(dp=dp, limb=limb, device=device)
    n = 8192
    # smallest multiple of the limb axis ≥ the n=8192 preset's 6 data limbs
    ctx = build_context(n=n, data_limbs=limb * (-(-6 // limb)), seed=17,
                        device=device)
    ctx.ensure_eval_ready()
    bfv, _ = _bfv_phase(ctx, mesh, [[j + 2 for j in range(4)]
                                    for _ in range(2 * dp)])
    prog = _program_phase(ctx, mesh, seed=9)
    ckks = _ckks_phase(32768, 8, 23, coeff_mesh(n_devices, device=device),
                       np.linspace(0.1, 0.9, 64))
    report = {"bfv": bfv, "compiled_program": prog, "ckks": ckks}
    if verbose:
        print("dryrun production shapes OK: " + json.dumps(report),
              flush=True)
    return report


def run_dryrun(n_devices: int, n: int = 1024, device="cuda",
               verbose: bool = True, production: bool = True) -> dict:
    """Build an n_devices mesh on one device, run the full sharded step, the
    compiled hamming program and the coefficient-sharded CKKS multiply at
    small shapes, each checked after decryption; then, unless
    production=False, run_production_dryrun. On a CUDA device the NTT
    kernels need n ≥ 1024, and the CKKS ring is raised to 1024 coefficients
    per shard."""
    dp, limb = _dp_limb(n_devices)
    mesh = make_mesh(dp=dp, limb=limb, device=device)
    ctx = build_context(n=n, data_limbs=limb, device=device)
    bfv, _ = _bfv_phase(ctx, mesh, [[j + 1 for j in range(4)]
                                    for _ in range(2 * dp)])
    if verbose:
        print(f"dryrun_multichip OK: mesh dp={dp} x limb={limb}, n={n}, "
              f"L={ctx.params.L}, batch={2 * dp}", flush=True)
    # the compiled hamming program needs more than `limb` limbs of noise
    # room: 4 or more, a multiple of the limb axis
    ctx_prog = build_context(n=n, data_limbs=limb * (-(-4 // limb)),
                             seed=31, device=device)
    prog = _program_phase(ctx_prog, mesh, seed=5)
    if verbose:
        print(f"dryrun compiled-program OK: {json.dumps(prog)}", flush=True)
    n_c = max(n, 1024 * n_devices) if torch.device(device).type == "cuda" \
        else n
    ckks = _ckks_phase(n_c, 3, 13, coeff_mesh(n_devices, device=device),
                       np.linspace(0.1, 0.9, n_c // 2))
    if verbose:
        print(f"dryrun coeff-sharded CKKS OK: {json.dumps(ckks)}",
              flush=True)
    report = {"bfv": bfv, "compiled_program": prog, "ckks": ckks}
    if production:
        report["production"] = run_production_dryrun(n_devices, device,
                                                     verbose)
    return report
