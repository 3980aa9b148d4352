"""The mesh paths' two measured ops on the card, for this tree beside whole
other trees of the repository (an earlier commit's, from `git archive`).

    python -m abc_tpu_torch.scripts.mesh_ab [--baseline DIR ...]
                                            [--rounds R] [--out PATH]

The ops are chip_smoke.py phase 13's (c) and (d): the coefficient-sharded
CKKS multiply (DistCkksMultiplier, n=32768, levels=8, k=1, 8 shards of a
LocalComm mesh on one card) and the hamming program at n=8192 (8 + 1
primes, seed 17) on a dp=2 x limb=4 LocalComm mesh, batch 4, as one CUDA
graph through jit_compile_program. For each tree a process of its own
(PYTHONPATH the tree, so that its package and its kernels, built into its
own _build, are the ones measured) reads:
  * (c): ms per eager call between CUDA events (median of 10); the
    profiler's device ms and kernels per call (5 calls); the op captured as
    a graph: its kernel nodes (cudaGraphDebugDotPrint) and ms per replay
    (median of 10);
  * (d): ms per replay (median of 10) and the graph's kernel nodes.
The trees run in turns (the baselines, this tree, this tree, the baselines
in reverse), --rounds times. One JSON object per line; the last holds the
medians by tree.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TREE = os.path.dirname(os.path.dirname(HERE))


def _event_ms(fn, reps=10):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device(fn, reps=5):
    """(device ms, kernels) per call from torch.profiler (None, None where
    it saw no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA and
           "memcpy" not in ev.name.lower() and
           "memset" not in ev.name.lower() and
           not ev.name.startswith("chain::")]
    if not evs:
        return None, None
    return (sum(ev.device_time_total for ev in evs) / 1e3 / reps,
            len(evs) / reps)


def _kernel_nodes(g):
    """Kernel nodes of a graph captured with keep_graph=True."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.dot")
        g.debug_dump(path)
        with open(path) as f:
            return len(re.findall(r'label="\{KERNEL', f.read()))


def measure() -> dict:
    """The readings of the tree this process imports."""
    import numpy as np
    import torch
    from abc_tpu_torch import jit_compile_program
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.parallel import make_mesh
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu_torch.parallel.dryrun import HAMMING, build_context
    from abc_tpu_torch.parallel.mesh import coeff_mesh
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.utils.timing import graph_of

    dev = torch.device("cuda", 0)
    cctx = CkksContext(CkksParams.create(32768, levels=8, seed=23), dev)
    dmul = DistCkksMultiplier(cctx, coeff_mesh(8, device=dev))
    vals = np.linspace(0.1, 0.9, 64)
    ca, cb = (cctx.encrypt(cctx.encode(vals)) for _ in range(2))
    want = cctx.multiply(ca, cb, rescale=False).data
    if not torch.equal(dmul(ca.data, cb.data), want):
        raise AssertionError("DistCkksMultiplier != CkksContext.multiply")
    rec = {"c_eager_ms": _event_ms(lambda: dmul(ca.data, cb.data))}
    rec["c_device_ms"], rec["c_kernels_profiled"] = _device(
        lambda: dmul(ca.data, cb.data))
    g = graph_of(lambda x: dmul(x, cb.data), ca.data)
    g.replay()
    if not torch.equal(g.output, want):
        raise AssertionError("the sharded CKKS op's replay != its words")
    rec["c_graph_kernels"] = _kernel_nodes(g)
    rec["c_replay_ms"] = _event_ms(g.replay)
    del g

    ctx = build_context(8192, 8, seed=17, device=dev)
    rng = np.random.default_rng(3)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(4)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(4)]
    jp = jit_compile_program(
        HAMMING, f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", BfvCiphertextFactory(context=ctx),
        mesh=make_mesh(2, 4, device=dev), batch_values={"x": xs, "y": ys})
    got = [r[0] for r in jp.decrypt_outputs(jp.run_raw(jp.secret_inputs))
           ["out"]]
    if got != [sum(int(a != b) for a, b in zip(x, y))
               for x, y in zip(xs, ys)]:
        raise AssertionError(f"mesh hamming decrypts to {got}")
    rec["d_replay_ms"] = _event_ms(lambda: jp.run_raw(jp.secret_inputs))
    rec["d_graph_kernels"] = _kernel_nodes(jp._graph)
    return rec


def run_tree(tree: str) -> dict:
    """measure() in a process of its own that imports `tree`'s package."""
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--measure"], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"mesh_ab in {tree} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="abc_tpu_torch.scripts.mesh_ab")
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--measure", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("mesh_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    names = {os.path.abspath(d): os.path.basename(os.path.normpath(d))
             for d in args.baseline}
    names[TREE] = "this tree"
    order = [os.path.abspath(d) for d in args.baseline]
    order = order + [TREE, TREE] + order[::-1]
    readings = {name: [] for name in names.values()}
    lines = []
    for r in range(args.rounds):
        for tree in order:
            rec = {"round": r, "tree": names[tree], "card": smi,
                   **run_tree(tree)}
            readings[names[tree]].append(rec)
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    medians = {name: {k: statistics.median(
        rec[k] for rec in recs if rec[k] is not None)
        for k in recs[0] if k not in ("round", "tree", "card") and
        any(rec[k] is not None for rec in recs)}
        for name, recs in readings.items()}
    lines.append(json.dumps({"medians": medians, "card": smi}))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
