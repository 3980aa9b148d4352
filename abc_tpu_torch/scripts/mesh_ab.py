"""The mesh kernels (K8: dist_ntt_combine and rns_psum_mod of
csrc/mesh.cu) and the mesh paths' two measured ops on the card, for this
tree beside other builds of the file and whole other trees of the
repository (an earlier commit's, from `git archive`).

    python -m abc_tpu_torch.scripts.mesh_ab [--baseline DIR ...]
        [--kernel-rounds K] [--rounds R] [--out PATH]

Kernel level. At every form of chip_smoke.py's k8_calls (phase 13's
shapes: the LocalComm combine of the distributed NTT (b), of the CKKS
op's digits (c) and of its accumulators' last inverse stage with n^-1
folded, a rank's combine on either side, the psum of a key switch's half
(a) and of D = 1, 2, 4 and 8 blocks, the rank form of the psum) this
tree's kernels run beside the mesh.cu of each --baseline DIR: a tree's
DIR/abc_tpu_torch/csrc/mesh.cu, or DIR/mesh.cu of a directory that holds
another mesh.cu and the headers it includes (a copy of this one with a
constant changed, such as kCombinePairs). Each is built as the package
builds csrc/ (behz_ab.build_baseline) and named by its directory. A build
without abc_mesh_plan is one from before the psum's rank form took q's
ratio words: its entry points are bound and called by their own
signatures. Every build's words must equal the plain versions' on random
and on all-(q-1) inputs; then the profiler's device time of each build,
warm and cold, is read in turns (ks_ab.in_turns: the builds in order,
then in reverse), --kernel-rounds times, two readings a round, with
torch.remainder(wide, q) in the same turns beside the psum's rank form.
Each launch's plan (this tree's: mesh_kernels.launch_info) and the
compiler's census of every build's mesh kernels are printed.

Op level: chip_smoke.py phase 13's (c) and (d), for this tree and each
DIR that holds a tree: the coefficient-sharded CKKS multiply
(DistCkksMultiplier, n=32768, levels=8, k=1, 8 shards of a LocalComm mesh
on one card) and the hamming program at n=8192 (8 + 1 primes, seed 17) on
a dp=2 x limb=4 LocalComm mesh, batch 4, as one CUDA graph through
jit_compile_program. For each tree a process of its own (PYTHONPATH the
tree, so that its package and its kernels, built into its own _build, are
the ones measured) reads:
  * (c): ms per eager call between CUDA events (median of 10); the
    profiler's device ms and kernels per call (5 calls); the op captured as
    a graph: its kernel nodes (cudaGraphDebugDotPrint) and ms per replay
    (median of 10);
  * (d): ms per replay (median of 10), the profiler's device ms and
    kernels per replay (5 replays, run_raw's copies in and out among
    them), and the graph's kernel nodes.
The trees run in turns (the baselines, this tree, this tree, the baselines
in reverse), --rounds times. One JSON object per line; the last holds the
medians (the kernel level's by form, the op level's by tree).

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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
    rec["d_device_ms"], rec["d_kernels_profiled"] = _device(
        lambda: jp.run_raw(jp.secret_inputs))
    rec["d_graph_kernels"] = _kernel_nodes(jp._graph)
    return rec


# ------------------------------------------------------------ kernel level

def bind(lib) -> bool:
    """Binds a build's two entry points; whether it is one with
    abc_mesh_plan, whose psum's rank form takes q's ratio words."""
    if hasattr(lib, "abc_mesh_plan"):
        from abc_tpu_torch.ops import _build
        _build.bind_mesh(lib)
        return True
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    view = [vp] + [i64] * 3
    lib.abc_dist_ntt_combine.argtypes = [i32] + view * 2 + [i32] + view + \
        [vp, vp, i64] + [vp] * 3 + [i64] + [i32] * 5 + [vp]
    lib.abc_rns_psum_mod.argtypes = [i32] + view + [vp, i64, i64, vp, i64] + \
        [i32] * 3 + [vp]
    lib.abc_dist_ntt_combine.restype = lib.abc_rns_psum_mod.restype = i32
    return False


def kernel_dir(directory: str) -> str:
    """Where a --baseline DIR holds its mesh.cu: a tree's csrc/, else DIR."""
    csrc = os.path.join(directory, "abc_tpu_torch", "csrc")
    return csrc if os.path.isdir(csrc) else directory


def launcher(lib, new, operands, stream):
    """(launch() -> return code, the tensor it writes) of one build on one
    k8_calls form's operands, the arguments the wrapper passes (a build
    without the ratio words gets its psum's arguments without them)."""
    from abc_tpu_torch.ops import mesh_kernels as mk
    kind, args, kwargs = operands
    if kind == "combine":
        res, make = mk.combine_args(*args, **kwargs)
        argv = make(res)
        return (lambda: lib.abc_dist_ntt_combine(*argv, stream)), res
    res, make = mk.psum_args(*args, **kwargs)
    argv = list(make(res))
    if not new:
        del argv[9]
    return (lambda: lib.abc_rns_psum_mod(*argv, stream)), res


def kernels(baselines, rounds, emit) -> list:
    """The kernel level: every k8_calls form, this tree's build beside each
    baseline's, in turns. Returns the medians by form."""
    import torch
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import kernel_census as kc
    from abc_tpu_torch.scripts.behz_ab import build_baseline
    from abc_tpu_torch.scripts.ks_ab import in_turns
    sys.path.insert(0, TREE)
    import chip_smoke

    dev = torch.device("cuda", 0)
    _build.build()
    libs = {"this": _build.load()}
    news = {"this": True}
    tables = {"this": kc.kernel_table(_build.build_log, _build.sass(),
                                      prefix=kc.MESH)}
    for directory in baselines:
        name = os.path.basename(os.path.normpath(directory))
        libs[name], log, sass = build_baseline(
            kernel_dir(directory), "mesh.cu", bind, name=name)
        news[name] = bind(libs[name])
        tables[name] = kc.kernel_table(log, sass, prefix=kc.MESH)
    for which, table in tables.items():
        for key, row in table.items():
            emit({"build": which, "kernel": key, **row})
            print(f"  {which} {key}: {kc.fmt_kernel(row)}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    summary = []
    for edge in ("max", None):
        calls = chip_smoke.k8_calls(dev, edge)
        for label, (name, _, plain, n_bytes, imads, library, at,
                    operands) in calls.items():
            want = plain()
            fns, match = {}, {}
            for w, lib in libs.items():
                launch, res = launcher(lib, news[w], operands, stream)
                res.fill_(-1)
                if launch() != 0:
                    raise RuntimeError(f"{w}: {label} failed to launch")
                torch.cuda.synchronize()
                if not torch.equal(res, want):
                    raise AssertionError(f"{label} (edge {edge}): {w}'s "
                                         "words differ from the plain "
                                         "version's")
                fns[w], match[w] = launch, name
            if edge is not None:
                continue
            if library is not None:
                fns["torch.remainder"] = library
                match["torch.remainder"] = "remainder"
            times, med = in_turns(fns, match, rounds)
            bound_ms, by = chip_smoke.bound(n_bytes, imads)
            plan = chip_smoke.k8_plan(at)
            emit({"form": label, "at": at, "plan": plan,
                  "bound_us": bound_ms * 1e3, "bound_by": by,
                  "device_us": times, "median_us": med})
            summary.append({"form": label, "bound_us": bound_ms * 1e3, **{
                f"{w}_{t}_us": v for w, m in med.items()
                for t, v in m.items()}})
            print(f"  {label} {at}: " + "; ".join(
                f"{w} " + ", ".join(f"{t} {v:.2f} us" for t, v in m.items())
                for w, m in med.items()) + f"; bound {bound_ms * 1e3:.2f} us "
                f"by {by}; plan {plan}", flush=True)
        del calls
        torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------- op level

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
    ap.add_argument("--baseline", nargs="*", default=[], metavar="DIR",
                    help="trees (kernel and op level) or directories "
                         "holding another mesh.cu (kernel level)")
    ap.add_argument("--kernel-rounds", type=int, default=3,
                    help="rounds of the kernel level's turns (two "
                         "readings a build a round)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the op level's turns")
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
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    emit({"card": smi})
    summary = {"card": smi,
               "kernels": kernels(args.baseline, args.kernel_rounds, emit)}
    trees = [d for d in args.baseline
             if os.path.isdir(os.path.join(d, "abc_tpu_torch"))]
    names = {os.path.abspath(d): os.path.basename(os.path.normpath(d))
             for d in trees}
    names[TREE] = "this tree"
    order = [os.path.abspath(d) for d in trees]
    order = order + [TREE, TREE] + order[::-1]
    readings = {name: [] for name in names.values()}
    for r in range(args.rounds):
        for tree in order:
            rec = {"round": r, "tree": names[tree], "card": smi,
                   **run_tree(tree)}
            readings[names[tree]].append(rec)
            emit(rec)
    summary["medians"] = {name: {k: statistics.median(
        rec[k] for rec in recs if rec[k] is not None)
        for k in recs[0] if k not in ("round", "tree", "card") and
        any(rec[k] is not None for rec in recs)}
        for name, recs in readings.items()}
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
