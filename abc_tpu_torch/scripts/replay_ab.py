"""Captured programs on the card with this tree's kernels beside builds of
variants of its csrc/ (the same C entry points; a launch attribute or a
plan's constant changed), in one process, in turns.

    python -m abc_tpu_torch.scripts.replay_ab [--variant DIR ...]
                                              [--rounds R] [--reps N]
                                              [--out PATH]

Each DIR holds every source and header of csrc/; it is built whole
(ops/_build.build) into a library of its own and loaded beside this tree's
(_build.open_library). For every build, three graphs are captured with that
build in the package's place (_build._LIB): the benchsuite's config 2 step
(a BFV mult+relin at n=8192, B=1: 16 kernels) and config 3 step (the
batched hamming op: a mult+relin, 2 rotations, 3 adds), each a chain of
CHAIN steps, and config 6's program (LaplaceSharpening at n=16384 through
jit_compile_program: the graph that `run_raw` replays). Every build's words
must equal this tree's. Then each graph is timed, ms a step (a chain's
replay over CHAIN) or a `run_raw` of config 6 (copy in, replay, clone out,
as t_computation times it), the median of --reps between CUDA events, in
turns: the builds in order, then in reverse, --rounds times. A replay's
level depends on the process's history (PERF.md §7): only readings of one
process in turns compare. One JSON object per line; the last holds the
medians.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import random
import statistics
import sys

import torch

from abc_tpu_torch.ops import _build
from abc_tpu_torch.scripts.behz_ab import card, emit

CHAIN = 12


def _ms(fn, reps):
    """Median ms of fn() between CUDA events over `reps` calls."""
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


def captures(dev):
    """{name: (capture() -> (timed call, its output words, ms a call per
    step))}: what each build captures."""
    from abc_tpu_torch.benchsuite import (LAPLACE_PROGRAM, LAPLACE_SIZE,
                                          whole_op_chain)
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program
    from abc_tpu_torch.utils.timing import graph_of

    mr = BfvContext(BfvParams.create(8192, seed=123), dev)
    mr.ensure_eval_ready()
    mr.get_relin_key()
    a, b = mr.encrypt_many([mr.encode([1, 2, 3, 4]),
                            mr.encode([5, 6, 7, 8])])
    hm = BfvContext(BfvParams.create(8192, seed=7), dev)
    hm.ensure_eval_ready()
    hm.get_relin_key()
    for steps in (1, 2):
        hm.get_galois_key(pow(3, steps, 2 * 8192))
    x, y = hm.encrypt_many([hm.encode([1, 1, 0, 1]),
                            hm.encode([1, 0, 1, 1])])

    def mult(v):
        return mr.multiply(BfvCiphertext(v), BfvCiphertext(b.data)).data

    def hamming(v):
        d = hm.sub(BfvCiphertext(v), BfvCiphertext(y.data))
        sq = hm.multiply(d, d)
        s = hm.add(sq, hm.rotate_rows(sq, 2))
        return hm.add(s, hm.rotate_rows(s, 1)).data

    def chain(ctx, step, x0, census):
        def make():
            g = graph_of(whole_op_chain(ctx, step, census)(CHAIN), x0)
            g.replay()
            return g.replay, g.output, CHAIN
        return make

    rng = random.Random(7)
    img = [rng.randrange(0, 256) for _ in range(LAPLACE_SIZE ** 2)]
    inputs_src = ("secret int img = {" + ",".join(map(str, img)) + "};"
                  f" int imgSize = {LAPLACE_SIZE};")

    def laplace():
        jp = jit_compile_program(
            LAPLACE_PROGRAM, inputs_src, "out = img2;",
            factory=BfvCiphertextFactory(slots=16384, seed=23, device=dev))
        raw = jp.run_raw(jp.secret_inputs)
        words = torch.cat([t.reshape(-1) for t in raw.values()
                           if isinstance(t, torch.Tensor)])
        return lambda: jp.run_raw(jp.secret_inputs), words, 1

    return {"mult_relin": chain(mr, mult, a.data, (5, 3)),
            "hamming": chain(hm, hamming, x.data, (5, 5)),
            "laplace": laplace}


def run(args) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("replay_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    out = open(args.out, "w") if args.out else None
    emit({"card": smi}, out)
    libs = {}
    for directory in args.variant:
        name = os.path.basename(os.path.normpath(directory))
        so = os.path.join(_build.BUILD_DIR, f"libabc_variant_{name}.so")
        _build.build(directory, so)
        libs[name] = _build.open_library(so)
    libs["this"] = _build.load()
    made = {name: {} for name in libs}
    for what, capture in captures(dev).items():
        for name, lib in libs.items():
            _build._LIB = lib
            made[name][what] = capture()
        _build._LIB = libs["this"]
        torch.cuda.synchronize()
        want = made["this"][what][1]
        for name in libs:
            if not torch.equal(made[name][what][1], want):
                raise AssertionError(f"{what}: {name}'s words differ from "
                                     "this tree's")
    order = list(libs) + list(libs)[::-1]
    times = {what: {name: [] for name in libs} for what in made["this"]}
    for _ in range(args.rounds):
        for what in times:
            for name in order:
                call, _, per = made[name][what]
                times[what][name].append(_ms(call, args.reps) / per)
    med = {what: {name: statistics.median(v) for name, v in t.items()}
           for what, t in times.items()}
    for what in times:
        emit({"graph": what, "ms": times[what], "median_ms": med[what]}, out)
        print(f"  {what}: " + ", ".join(f"{name} {v:.4f} ms"
                                         for name, v in med[what].items()),
              flush=True)
    emit({"card": smi, "medians": med}, out)
    if out:
        out.close()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m abc_tpu_torch.scripts.replay_ab",
        description=__doc__.split("\n")[0])
    ap.add_argument("--variant", nargs="*", default=[], metavar="DIR",
                    help="directories each holding every source and header "
                         "of csrc/, changed")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every JSON line there")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
