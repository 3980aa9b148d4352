"""The RNS elementwise kernels (rns_ew_add, rns_ew_sub, rns_ew_mul,
rns_ew_neg of csrc/elementwise.cu) on the card, beside other builds of the
same file.

    python -m abc_tpu_torch.scripts.ew_ab [--baseline DIR ...] [--rounds R]
                                          [--out PATH]

At SHAPES (chip_smoke.py phase 2e's timed shapes: one ciphertext and B=64
at the main path's n=8192, LaplaceSharpening's n=16384, CKKS config 5's
n=32768) this tree's kernel runs every form of FORMS on [B, 2, L, n]
ciphertexts: the add and the subtract of two, the product by a plaintext
[L, n], the negation, the CKKS integer multiply by a column [L, 1], and the
component-0 forms of add_plain and sub_from_plain (a plaintext's
coefficients times Δ). Each launch's plan is printed
(elementwise_kernels.launch_info: quads a thread, threads, blocks,
occupancy) beside the compiler's census of every elementwise kernel
(ops/kernel_census.py).

With --baseline, each DIR holds another elementwise.cu and the headers it
includes (rns_common.cuh, ntt_common.cuh), such as an earlier commit's from
`git archive`; it is built the same way (behz_ab.build_baseline), named by
its directory, and every build runs the same inputs: the words of every
build must equal this tree's and the plain version's (`ew_plain`), on
random residues with 0 and q-1 among them and on all-(q-1) inputs, and the
profiler's device time of each, warm and cold, is read in turns
(ks_ab.in_turns), --rounds times. One JSON object per line; the last holds
the medians.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import kernel_census as kc
from abc_tpu_torch.scripts.behz_ab import build_baseline, card, emit
from abc_tpu_torch.scripts.ks_ab import in_turns

# (scheme, n, L data primes, ciphertexts)
SHAPES = [("bfv", 8192, 6, 1), ("bfv", 8192, 6, 64), ("bfv", 16384, 13, 1),
          ("ckks", 32768, 8, 1)]
# form: (op, b's operand, with w, component-0 form)
FORMS = {"add": ("add", "b", False, False),
         "sub": ("sub", "b", False, False),
         "mul plaintext": ("mul", "plane", False, False),
         "neg": ("neg", None, False, False),
         "mul column": ("mul", "col", False, False),
         "add c0": ("add", "pt", True, True),
         "neg c0": ("neg", "pt", True, True)}


def operands(scheme, n, L, batch, edge, dev):
    """A form's operands at one shape, as chip_smoke.k9_calls makes them:
    random residues with 0 and q-1 among them, or all q-1 (`edge`
    "max")."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops.modarith import as_residues, ratio_table
    p = BfvParams.create(n, seed=11) if scheme == "bfv" else \
        CkksParams.create(n, levels=L, seed=3)
    qs = p.data_primes[:L]
    lead = () if batch == 1 else (batch,)
    rng = np.random.default_rng(n + L + batch)

    def rand(moduli, shape):
        q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
        if edge == "max":
            return as_residues(np.broadcast_to(
                q - 1, shape + (len(moduli), n)).copy(), dev)
        h = rng.integers(0, q, size=shape + (len(moduli), n),
                         dtype=np.uint64)
        h[..., 0] = 0
        h[..., 1::257] = q - 1
        return as_residues(h, dev)

    return {"a": rand(qs, lead + (2,)), "b": rand(qs, lead + (2,)),
            "plane": rand(qs, ()),
            "pt": (rand(qs[:1], ())[0] % 65537).expand(L, -1),
            "w": rand(qs, ())[:, :1].contiguous(),
            "col": rand(qs, ())[:, :1].contiguous(),
            "q": as_residues(np.asarray(qs, np.uint32).reshape(-1, 1), dev),
            "ratio": ratio_table(qs, dev)}


def calls(lib, ops, stream) -> dict:
    """{form: (launch() -> return code, output, plain() -> words)} of one
    library on the operands (abc_rns_ew's arguments as the wrapper makes
    them: elementwise_kernels._args)."""
    out = {}
    for form, (op, bname, with_w, first) in FORMS.items():
        b = None if bname is None else ops[bname]
        w = ops["w"] if with_w else None
        shape, args = ew._args(op, ops["a"], b, ops["q"], ops["ratio"], w,
                               first)
        dst = torch.empty(shape, dtype=torch.int32, device=ops["a"].device)
        out[form] = (
            lambda args=args, dst=dst: lib.abc_rns_ew(*args(dst), stream),
            dst, lambda op=op, b=b, w=w, first=first: ew.ew_plain(
                op, ops["a"], b, ops["q"], w, first))
    return out


def run(args) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("ew_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    out = open(args.out, "w") if args.out else None
    emit({"card": smi}, out)
    _build.build()
    lib = _build.load()
    tables = {"this": kc.kernel_table(_build.build_log, _build.sass(),
                                      prefix="rns_ew_")}
    libs = {}
    for directory in args.baseline:
        name = os.path.basename(os.path.normpath(directory))
        libs[name], log, sass = build_baseline(
            directory, "elementwise.cu", _build.bind_elementwise)
        tables[name] = kc.kernel_table(log, sass, prefix="rns_ew_")
    libs["this"] = lib
    for which, table in tables.items():
        for key, row in table.items():
            emit({"build": which, "kernel": key, **row}, out)
            print(f"  {which} {key}: {kc.fmt_kernel(row)}", flush=True)

    summary, stream = [], torch.cuda.current_stream(dev).cuda_stream
    for shape in SHAPES:
        scheme, n, L, batch = shape
        for edge in ("max", None):
            ops = operands(scheme, n, L, batch, edge, dev)
            builds = {w: calls(b, ops, stream) for w, b in libs.items()}
            for form, (op, *_rest) in FORMS.items():
                for w in builds:
                    if builds[w][form][0]() != 0:
                        raise RuntimeError(f"{w} {form} at {shape} failed "
                                           "to launch")
                torch.cuda.synchronize()
                want = builds["this"][form][2]()
                for w in builds:
                    if not torch.equal(builds[w][form][1], want):
                        raise AssertionError(
                            f"{form} at {shape} (edge {edge}): {w}'s words "
                            "differ from the plain version's")
                if edge is not None:
                    continue
                kname = f"rns_ew_{op}"
                info = ew.launch_info(op, 2 * batch * L, n)
                times, med = in_turns(
                    {w: builds[w][form][0] for w in builds}, kname,
                    args.rounds)
                emit({"shape": list(shape), "form": form, "plan": info,
                      "kernel": kc.ew_launch_key(kname, info),
                      "device_us": times, "median_us": med}, out)
                summary.append({"shape": list(shape), "form": form,
                                **{f"{w}_{t}_us": v for w, m in med.items()
                                   for t, v in m.items()}})
                print(f"  {shape} {form}: " + "; ".join(
                    f"{w} " + ", ".join(f"{t} {v:.2f} us"
                                        for t, v in m.items())
                    for w, m in med.items()) + f"; plan {info}", flush=True)
            del ops, builds
            torch.cuda.empty_cache()
    emit({"card": smi, "medians": summary}, out)
    if out:
        out.close()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m abc_tpu_torch.scripts.ew_ab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[], metavar="DIR",
                    help="directories each holding another elementwise.cu "
                         "(and the headers it includes)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every JSON line there")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
