"""The key switch's kernels (ks_decompose, ks_contract, and ks_mod_down
with and without its relinearization's and rotation's tails, of
csrc/keyswitch.cu) on the card, beside other builds of the same file.

    python -m abc_tpu_torch.scripts.ks_ab [--baseline DIR ...] [--rounds R]
                                          [--out PATH]

At SHAPES (chip_smoke.py phase 2c's timed shapes) this tree's kernels run
on the operands of one key switch: the lift of d, the contraction of D
with both key halves, the contraction with a Galois permutation read in
its loads, a decryption's one-half contraction of a ciphertext's two
components with [1, s], the mod switch down of both halves alone, with a
relinearization's tail and with a rotation's (g = 3), and, at CKKS
shapes, the rescale of a ciphertext (the division by its last prime).
Each launch's plan is printed (keyswitch_kernels.plan and .mod_down_plan:
instantiation, columns a thread, lanes a quad or kept rows a thread,
threads, blocks, occupancy) beside the compiler's census of every
key-switch kernel (ops/kernel_census.py).

With --baseline, each DIR holds another keyswitch.cu and the headers it
includes (rns_common.cuh, ntt_common.cuh), such as an earlier commit's from
`git archive`; it is built the same way (behz_ab.build_baseline), named by
its directory, and every build runs the same inputs: the words must be
equal, and the profiler's device time of each kernel, warm (calls one
after another) and cold (the L2 flushed before each call), is read in
turns (the baselines, this tree, this tree, the baselines in reverse),
--rounds times. A build without abc_ks_mod_down_plan is one from before
the rotation's tail took g^-1: its tail reads galois_gather's tables. One
JSON object per line; the last holds the medians.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys

import numpy as np
import torch

from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import kernel_census as kc
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.scripts.behz_ab import (build_baseline, card, device_us,
                                           emit)

# (scheme, n, L data primes, k special primes, ciphertexts, level): BFV at
# the main path's n=8192 (k = 1 and 2, one ciphertext and B=64),
# LaplaceSharpening's n=16384, CKKS config 5's n=32768 at full level
SHAPES = [("bfv", 8192, 6, 1, 1, 6), ("bfv", 8192, 6, 1, 64, 6),
          ("bfv", 8192, 6, 2, 1, 6), ("bfv", 8192, 6, 2, 64, 6),
          ("bfv", 16384, 13, 1, 1, 13), ("ckks", 32768, 8, 2, 1, 8)]
KERNELS = ("ks_decompose", "ks_contract", "ks_contract+perm",
           "ks_contract/1", "ks_mod_down", "ks_mod_down_relin",
           "ks_mod_down_rotate", "ks_mod_down/rescale")
# the Galois element of the timed rotation tail
ROTATE_G = 3


def bind_two(lib: ctypes.CDLL) -> None:
    """The argument types of abc_ks_decompose and abc_ks_contract, the same
    in every build of the file, on a build that may lack the other entry
    points (one from before abc_ks_plan), and of the mod switch down's:
    abc_ks_mod_down_tail takes g^-1 where a build without
    abc_ks_mod_down_plan takes the gather and sign tables' pointers."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.abc_ks_decompose.argtypes = [vp] * 5 + [i64, i64] + [i32] * 5 + [vp]
    lib.abc_ks_contract.argtypes = [vp] * 7 + [i64, i64] + [i32] * 3 + [vp]
    for fn in (lib.abc_ks_decompose, lib.abc_ks_contract):
        fn.restype = ctypes.c_int
    if not hasattr(lib, "abc_ks_mod_down_tail"):
        return
    lib.abc_ks_mod_down.argtypes = [vp] * 3 + [i64, i64] + [i32] * 3 + [vp]
    lib.abc_ks_mod_down_tail.argtypes = [vp] * 3 + [i64, i64] + \
        [i32] * 4 + [vp, i64, i64] + (
            [i64, vp] if takes_ginv(lib) else [vp] * 3)
    for fn in (lib.abc_ks_mod_down, lib.abc_ks_mod_down_tail):
        fn.restype = ctypes.c_int


def takes_ginv(lib) -> bool:
    """Whether a build's rotation tail takes g^-1 (this tree's), not
    galois_gather's tables."""
    return hasattr(lib, "abc_ks_mod_down_plan")


def in_turns(launches: dict, match, rounds: int):
    """The profiler's device µs of each build's launch() (behz_ab.device_us:
    every kernel whose name holds `match`, or match[build] where it is a
    dict), warm and cold, read in turns (the builds in order, then in
    reverse) `rounds` times: ({build: {"warm": [...], "cold": [...]}},
    their medians). A profile that lost its kernel records reads None and
    is left out of the median."""
    which = list(launches)
    times = {w: {"warm": [], "cold": []} for w in which}
    for _ in range(rounds):
        for w in which + which[::-1]:
            for temp in ("warm", "cold"):
                us, _ = device_us(launches[w], match=match[w] if isinstance(
                    match, dict) else match, cold=temp == "cold")
                times[w][temp].append(us)
    med = {w: {t: statistics.median(x for x in v if x is not None)
               for t, v in ts.items() if any(x is not None for x in v)}
           for w, ts in times.items()}
    return times, med


def operands(scheme, n, L, k, batch, level, dev):
    """The key switch's operands at one shape, as chip_smoke.ks_calls makes
    them: random residues with 0 and q-1 among them."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.ntt import eval_perm_tables
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.crypto.rlwe import galois_gather
    from abc_tpu_torch.ops.modarith import as_residues, ratio_table
    p = BfvParams.create(n, seed=11, ks_digits=k) if scheme == "bfv" else \
        CkksParams.create(n, levels=L, seed=3, ks_digits=k)
    qs = p.data_primes[:level]
    cols = qs + p.special_primes
    groups = [g for g in ([i for i in grp if i < level]
                          for grp in p.digit_groups) if g]
    lead = () if batch == 1 else (batch,)
    rng = np.random.default_rng(n + level + batch + k)

    def rand(moduli, shape):
        q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
        h = rng.integers(0, q, size=shape + (len(moduli), n),
                         dtype=np.uint64)
        h[..., 0] = 0
        h[..., 1::257] = q - 1
        return as_residues(h, dev)

    A = len(groups)
    e, pos = eval_perm_tables(n)

    def column(moduli):
        return as_residues(np.asarray(moduli, np.uint32).reshape(-1, 1), dev)

    gather, sign = galois_gather(n, ROTATE_G, dev)
    return {"d": rand(qs, lead), "D": rand(cols, lead + (A,)),
            "x": rand(cols, lead + (2,)), "prod": rand(qs, lead + (3,)),
            "division": kk.Division(cols, k, dev),
            "gather": gather, "sign": sign,
            "ginv": pow(ROTATE_G, -1, 2 * n),
            "rescale": kk.Division(qs, 1, dev) if scheme == "ckks" and
            level > 1 else None,
            "kb": rand(cols, (A,)), "ka": rand(cols, (A,)),
            "q": column(cols), "ratio": ratio_table(cols, dev),
            "ct": rand(qs, lead + (2,)), "sk": rand(qs, (2,)),
            "qd": column(qs), "rd": ratio_table(qs, dev),
            "perm": torch.from_numpy(pos[(e * 3) % (2 * n)]).to(dev),
            "digits": None if k == 1 else kk.Digits(p.data_primes, groups,
                                                    cols, k, dev),
            "rows": batch, "A": A, "R": len(cols), "L": level, "K": k}


def calls(lib, ops, stream) -> dict:
    """{kernel: (launch() -> return code, output)} of one library on the
    operands."""
    d, D, q, ratio = ops["d"], ops["D"], ops["q"], ops["ratio"]
    rows, A, R, L, K = (ops[x] for x in ("rows", "A", "R", "L", "K"))
    n = d.shape[-1]
    logn = n.bit_length() - 1
    tab = None if ops["digits"] is None else ops["digits"].words.data_ptr()
    lead = tuple(d.shape[:-2])
    lifted = torch.empty(lead + (A, R, n), dtype=torch.int32, device=d.device)
    outs = {name: torch.empty(lead + (2, R, n), dtype=torch.int32,
                              device=d.device) for name in KERNELS[1:3]}
    outs["ks_contract/1"] = torch.empty(lead + (1, L, n), dtype=torch.int32,
                                        device=d.device)
    ptrs = [ptr.data_ptr() for ptr in (D, ops["kb"], ops["ka"])]

    def contract(name, perm):
        return lambda: lib.abc_ks_contract(
            *ptrs, outs[name].data_ptr(), perm, q.data_ptr(),
            ratio.data_ptr(), rows, 1, A, R, logn, stream)

    x, prod, div = ops["x"], ops["prod"], ops["division"]
    Lo, k = div.Lo, div.k
    for name in KERNELS[4:]:
        outs[name] = torch.empty(lead + (2, L - (name == KERNELS[-1]), n),
                                 dtype=torch.int32, device=d.device)

    def mod_down(name, tail, c, c_comp, rotate):
        args = (x.data_ptr(), outs[name].data_ptr(), div.words.data_ptr(),
                2 * rows, (Lo + k) * n, Lo, k, logn)
        if tail == 0:
            return lambda: lib.abc_ks_mod_down(*args, stream)
        table = (ops["ginv"] if rotate else 0,) if takes_ginv(lib) else \
            (ops["gather"].data_ptr(), ops["sign"].data_ptr()) if rotate \
            else (None, None)
        return lambda: lib.abc_ks_mod_down_tail(
            *args, tail, c.data_ptr(), 3 * L * n, c_comp, *table, stream)

    mods = {"ks_mod_down": (mod_down("ks_mod_down", 0, None, 0, False),
                            outs["ks_mod_down"]),
            "ks_mod_down_relin": (mod_down("ks_mod_down_relin", 1, prod,
                                           L * n, False),
                                  outs["ks_mod_down_relin"]),
            "ks_mod_down_rotate": (mod_down("ks_mod_down_rotate", 2,
                                            prod[..., 0, :, :], 0, True),
                                   outs["ks_mod_down_rotate"])}
    if ops["rescale"] is not None:
        r = ops["rescale"]
        mods[KERNELS[-1]] = (lambda: lib.abc_ks_mod_down(
            ops["ct"].data_ptr(), outs[KERNELS[-1]].data_ptr(),
            r.words.data_ptr(), 2 * rows, L * n, L - 1, 1, logn, stream),
            outs[KERNELS[-1]])
    return {**mods,
        "ks_decompose": (lambda: lib.abc_ks_decompose(
            d.data_ptr(), lifted.data_ptr(), q.data_ptr(), ratio.data_ptr(),
            tab, rows, L * n, L, A, R, K, logn, stream), lifted),
        "ks_contract": (contract("ks_contract", None), outs["ks_contract"]),
        "ks_contract+perm": (contract("ks_contract+perm",
                                      ops["perm"].data_ptr()),
                             outs["ks_contract+perm"]),
        "ks_contract/1": (lambda: lib.abc_ks_contract(
            ops["ct"].data_ptr(), ops["sk"].data_ptr(), None,
            outs["ks_contract/1"].data_ptr(), None, ops["qd"].data_ptr(),
            ops["rd"].data_ptr(), rows, 1, 2, L, logn, stream),
            outs["ks_contract/1"])}


def run(args) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("ks_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    out = open(args.out, "w") if args.out else None
    emit({"card": smi}, out)
    _build.build()
    lib = _build.load()
    tables = {"this": kc.kernel_table(_build.build_log, _build.sass(),
                                      prefix="ks_")}
    bases = {}
    for directory in args.baseline:
        name = os.path.basename(os.path.normpath(directory))
        bases[name], log, sass = build_baseline(directory, "keyswitch.cu",
                                                bind_two)
        tables[name] = kc.kernel_table(log, sass, prefix="ks_")
    for which, table in tables.items():
        for key, row in table.items():
            emit({"build": which, "kernel": key, **row}, out)
            print(f"  {which} {key}: {kc.fmt_kernel(row)}", flush=True)

    summary, stream = [], torch.cuda.current_stream(dev).cuda_stream
    for shape in SHAPES:
        ops = operands(*shape, dev)
        n = ops["d"].shape[-1]
        builds = {w: calls(base, ops, stream) for w, base in bases.items()}
        builds["this"] = calls(lib, ops, stream)
        for name in KERNELS:
            if name not in builds["this"]:
                continue
            kname = name.split("+")[0].split("/")[0]
            if kname.startswith("ks_mod_down"):
                rescale = name.endswith("/rescale")
                plans = {"this": kk.mod_down_plan(
                    kname, n, 2 * ops["rows"], ops["L"] - rescale,
                    1 if rescale else ops["K"])}
            else:
                spec = dict(rows=ops["rows"], A=ops["A"], R=ops["R"])
                if kname == "ks_decompose":
                    spec["K"] = ops["K"]
                if name == "ks_contract/1":
                    spec.update(A=2, R=ops["L"], halves=1)
                plans = {"this": kk.plan(kname, n, **spec)}
            which_ = list(builds)
            for w in which_:
                if builds[w][name][0]() != 0:
                    raise RuntimeError(f"{w} {name} at {shape} failed to "
                                       "launch")
            torch.cuda.synchronize()
            for w in which_:
                if not torch.equal(builds[w][name][1],
                                   builds["this"][name][1]):
                    raise AssertionError(f"{name} at {shape}: {w}'s words "
                                         "differ from this tree's")
            times, med = in_turns({w: builds[w][name][0] for w in which_},
                                  kname, args.rounds)
            rec = {"shape": list(shape), "kernel": name, "plans": plans,
                   "device_us": times, "median_us": med}
            emit(rec, out)
            summary.append({"shape": list(shape), "kernel": name,
                            **{f"{w}_{t}_us": v for w, m in med.items()
                               for t, v in m.items()}})
            print(f"  {shape} {name}: " + "; ".join(
                f"{w} " + ", ".join(f"{t} {v:.2f} us" for t, v in m.items())
                for w, m in med.items()) + f"; plan {plans.get('this')}",
                flush=True)
        del ops, builds
        torch.cuda.empty_cache()
    emit({"card": smi, "medians": summary}, out)
    if out:
        out.close()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m abc_tpu_torch.scripts.ks_ab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[], metavar="DIR",
                    help="directories each holding another keyswitch.cu "
                         "(and the headers it includes)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every JSON line there")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
