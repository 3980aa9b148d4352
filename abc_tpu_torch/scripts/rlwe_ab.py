"""The encryption's signed lift (rlwe_lift) and the decryption's
scale-and-round (bfv_dec_round) of csrc/rlwe.cu on the card, beside other
builds of the same file, kernel by kernel and inside whole encryptions and
decryptions.

    python -m abc_tpu_torch.scripts.rlwe_ab [--baseline DIR ...] [--rounds R]
                                            [--chain C] [--out PATH]

At FORMS (chip_smoke.py phase 2d's timed cases of the two kernels) this
tree's kernels run on operands drawn at random with 0 and q-1 among them:
the encryption's lift with the inverse transform's output and Δ·m (BFV:
one ciphertext and B=64 at the main path's n=8192, one at
LaplaceSharpening's n=16384) or the plaintext rows (CKKS config 5's
n=32768), the lift of u alone, the 19 keys' error lift of
LaplaceSharpening, and the scale-and-round at n=8192 and n=16384. Each
launch's plan is printed (rlwe_kernels.launch_info: limb rows a thread or
the scale-and-round's design, threads, blocks, occupancy) beside the
compiler's census of both kernels (ops/kernel_census.py).

With --baseline, each DIR holds another rlwe.cu and the headers it
includes (rns_common.cuh, ntt_common.cuh), such as an earlier commit's
from `git archive` or a copy of this one with a constant changed
(kLiftRows); it is built the same way
(behz_ab.build_baseline), named by its directory. A build without
abc_rlwe_plan is one from before the scale-and-round wrote its own flag:
its entry point takes no flag length and zeroes its one flag word with a
memset first. Every build runs the same inputs: the words must equal the plain
versions' (rlwe_lift_plain, bfv_dec_round_plain, the flag too), on random
inputs and on all-(q-1) inputs with lifts of ±19; the profiler's device
time of each kernel, warm and cold, is read in turns (ks_ab.in_turns),
--rounds times.

Then BfvContext.encrypt and .decrypt whole, at (8192, 6) and (16384, 13),
each as a chain of --chain calls on one context with each build's two
kernels swapped in (the context's other kernels are this tree's), in turns
--rounds times: the host clock of the chain (a decryption syncs on its
flag) and the profiler's device time a call, all of it and the two
kernels' share, with the memsets counted. One JSON object per line; the
last holds the medians.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import sys
import time

import numpy as np
import torch

from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import kernel_census as kc
from abc_tpu_torch.ops import rlwe_kernels as rk
from abc_tpu_torch.scripts.behz_ab import build_baseline, card, emit
from abc_tpu_torch.scripts.ks_ab import in_turns

# (form, scheme, n, L data primes, ciphertexts or keys): phase 2d's timed
# cases of rlwe_lift and bfv_dec_round
FORMS = [("lift_encrypt", "bfv", 8192, 6, 1),
         ("lift_encrypt", "bfv", 8192, 6, 64),
         ("lift_encrypt", "bfv", 16384, 13, 1),
         ("lift_encrypt", "ckks", 32768, 8, 1),
         ("lift_u", "bfv", 8192, 6, 1),
         ("lift_errors", "bfv", 16384, 13, 19),
         ("bfv_dec_round", "bfv", 8192, 6, 1),
         ("bfv_dec_round", "bfv", 16384, 13, 1)]
# (n, L) of the whole encryptions and decryptions
WHOLE = [(8192, 6), (16384, 13)]
PREFIX = ("rlwe_lift", "bfv_dec_round")


def bind(lib) -> bool:
    """Binds a build's two entry points; whether it is one whose
    scale-and-round writes a flag word a block (abc_rlwe_plan), not one
    that zeroes its flag by a memset."""
    if hasattr(lib, "abc_rlwe_plan"):
        _build.bind_rlwe(lib)
        return True
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32)
    lib.abc_rlwe_lift.argtypes = [vp] * 6 + [i64, i32, i32, vp]
    lib.abc_bfv_dec_round.argtypes = [vp] * 4 + [i64, i32, u32, i32, vp]
    lib.abc_rlwe_lift.restype = lib.abc_bfv_dec_round.restype = i32
    return False


def _params(scheme, n, L):
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.params import BfvParams
    p = BfvParams.create(n, seed=11) if scheme == "bfv" else \
        CkksParams.create(n, levels=L, seed=3, ks_digits=2)
    if p.L != L:
        raise ValueError(f"{scheme} n={n}: L={p.L}, not {L}")
    return p


def operands(form, scheme, n, L, count, edge, dev) -> dict:
    """The operands of one form, as chip_smoke.rlwe_calls makes them:
    random residues with 0 and q-1 among them and small values of ±19 with
    0 among them, or all q-1 and ±19 alternating (`edge` "max"). Keys
    `v`, `q`, `base`, `msg`, `delta` (lifts) or `v`, `tab` (the
    scale-and-round)."""
    from abc_tpu_torch.ops.modarith import as_residues
    p = _params(scheme, n, L)
    rng = np.random.default_rng(n + L + count)

    def residues(moduli, lead):
        q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
        shape = tuple(lead) + (len(moduli), n)
        if edge == "max":
            return as_residues(np.broadcast_to(q - 1, shape).copy(), dev)
        h = rng.integers(0, q, size=shape, dtype=np.uint64)
        h[..., 0] = 0
        h[..., 1::257] = q - 1
        return as_residues(h, dev)

    def small(shape, low=-19, high=20):
        if edge == "max":
            v = np.where(np.arange(shape[-1]) % 2, 19, -19) * \
                np.ones(shape, dtype=int)
        else:
            v = rng.integers(low, high, size=shape)
            v.reshape(-1)[:3] = [max(low, -19), min(high - 1, 19), 0]
        return torch.from_numpy(v.astype(np.int8)).to(dev)

    def col(moduli):
        return as_residues(np.asarray(moduli, np.uint64).reshape(-1, 1), dev)

    qs = p.data_primes
    if form == "bfv_dec_round":
        return {"v": residues(qs, ()),
                "tab": rk.DecRound(qs, p.plain_modulus, dev)}
    if form == "lift_u":
        return {"v": small((count, n), -1, 2), "q": col(qs), "base": None,
                "msg": None, "delta": None}
    if form == "lift_errors":
        full = p.coeff_modulus
        return {"v": small((count, p.num_ks_digits, n)), "q": col(full),
                "base": None, "msg": None, "delta": None}
    ops = {"v": small((count, 2, n)), "q": col(qs),
           "base": residues(qs, (count, 2)), "delta": None}
    if scheme == "bfv":
        t = p.plain_modulus
        m = rng.integers(0, t, size=(count, n))
        if edge == "max":
            m[...] = t - 1
        ops["msg"] = as_residues(m.astype(np.uint64), dev)
        ops["delta"] = rk.shoup_pairs(rng.integers(
            0, np.asarray(qs, np.uint64).reshape(-1, 1), size=(L, 1),
            dtype=np.uint64), qs, dev)
    else:
        ops["msg"] = residues(qs, (count,))
    return ops


def call(lib, new, form, ops, stream):
    """(launch() -> return code, result() -> output words, plain() ->
    words) of one build on one form's operands (the scale-and-round's:
    m, then 1 if any word of its flag is set, else 0)."""
    v = ops["v"]
    n = v.shape[-1]
    logn = n.bit_length() - 1
    if form == "bfv_dec_round":
        tab = ops["tab"]
        L = tab.L
        rows = v.numel() // (L * n)
        out = torch.empty(tuple(v.shape[:-2]) + (n,), dtype=torch.int32,
                          device=v.device)
        flag = torch.empty(rk.flag_words(rows * n) if new else 1,
                           dtype=torch.int32, device=v.device)
        head = [v.data_ptr(), tab.words.data_ptr(), out.data_ptr(),
                flag.data_ptr()] + ([flag.numel()] if new else [])

        def launch():
            return lib.abc_bfv_dec_round(*head, rows, L, tab.t, logn, stream)

        def result():
            return torch.cat([out.reshape(-1),
                              (flag != 0).any().to(torch.int32).reshape(1)])

        def plain():
            m, f = rk.bfv_dec_round_plain(v, tab)
            return torch.cat([m.reshape(-1), f.to(torch.int32).reshape(1)])

        return launch, result, plain
    q, base, msg, delta = ops["q"], ops["base"], ops["msg"], ops["delta"]
    out = torch.empty(tuple(v.shape[:-1]) + (q.shape[0], n),
                      dtype=torch.int32, device=v.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        return lib.abc_rlwe_lift(v.data_ptr(), ptr(base), ptr(msg),
                                 ptr(delta), q.data_ptr(), out.data_ptr(),
                                 v.numel() // n, q.shape[0], logn, stream)

    return launch, lambda: out, \
        lambda: rk.rlwe_lift_plain(v, q, base, msg, delta)


def plan_of(form, ops) -> dict:
    """This tree's launch plan of a form."""
    v = ops["v"]
    n = v.shape[-1]
    if form == "bfv_dec_round":
        L = ops["tab"].L
        return rk.launch_info("bfv_dec_round", v.numel() // (L * n), L, n)
    return rk.launch_info("rlwe_lift", v.numel() // n, ops["q"].shape[0], n)


@contextlib.contextmanager
def swapped(lib, new):
    """rlwe_kernels' rlwe_lift and bfv_dec_round launched from `lib`; a
    build without a control word gets its own scale-and-round call."""
    saved = rk._launch, rk.bfv_dec_round

    def launch(name, device, fn):
        with torch.cuda.device(device):
            err = fn(lib, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: error {err}")
        rk.launches[name] += 1

    def dec_round_memset(v, tab):
        L, n = v.shape[-2:]
        m = torch.empty(tuple(v.shape[:-2]) + (n,), dtype=torch.int32,
                        device=v.device)
        flag = torch.empty(1, dtype=torch.int32, device=v.device)
        launch("bfv_dec_round", v.device, lambda lb, st: lb.abc_bfv_dec_round(
            v.data_ptr(), tab.words.data_ptr(), m.data_ptr(),
            flag.data_ptr(), v.numel() // (L * n), L, tab.t,
            n.bit_length() - 1, st))
        return m, flag

    rk._launch = launch
    if not new:
        rk.bfv_dec_round = dec_round_memset
    try:
        yield
    finally:
        rk._launch, rk.bfv_dec_round = saved


def chain_times(ctx, op, x, chain) -> dict:
    """Host ms a call of `chain` calls op(x) (synchronised at both ends),
    then the profiler's device µs a call: all device activity, the two
    kernels', and the memsets."""
    from torch.profiler import ProfilerActivity, profile
    op(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chain):
        op(x)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / chain
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chain):
            op(x)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]

    def total(pick):
        return sum(ev.device_time_total for ev in evs if pick(ev.name)) / chain

    return {"host_ms": host_ms, "device_us": total(lambda s: True),
            "kernels_us": total(lambda s: any(p in s for p in PREFIX)),
            "memset_us": total(lambda s: "emset" in s)}


def whole(libs, news, rounds, chain, dev, out):
    """BfvContext.encrypt and .decrypt at WHOLE, each build in turns."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    summary = []
    for n, L in WHOLE:
        ctx = BfvContext(BfvParams.create(n, seed=11), dev)
        check(ctx.params.L == L, f"BfvParams.create({n}): L={ctx.params.L}")
        pt = ctx.encode(list(range(64)))
        ct = ctx.encrypt(pt)
        want = ctx.decode(ctx.decrypt(ct))
        for what, op, x in (("encrypt", ctx.encrypt, pt),
                            ("decrypt", ctx.decrypt, ct)):
            times = {w: [] for w in libs}
            for _ in range(rounds):
                for w in list(libs) + list(libs)[::-1]:
                    with swapped(libs[w], news[w]):
                        check(ctx.decode(ctx.decrypt(ctx.encrypt(pt)))
                              == want, f"{w}: a round trip at n={n} "
                              "changed the message")
                        times[w].append(chain_times(ctx, op, x, chain))
            med = {w: {k: statistics.median(r[k] for r in rs)
                       for k in rs[0]} for w, rs in times.items()}
            emit({"whole": what, "n": n, "L": L, "chain": chain,
                  "times": times, "medians": med}, out)
            summary.append({"whole": what, "n": n, "L": L, **{
                f"{w}_{k}": v for w, m in med.items() for k, v in m.items()}})
            print(f"  {what} (n={n}, L={L}), a call of {chain}: " + "; ".join(
                f"{w} host {m['host_ms']:.4f} ms, device "
                f"{m['device_us']:.2f} us (the two kernels "
                f"{m['kernels_us']:.2f}, memsets {m['memset_us']:.2f})"
                for w, m in med.items()), flush=True)
        del ctx
        torch.cuda.empty_cache()
    return summary


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def run(args) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("rlwe_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()
    out = open(args.out, "w") if args.out else None
    emit({"card": smi}, out)
    _build.build()
    lib = _build.load()
    tables = {"this": kc.kernel_table(_build.build_log, _build.sass(),
                                      prefix=PREFIX)}
    libs, news = {}, {}
    for directory in args.baseline:
        name = os.path.basename(os.path.normpath(directory))
        libs[name], log, sass = build_baseline(directory, "rlwe.cu", bind)
        news[name] = bind(libs[name])
        tables[name] = kc.kernel_table(log, sass, prefix=PREFIX)
    libs["this"], news["this"] = lib, True
    for which, table in tables.items():
        for key, row in table.items():
            emit({"build": which, "kernel": key, **row}, out)
            print(f"  {which} {key}: {kc.fmt_kernel(row)}", flush=True)

    summary, stream = [], torch.cuda.current_stream(dev).cuda_stream
    for form, scheme, n, L, count in FORMS:
        at = [form, scheme, n, L, count]
        for edge in ("max", None):
            ops = operands(form, scheme, n, L, count, edge, dev)
            builds = {w: call(b, news[w], form, ops, stream)
                      for w, b in libs.items()}
            want = None
            for w, (launch, result, plain) in builds.items():
                check(launch() == 0, f"{w} {at} failed to launch")
                torch.cuda.synchronize()
                if want is None:
                    want = plain()
                check(torch.equal(result(), want),
                      f"{at} (edge {edge}): {w}'s words differ from the "
                      "plain version's")
            if edge is not None:
                continue
            kname = "bfv_dec_round" if form == "bfv_dec_round" else \
                "rlwe_lift"
            info = plan_of(form, ops)
            times, med = in_turns({w: b[0] for w, b in builds.items()},
                                  kname, args.rounds)
            emit({"form": at, "plan": info,
                  "kernel": kc.rlwe_launch_key(kname, info),
                  "device_us": times, "median_us": med}, out)
            summary.append({"form": at, **{
                f"{w}_{t}_us": v for w, m in med.items()
                for t, v in m.items()}})
            print(f"  {at}: " + "; ".join(
                f"{w} " + ", ".join(f"{t} {v:.2f} us" for t, v in m.items())
                for w, m in med.items()) + f"; plan {info}", flush=True)
            del ops, builds
            torch.cuda.empty_cache()
    if args.chain > 0:
        summary += whole(libs, news, args.rounds, args.chain, dev, out)
    emit({"card": smi, "medians": summary}, out)
    if out:
        out.close()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m abc_tpu_torch.scripts.rlwe_ab",
        description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[], metavar="DIR",
                    help="directories each holding another rlwe.cu (and "
                         "the headers it includes)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--chain", type=int, default=200,
                    help="calls of each whole encryption and decryption "
                         "chain (0: none)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every JSON line there")
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
