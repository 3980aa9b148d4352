"""Where the forward NTT kernel's time goes on a CUDA GPU (port of
scripts/ntt_ablation.py).

    python -m abc_tpu_torch.scripts.ntt_ablation [--quick] [--chain C]
    python -m abc_tpu_torch.scripts.ntt_ablation --batched [--quick]

At n = 16384 with the L = 14 moduli of `BfvParams.create(16384, seed=5)`:

  ablation   the kernels of ops/ntt_ablation.py (csrc/ntt_ablation.cu): the
             shipping forward transform, ntt_fwd's design (csrc/ntt.cu and
             csrc/ntt_passes.cuh: C CTAs per row, the gather of the stages
             across CTAs, three stages per pass in registers, 16-byte loads
             and stores), with one class of work removed, as the TPU script
             took apart the kernel that shipped there:
               zero        the geometry's load + store + launch (the floor)
               masks_only  per-stage position arithmetic, no exchange
               rolls_only  every data movement of the shipping kernel, w = 1
               muls_only   Shoup products with their twiddle loads, no
                           exchange
               full        the shipping kernel itself, compiled from the
                           same source
               reformed, rolls_sub, rolls_lane, split0, splitk
                           the TPU's other modes, restated on the same
                           passes (csrc/ntt_ablation.cu says what each
                           changes there)
             then "shipping": `NttContext.fwd`, the kernel the port runs, in
             the same process: `full_over_shipping` near 1 says that the
             ablation took apart the kernel that ships.
  calibration  `alu_chain` mac and shoup: the card's sustained u32 rate on
             the butterfly's own multiply mix, from instruction counts read
             out of the SASS.
  census     instructions per butterfly, counted in the SASS of the
             three-stage register pass of `full` and of ntt_fwd_kernel
             ("shipping"): the same code, so the same counts.
  reconciled achieved ALU rate of `full` against the calibrated ceiling.
  --batched  `ntt_fwd` and `ntt_inv` at B in {1, 8, 16, 64}: the median of
             5 two-point estimates, in us per transform and Gbf/s.

Timing: a chain of c launches is captured once in a CUDA graph and its
replays are timed between CUDA events; the per-launch time is the difference
of chains c and c/2 over c/2, which cancels the graph launch and the event
overhead (`fixed_dispatch_ms` is what cancels). The profiler's kernel time
per eager launch is printed beside it as a cross-check. `launches` of the
wrapper modules count the captures, not the replays.

Needs a CUDA device and raises at once without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import Counter

import numpy as np
import torch

from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import ntt_ablation as na
from abc_tpu_torch.ops.kernel_census import opcode, sass_functions
from abc_tpu_torch.ops.modarith import as_residues
from abc_tpu_torch.utils.timing import chain_of, estimates, timed_per_iter

N = 16384
ALU_ITERS = 512
ALU_UNROLL = 8          # `#pragma unroll 8` on both chains, csrc/ntt_ablation.cu
BATCHES = ((1, 2048), (8, 256), (16, 128), (64, 32))
ONE_KERNEL = ("one column per direction: the port has one kernel each "
              "(ntt_fwd, ntt_inv) where the TPU had two (rank-1 and "
              "full-plane twiddle tables); its rows read the [L, n] tables "
              "directly at every batch size")


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("ntt_ablation measures kernels on a CUDA device; "
                           "none is available")


def setup(device, n=N):
    """The NTT context of the measurement and a [L, n] input below min q."""
    moduli = list(BfvParams.create(n, seed=5).coeff_modulus)
    ctx = NttContext(n, moduli, device)
    rng = np.random.default_rng(0)
    x0 = as_residues(rng.integers(0, min(moduli), size=(len(moduli), n),
                                  dtype=np.uint64), device)
    return ctx, x0


def profiled_s(step, x0, reps=20):
    """Device kernel time per eager launch of step(x0) by torch.profiler, in
    seconds; None where the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    step(x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(x0)
        torch.cuda.synchronize()
    us = [ev.device_time_total for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and "memcpy" not in ev.name.lower()
          and "memset" not in ev.name.lower()]
    return sum(us) / 1e6 / reps if us else None


# -------------------------------------------------------------------- SASS

_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+0x([0-9a-f]+)")
_CONTROL = {"BRA", "EXIT", "BSSY", "BSYNC", "NOP", "WARPSYNC", "CALL", "RET",
            "BREAK", "YIELD", "DEPBAR"}
_MEMORY = {"LDS", "STS", "LDG", "STG", "LDL", "STL"}


def op_class(op):
    base = op.split(".")[0]
    if base in _CONTROL:
        return "control"
    if base == "BAR":
        return "bar"
    if base in _MEMORY:
        return base.lower()
    if base.startswith("U") or base in ("S2UR", "R2UR"):
        return "uniform"
    return "alu"


def _is_imad(op):
    return op.startswith("IMAD") and not op.startswith("IMAD.MOV")


def loops(body):
    """[(first, last)] address ranges of the backward branches of a
    function, the shortest first."""
    found = []
    for addr, ins in body:
        m = _BRA.search(ins)
        if m and int(m.group(1), 16) < addr:
            found.append((int(m.group(1), 16), addr))
    return sorted(found, key=lambda r: r[1] - r[0])


def _range(body, lo, hi):
    return [opcode(ins) for a, ins in body if lo <= a <= hi]


def _find(funcs, key):
    hits = [name for name in funcs if key in name]
    if len(hits) != 1:
        raise RuntimeError(f"SASS: {len(hits)} functions match {key!r}")
    return funcs[hits[0]]


def _innermost(body, pick):
    """The largest of the innermost loops of `body` (no loop inside them)
    whose opcodes satisfy `pick`."""
    spans = loops(body)
    hits = [s for s in spans
            if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                       for o in spans) and pick(_range(body, *s))]
    if not hits:
        raise RuntimeError("SASS: no loop of the expected shape")
    return hits[-1]


# the C = 1 instantiations of Mode kFull of csrc/ntt_ablation.cu and of
# csrc/ntt.cu's forward kernel
FULL_KERNEL = "ablate_ntt_kernelILi4ELi0EE"
SHIPPING_KERNEL = "ntt_fwd_kernelILi0EE"


def butterfly_census(funcs, kernel, n=N):
    """Instructions per butterfly of `kernel`'s butterfly loop, counted in
    its SASS: the largest innermost loop that holds Shoup products and
    shared-memory stores (the three-stage register pass of ntt_fwd_kernel
    and of `full`; a one-stage loop in a kernel of that shape). One IMAD.HI
    per butterfly. The barriers are those of the loop around it, where there
    is one."""
    body = _find(funcs, kernel)
    lo, hi = _innermost(body, lambda ops: any(o.startswith("IMAD.HI")
                                              for o in ops)
                        and "STS" in {o.split(".")[0] for o in ops})
    ops = _range(body, lo, hi)
    cls = Counter(op_class(o) for o in ops)
    bf = sum(o.startswith("IMAD.HI") for o in ops)
    stage = [s for s in loops(body) if s[0] < lo and hi < s[1]]
    bars = sum(op_class(o) == "bar" for o in _range(body, *stage[0])) \
        if stage else None
    logn = n.bit_length() - 1
    alu = cls["alu"] / bf
    return {"kernel": kernel, "butterflies_per_loop_body": bf,
            "instructions_per_butterfly": len(ops) / bf,
            "alu_per_butterfly": alu,
            "imad_per_butterfly": sum(map(_is_imad, ops)) / bf,
            "uniform_per_butterfly": cls["uniform"] / bf,
            "lds_per_butterfly": cls["lds"] / bf,
            "sts_per_butterfly": cls["sts"] / bf,
            "ldg_per_butterfly": cls["ldg"] / bf,
            "control_per_butterfly": cls["control"] / bf,
            "barriers_per_outer_loop": bars,
            "alu_per_element": alu * logn / 2,
            "loop_opcodes": dict(Counter(ops))}


def alu_chain_census(funcs):
    """Per chained iteration of each alu_chain kernel, from the SASS of its
    unrolled loop: IMAD-family instructions (the chain's arithmetic) and all
    instructions (loop control amortised over the unroll)."""
    out = {}
    for kind, want in (("mac", 1), ("shoup", 3)):
        body = _find(funcs, f"alu_{kind}_kernel")
        lo, hi = _innermost(body, lambda ops: any(map(_is_imad, ops)))
        ops = _range(body, lo, hi)
        imad = sum(map(_is_imad, ops)) / ALU_UNROLL
        out[kind] = {"ops_per_iter": imad,
                     "instructions_per_iter": len(ops) / ALU_UNROLL,
                     "expected_ops_per_iter": want,
                     "folded": imad < want,
                     "loop_opcodes": dict(Counter(ops))}
    return out


def census(n=N):
    """The SASS census of the built library: the butterfly loop of `full`
    (top-level keys, what `reconciled` reads), of ntt_fwd_kernel
    ("shipping", the same code) and both ALU chains."""
    funcs = sass_functions(_build.sass())
    return {**butterfly_census(funcs, FULL_KERNEL, n),
            "shipping": butterfly_census(funcs, SHIPPING_KERNEL, n),
            "alu_chain": alu_chain_census(funcs)}


# ---------------------------------------------------------------- the runs

def _row(step, x0, chain, bf_per_fwd):
    t, fixed = timed_per_iter(step, x0, chain)
    prof = profiled_s(step, x0)
    return {"us_per_fwd": t * 1e6,
            "fixed_dispatch_ms": fixed * 1e3,
            "Gbutterflies_per_s": bf_per_fwd / t / 1e9,
            "profiler_us_per_fwd": prof and prof * 1e6,
            "profiler_Gbutterflies_per_s": prof and bf_per_fwd / prof / 1e9}


def run(quick=False, chain=0, log=print):
    """The ablation (every mode, then the shipping transform), the ALU
    calibration, the census and the reconciled ceiling; returns the result
    dict, with `full_over_shipping` and `attribution_us` (the time each
    class of work adds to the floor)."""
    _require_cuda()
    dev = torch.device("cuda", 0)
    chain = chain or (64 if quick else 256)
    ctx, x0 = setup(dev)
    L = len(ctx.moduli)
    logn = N.bit_length() - 1
    bf_per_fwd = L * (N // 2) * logn
    out = {"device": torch.cuda.get_device_name(0), "n": N, "L": L,
           "chain": chain, "census": census(N)}
    for mode in na.MODES:
        out[mode] = _row(lambda v, m=mode: na.ablate_ntt(v, ctx, m), x0,
                         chain, bf_per_fwd)
        log(mode, json.dumps(out[mode]))
    out["shipping"] = _row(ctx.fwd, x0, chain, bf_per_fwd)
    log("shipping", json.dumps(out["shipping"]))
    out["full_over_shipping"] = out["full"]["us_per_fwd"] / \
        out["shipping"]["us_per_fwd"]
    floor = out["zero"]["us_per_fwd"]
    out["attribution_us"] = {
        "floor (zero)": floor,
        "data movement (rolls_only - zero)":
            out["rolls_only"]["us_per_fwd"] - floor,
        "products and twiddle loads (muls_only - zero)":
            out["muls_only"]["us_per_fwd"] - floor,
        "position arithmetic (masks_only - zero)":
            out["masks_only"]["us_per_fwd"] - floor,
        "the transform above the floor (full - zero)":
            out["full"]["us_per_fwd"] - floor}
    log("full_over_shipping", out["full_over_shipping"])

    # ALU calibration: [L, N/128, 128] words, ALU_ITERS chained per launch
    xa = x0.reshape(L, N // 128, 128)
    for kind in na.ALU_KINDS:
        step = lambda v, k=kind: na.alu_chain(v, k, ALU_ITERS)  # noqa: E731
        t, fixed = timed_per_iter(step, xa, chain)
        prof = profiled_s(step, xa)
        ops = out["census"]["alu_chain"][kind]["ops_per_iter"]
        iter_elems = L * N * ALU_ITERS
        out[f"alu_{kind}"] = {
            "iters": ALU_ITERS, "us_per_launch": t * 1e6,
            "fixed_dispatch_ms": fixed * 1e3,
            "profiler_us_per_launch": prof and prof * 1e6,
            "sustained_Giter_elems_s": iter_elems / t / 1e9,
            "sass_ops_per_iter": ops,
            "sustained_Gops_s": iter_elems * ops / t / 1e9}
        log(f"alu_{kind}", json.dumps(out[f"alu_{kind}"]))

    c = out["census"]
    full_bfs = out["full"]["Gbutterflies_per_s"] * 1e9
    achieved_alu = full_bfs * c["alu_per_butterfly"]
    ceiling = out["alu_shoup"]["sustained_Gops_s"] * 1e9
    out["reconciled"] = {
        "achieved_alu_Gops_s": achieved_alu / 1e9,
        "calibrated_ceiling_Gops_s": ceiling / 1e9,
        "pct_of_calibrated_alu_ceiling": 100 * achieved_alu / ceiling,
        "reconciled_sol_Gbutterflies_s":
            ceiling / c["alu_per_butterfly"] / 1e9,
        "pct_of_reconciled_sol":
            100 * full_bfs * c["alu_per_butterfly"] / ceiling,
    }
    return out


def batched(quick=False, log=print, device=None, n=N, batches=BATCHES):
    """`ntt_fwd` and `ntt_inv` at B in {1, 8, 16, 64}: median of 5 (3 with
    quick) two-point estimates per batch; returns the rows. On the first
    CUDA device unless the caller names a device (the CPU, at a small n and
    short chains, times the plain versions on the host clock)."""
    if device is None:
        _require_cuda()
        device = torch.device("cuda", 0)
    ctx, x0 = setup(torch.device(device), n)
    L = len(ctx.moduli)
    bf = L * (n // 2) * (n.bit_length() - 1)
    k_est = 3 if quick else 5
    log(json.dumps({"note": ONE_KERNEL}))
    rows = []
    for B, chain in batches:
        if quick:
            chain = max(2, chain // 4)
        xB = x0 if B == 1 else x0.expand(B, L, n).contiguous()
        row = {"B": B, "chain": chain}
        for name, step in (("ntt_fwd", ctx.fwd), ("ntt_inv", ctx.inv)):
            med, lo, hi, fixed = (t / B for t in estimates(
                lambda c, step=step: chain_of(step, c), xB, chain, k_est))
            row[name] = {"us_per_transform": med * 1e6,
                         "Gbf_s": bf / med / 1e9,
                         "spread_us": [lo * 1e6, hi * 1e6],
                         "fixed_dispatch_ms": fixed * B * 1e3}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chain", type=int, default=0)
    ap.add_argument("--batched", action="store_true",
                    help="run the batch sweep of ntt_fwd instead")
    args = ap.parse_args(argv)
    if args.batched:
        batched(args.quick)
        return 0
    print(json.dumps(run(args.quick, args.chain), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
