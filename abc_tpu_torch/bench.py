"""The measurement entry point of the port (after the top-level bench.py), on one
CUDA device:

    python -m abc_tpu_torch.bench [--device cuda|cpu] [--quick]
                                  [--suite N ...] [--out PATH]

It prints the full record as one JSON object on one line, then, as the last
line, one compact JSON object under 1500 characters:

  value              RNS-NTT butterflies/s at n=16384, L=14, B=1 (forward),
                     the median of K_EST two-point estimates with the least
                     and largest (utils/timing.py).
  batch curves       NTT Gbf/s, both directions (scripts/ntt_ablation.batched:
                     not timed a second way here), and BFV ct·ct multiply +
                     relinearization ops/s at n=8192, at B ∈ {1, 8, 16, 64}:
                     B independent ciphertexts [B, 2, L, n] through one
                     dependent chain v = multiply(v, y) in one CUDA graph.
  floor              the least time one mult+relin could take on the card,
                     from the parameters alone (`mult_relin_census`), and the
                     measured op as a share of it.
  suite              the six staged configs of abc_tpu_torch.benchsuite.

Everything runs in this process on `--device`: `cuda` (the default) raises
where there is no card, and nothing falls back to the CPU. `--device cpu`
runs the same code on the host at the sizes the caller gives (`--n`,
`--ntt-n`, `--batches`, `--chain`, `--k-est`), timed on the host clock and
labelled "timer": "host". No file is written unless `--out` names one. The
exit code is non-zero when a config of the suite failed or a correctness
field is false.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

N = 8192            # the mult+relin curve: BfvParams.create(8192, seed=123)
N_NTT = 16384       # the NTT curve: the 13 + 1 primes of create(16384, seed=5)
BATCHES = (1, 8, 16, 64)
CHAIN = 24          # dependent mult+relin steps per graph at B=1: one step
                    # is 33 graph nodes at k=1 (110 before the key-switch
                    # kernels, 385 before the BEHZ kernels, for which this
                    # length was chosen to keep a graph under 10 000)
CHAIN_MIN = 8       # and at least this many at larger B (CHAIN // B below it)
K_EST = 5           # independent two-point estimates; median, least, largest
NTT_CHAINS = {1: 2048, 8: 256, 16: 128, 64: 32}

# The card's rates for the floor, those of chip_smoke.py's bound: device
# memory (NVIDIA's data sheet for the H100 SXM) and 32-bit integer
# multiply-adds, 132 SMs x 64 per clock x 1.98 GHz.
HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
# Integer multiply-adds (or operations of the same pipe) per operation of
# the census: a Shoup butterfly or a product with a table constant is one
# high and two low products; a product of two variables is a 64-bit product
# (2), a Barrett quotient (2) and the remainder (1); an add or subtract
# carries its conditional correction.
IMAD_PER = {"butterfly": 3, "mul_table": 3, "mul_var": 5, "add": 2}


# ------------------------------------------------------------ the floor model

def mult_relin_census(n: int, L: int, k: int = 1) -> Dict:
    """The work of one BFV ct·ct multiply + relinearization (BEHZ multiply,
    hybrid key switch with digit size k), counted from the parameters alone:
    NTT limb rows, and per coefficient the modular products with a table
    constant (`mul_table`), of two variables (`mul_var`) and the modular
    adds (`add`) of each elementwise chain, as the algorithm needs them (one
    pass, constants folded), whatever kernels compute it. `bytes`: both
    operands, the relinearization key and the result, moved once."""
    K = L + 2                  # Bsk: L + 1 auxiliary primes and m_sk
    full = L + k               # q ∪ P
    alpha = -(-L // k)         # key-switch digits
    msd_rows = sum(L + s for s in range(k))
    chains = {
        # per operand component (4 of them): x·(m̃ q̂⁻¹); conversion to Bsk;
        # the residue mod m̃ with its factor; q·r, the sum and ·m̃⁻¹
        "to_bsk": {"times": 4,
                   "mul_table": L + L * K + (L + 1) + 2 * K,
                   "add": (L - 1) * K + L + 2 * K},
        # per base: 4 products and 1 add per limb
        "tensor": {"times": 1, "mul_var": 4 * (L + K), "add": L + K},
        # per product component (3): e·(t q̂⁻¹) over q, e·t over Bsk, the
        # conversion to Bsk, the difference and ·q⁻¹
        "fast_floor": {"times": 3,
                       "mul_table": L + K + L * K + K,
                       "add": (L - 1) * K + K},
        # per product component (3), Shenoy-Kumaresan: x·b̂⁻¹ over B, the
        # conversions to q and to m_sk, α, its centred reduction mod q, B·α
        # and the difference
        "from_bsk": {"times": 3,
                     "mul_table": (K - 1) + (K - 1) * L + (K - 1) + 1 + L,
                     "add": (K - 2) * L + (K - 2) + 1 + 3 * L},
        # the digit lift of c2 to q ∪ P: a conditional subtract at k=1, a
        # fast base conversion of each digit at k ≥ 2
        "decompose": ({"times": 1, "add": alpha * full} if k == 1 else
                      {"times": 1, "mul_table": L + alpha * k * full,
                       "add": alpha * (k - 1) * full}),
        # D·ksk_b and D·ksk_a summed over the digits
        "ks_inner": {"times": 1, "mul_var": 2 * alpha * full,
                     "add": 2 * (alpha - 1) * full},
        # per accumulator (2) and special prime: reduce, centre, subtract,
        # ·p⁻¹ over the remaining rows
        "mod_switch_down": {"times": 2, "mul_table": msd_rows,
                            "add": 3 * msd_rows},
        # c0 + k0, c1 + k1
        "relin_add": {"times": 1, "add": 2 * L},
    }
    per_coeff = {kind: sum(c["times"] * c.get(kind, 0)
                           for c in chains.values())
                 for kind in ("mul_table", "mul_var", "add")}
    fwd_rows = 4 * (L + K) + alpha * full
    inv_rows = 3 * (L + K) + 2 * full
    logn = n.bit_length() - 1
    return {"n": n, "L": L, "k": k,
            "ntt_rows": fwd_rows + inv_rows,
            "ntt_fwd_rows": fwd_rows, "ntt_inv_rows": inv_rows,
            "butterflies": (fwd_rows + inv_rows) * (n // 2) * logn,
            # the n⁻¹ scale of every inverse row
            "ntt_scale_products": inv_rows * n,
            "per_coefficient": per_coeff, "chains": chains,
            "bytes": 4 * n * (2 * 2 * L + 2 * alpha * full + 2 * L)}


def mult_relin_floor(census: Dict, ops_per_s: Dict) -> Dict:
    """The least time of one mult+relin on the card: the larger of the
    census's bytes over the memory rate and its integer operations over the
    integer rate; and the measured op (`ops_per_s`: {B: ops/s}) as a share
    of that floor, per batch size."""
    n, per = census["n"], census["per_coefficient"]
    imads = (IMAD_PER["butterfly"] * census["butterflies"]
             + IMAD_PER["mul_table"] * census["ntt_scale_products"]
             + n * sum(IMAD_PER[kind] * count for kind, count in per.items()))
    bytes_us = census["bytes"] / HBM_BYTES_S * 1e6
    ops_us = imads / IMAD_S * 1e6
    floor_us = max(bytes_us, ops_us)
    pct = {str(b): 100.0 * floor_us / (1e6 / v)
           for b, v in ops_per_s.items() if v and math.isfinite(v)}
    return {"ntt_rows": census["ntt_rows"],
            "integer_multiply_adds": imads, "bytes": census["bytes"],
            "bytes_floor_us": bytes_us, "operations_floor_us": ops_us,
            "floor_us": floor_us,
            "bound_by": "bytes" if bytes_us >= ops_us else "operations",
            "floor_ops_per_s": 1e6 / floor_us,
            "pct_of_floor": pct.get("1", float("nan")),
            "pct_of_floor_by_batch": pct,
            "model": "work counted from (n, L, k) alone (mult_relin_census); "
                     f"{HBM_BYTES_S / 1e12:.2f} TB/s, {IMAD_S / 1e12:.2f} T "
                     f"integer multiply-adds/s; per operation {IMAD_PER}"}


# ---------------------------------------------------------------- the curves

def mult_relin_curve(device, n: int = N, batches: Sequence[int] = BATCHES,
                     chain: int = CHAIN, k_est: int = K_EST) -> Dict:
    """{B: ops/s ...} of BFV mult+relin on B independent ciphertexts,
    [B, 2, L, n] (fresh encryptions from a seeded generator), through the
    dependent chain v = multiply(v, y); the chain length falls with B."""
    from abc_tpu_torch.benchsuite import chain_ops_per_s
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams

    dev = torch.device(device)
    ctx = BfvContext(BfvParams.create(n, seed=123), dev)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    b_max = max(batches)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 16, size=(2 * b_max, 4)).tolist()
    data = torch.stack([ct.data for ct in ctx.encrypt_many(
        [ctx.encode(v) for v in vals])])
    curve = {}
    for B in batches:
        x0 = data[0] if B == 1 else data[:B].contiguous()
        y = BfvCiphertext(data[b_max] if B == 1 else
                          data[b_max:b_max + B].contiguous())
        c = chain if B == 1 else max(min(CHAIN_MIN, chain), chain // B)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            allocated0 = torch.cuda.memory_allocated(dev)

        def step(x):
            return ctx.multiply(BfvCiphertext(x), y).data

        row = chain_ops_per_s(ctx, step, x0, c, k_est, census=(5, 3),
                              batch=B)
        row["ops_per_s"] = row.pop("value")
        del row["unit"]
        if dev.type == "cuda":
            # what the two graphs (c and c // 2 steps) and the eager
            # warm-up held at their peak, above the context and the inputs
            row["device_bytes"] = torch.cuda.max_memory_allocated(dev) - \
                allocated0
            gc.collect()
            torch.cuda.empty_cache()
        curve[str(B)] = row
    return {"n": n, "L": ctx.params.L, "k": ctx.params.ks_digits,
            "curve": curve}


def ntt_curve(device, n: int = N_NTT, batches: Sequence[int] = BATCHES,
              quick: bool = False, chains: Dict[int, int] = NTT_CHAINS
              ) -> Dict:
    """The NTT batch curve, both directions, as scripts/ntt_ablation.batched
    measures it: {"rows": L, "curve": {B: {"ntt_fwd": ..., "ntt_inv": ...}}}."""
    from abc_tpu_torch.scripts import ntt_ablation

    rows = ntt_ablation.batched(
        quick=quick, log=lambda *a: None, device=device, n=n,
        batches=tuple((B, chains.get(B, 32)) for B in batches))
    L = len(ntt_ablation.BfvParams.create(n, seed=5).coeff_modulus)
    return {"n": n, "rows": L,
            "curve": {str(r["B"]): {k: v for k, v in r.items() if k != "B"}
                      for r in rows}}


def card(device) -> Dict:
    """The device the numbers belong to: on a CUDA device its name and power
    limit as nvidia-smi gives them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi[dev.index or 0]}


# ------------------------------------------------------------------ the lines

def _compact_suite(suite):
    """Digest the staged-suite dict down to config → headline value."""
    if not isinstance(suite, dict):
        return "suite failed"
    digest = {}
    for k, v in sorted(suite.items()):
        if not isinstance(v, dict):
            continue
        entry = {"value": _rnd(v.get("value")), "unit": v.get("unit", "")[:48]}
        if "error" in v:
            entry["error"] = str(v["error"])[:60]
        if "csv_schema" in v:
            entry["csv"] = {name: _rnd(t)
                            for name, t in v["csv_schema"].items()}
        digest[k] = entry
    return digest


def _rnd(v, digits=3):
    return round(v, digits) if isinstance(v, float) and math.isfinite(v) \
        else v


def problems(full: Dict) -> List[str]:
    """What makes a run a failed run: a config that raised, a correctness
    field that is false."""
    out = []
    for name, rec in sorted(full["suite"].items()):
        if "error" in rec:
            out.append(f"{name}: {rec['error']}")
        if rec.get("correct") is False:
            out.append(f"{name}: correct is false")
        if rec.get("measured", {}).get("decrypt_equal") is False:
            out.append(f"{name}: decrypt_equal is false")
    return out


def nan_headlines(full: Dict) -> List[str]:
    """The headline values of a record that are nan (a measurement in which
    no two-point pair was valid)."""
    values = {"headline_ntt": full["headline_ntt"]["value"]}
    for b, row in full["headline_ntt"]["batch_curve"].items():
        for name in ("ntt_fwd", "ntt_inv"):
            values[f"{name} B={b}"] = row[name]["Gbf_s"]
    for b, row in full["mult_relin"]["batch_curve"].items():
        values[f"mult_relin B={b}"] = row["ops_per_s"]
    values["pct_of_floor"] = full["mult_relin"]["speed_of_light"][
        "pct_of_floor"]
    for name, rec in full["suite"].items():
        if "error" not in rec:
            values[name] = rec["value"]
    return sorted(k for k, v in values.items()
                  if isinstance(v, float) and math.isnan(v))


def compact_line(full: Dict) -> str:
    ntt, mult = full["headline_ntt"], full["mult_relin"]
    line = {
        "metric": ntt["metric"], "value": _rnd(ntt["value"]),
        "unit": ntt["unit"],
        "spread": [_rnd(v, 2) for v in ntt["spread_Gbf_s"]],
        "ntt_fwd_Gbf_s_by_batch": {b: _rnd(v["ntt_fwd"]["Gbf_s"], 1)
                                   for b, v in ntt["batch_curve"].items()},
        "ntt_inv_Gbf_s_by_batch": {b: _rnd(v["ntt_inv"]["Gbf_s"], 1)
                                   for b, v in ntt["batch_curve"].items()},
        "mult_relin_ops_s_by_batch": {b: _rnd(v["ops_per_s"], 1)
                                      for b, v in
                                      mult["batch_curve"].items()},
        # what cancelled in the two-point pairs (the graph launch and the
        # timer): a fixed part far above the steps' difference would make
        # that difference unsteady
        "mult_relin_fixed_ms_by_batch": {b: _rnd(v["fixed_ms"])
                                         for b, v in
                                         mult["batch_curve"].items()},
        "mult_relin_floor_us": _rnd(mult["speed_of_light"]["floor_us"]),
        "mult_relin_pct_of_floor": _rnd(
            mult["speed_of_light"]["pct_of_floor"]),
        "suite": _compact_suite(full["suite"]),
        "card": full["device"]["nvidia_smi"] or "cpu",
        "timer": full["timer"],
        "ok": not full["problems"],
    }
    out = json.dumps(line)
    if len(out) > 1500:     # the suite digest is in the full record
        line["suite"] = "see the full record, one line up"
        out = json.dumps(line)
    return out


def run(args) -> Dict:
    """The whole measurement; returns the full record."""
    from abc_tpu_torch.benchsuite import require_device, run_suite_dict

    dev = require_device(args.device)
    batches = tuple(args.batches)
    k_est = args.k_est or (3 if args.quick else K_EST)
    chain = args.chain or (CHAIN // 2 if args.quick else CHAIN)
    ntt = ntt_curve(dev, args.ntt_n, batches, args.quick,
                    {b: args.ntt_chain for b in batches} if args.ntt_chain
                    else NTT_CHAINS)
    mult = mult_relin_curve(dev, args.n, batches, chain, k_est)
    census = mult_relin_census(args.n, mult["L"], mult["k"])
    suite = run_suite_dict(args.suite, fast=True, device=dev,
                           quick=args.quick)

    n1 = ntt["curve"][str(batches[0])]["ntt_fwd"]
    best_b, best = max(ntt["curve"].items(),
                       key=lambda kv: kv[1]["ntt_fwd"]["Gbf_s"])
    ops = {b: row["ops_per_s"] for b, row in mult["curve"].items()}
    mbest_b = max(ops, key=lambda b: ops[b] if math.isfinite(ops[b]) else -1)
    bf = ntt["rows"] * (args.ntt_n // 2) * (args.ntt_n.bit_length() - 1)
    info = card(dev)
    full = {
        "device": info,
        "timer": "cuda_graph" if dev.type == "cuda" else "host",
        "timing_protocol": f"median of {k_est} two-point chain estimates, "
                           "least and largest beside it",
        "headline_ntt": {
            "metric": f"rns_ntt_butterflies_per_s_n{args.ntt_n}"
                      f"_L{ntt['rows']} ({info['kind']})",
            "value": n1["Gbf_s"], "unit": "Gbutterflies/s",
            # the least and largest estimate, as rates
            "spread_Gbf_s": [bf / (us * 1e-6) / 1e9
                             for us in reversed(n1["spread_us"])],
            "batch_curve": ntt["curve"],
            "best_batched": {"B": best_b,
                             "Gbf_s": best["ntt_fwd"]["Gbf_s"]},
        },
        "mult_relin": {
            "metric": f"bfv_n{args.n}_ct_mult_relin ({info['kind']})",
            "batch_curve": mult["curve"],
            "single_ct_ops_per_s": ops[str(batches[0])],
            "best_batched": {"B": mbest_b, "ops_per_s": ops[mbest_b]},
            "speed_of_light": mult_relin_floor(census, ops),
            "census": census,
        },
        "suite": suite,
    }
    full["problems"] = problems(full)
    full["nan_headlines"] = nan_headlines(full)
    return full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m abc_tpu_torch.bench",
        description="NTT and BFV mult+relin batch curves, the mult+relin "
                    "floor and the staged suite on one CUDA device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda without a GPU is an error; cpu runs the same "
                         "code on the host clock, at the sizes given below")
    ap.add_argument("--quick", action="store_true",
                    help="shorter chains, 3 estimates, fewer repeats")
    ap.add_argument("--suite", type=int, nargs="*", default=None,
                    metavar="N", help="the staged configs to run (all six "
                                      "when not given)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the full record there")
    ap.add_argument("--n", type=int, default=N,
                    help="ring degree of the mult+relin curve")
    ap.add_argument("--ntt-n", type=int, default=N_NTT,
                    help="ring degree of the NTT curve")
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--chain", type=int, default=0,
                    help="mult+relin steps per chain at B=1")
    ap.add_argument("--ntt-chain", type=int, default=0,
                    help="transforms per chain at every B")
    ap.add_argument("--k-est", type=int, default=0)
    args = ap.parse_args(argv)

    full = run(args)
    record = json.dumps(full)
    if args.out:
        with open(args.out, "w") as f:
            f.write(record + "\n")
    print(record, flush=True)
    print(compact_line(full), flush=True)
    for what in full["problems"]:
        print(f"bench: {what}", file=sys.stderr)
    return 1 if full["problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
