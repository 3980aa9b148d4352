"""Hybrid key-switch A/B for BFV mult+relin at n=8192 on one CUDA device (port
of scripts/hybrid_ks_ab.py).

At ks_digits=1 the relinearization's digit lift is L·(L+1) = 42 of the op's
154 NTT rows. Hybrid digits (k=2: α=3 digit rows over L+2 columns) cut it to
3·8 = 24 rows at the price of one more special prime in every other row (L+2
against L+1 columns) and a second mod-switch division. This script measures
both variants in one process with the package's timer (utils/timing.py):
two-point estimates of dependent chains, the two variants taking turns, the
median of K_EST per variant with the least and largest.

Note: k=2 at n=8192 uses 8 30-bit moduli = 240 bits, over the 218-bit
HE-standard budget (a measurement of the kernel-shape question; a production
k=2 chain would drop one data limb).

    python -m abc_tpu_torch.scripts.hybrid_ks_ab            # on the card
    python -m abc_tpu_torch.scripts.hybrid_ks_ab --device cpu --n 1024 --chain 2

Needs a CUDA device unless --device cpu is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

from abc_tpu_torch.benchsuite import device_label, require_device, \
    whole_op_chain
from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.utils.timing import (chain_timers, summary, timer_of,
                                        valid_pairs)

N = 8192
CHAIN = 16          # k=2 is 33 graph nodes per step (188 before the
                    # key-switch kernels, 463 before the BEHZ kernels):
                    # under 10 000 a graph
K_EST = 5
# forward and inverse NTT launches of one mult+relin: the same at both k
CENSUS = (5, 3)


def run(device="cuda", n=N, chain=CHAIN, k_est=K_EST, log=print):
    """{"k1": {...}, "k2": {...}, "hybrid_k2_speedup_over_k1": r}: per
    variant the median ops/s of k_est two-point estimates taken in turns
    (nan where no pair of a variant was valid)."""
    dev = require_device(device)
    timers = {}
    for k in (1, 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # k=2 is over budget (above)
            ctx = BfvContext(BfvParams.create(n, seed=123, ks_digits=k), dev)
        ctx.ensure_eval_ready()
        ctx.get_relin_key()
        a, b = ctx.encrypt_many([ctx.encode([1, 2, 3, 4]),
                                 ctx.encode([5, 6, 7, 8])])
        got = ctx.decode(ctx.decrypt(ctx.multiply(a, b)))[:4]
        assert got == [5, 12, 21, 32], f"k={k} correctness: {got}"
        y = BfvCiphertext(b.data)
        timers[k] = chain_timers(whole_op_chain(
            ctx, lambda x, ctx=ctx, y=y: ctx.multiply(BfvCiphertext(x),
                                                      y).data, CENSUS),
            a.data, chain)
    # Both variants' graphs stay alive and are replayed in turns, one pair
    # each: each graph holds the tensors it reads (utils/timing.graph_of).
    pairs = {1: [], 2: []}
    for _ in range(3 * k_est):
        for k in (1, 2):
            if len(pairs[k]) < k_est:
                pairs[k] += valid_pairs(timers[k], chain, 1, attempts=1)
    out = {"device": device_label(dev), "n": n, "chain": chain,
           "k_est": k_est, "timer": timer_of(a.data)}
    for k in (1, 2):
        med, lo, hi, _ = summary(pairs[k])
        out[f"k{k}"] = {"ops_per_s": 1 / med, "ops_per_s_min": 1 / hi,
                        "ops_per_s_max": 1 / lo, "ms_per_op": med * 1e3,
                        "estimates": len(pairs[k])}
        log(f"ks_digits={k}: {1 / med:.1f} ops/s [{1 / hi:.1f}-{1 / lo:.1f}]")
    out["hybrid_k2_speedup_over_k1"] = out["k1"]["ms_per_op"] / \
        out["k2"]["ms_per_op"]
    log(f"hybrid_k2_speedup_over_k1: {out['hybrid_k2_speedup_over_k1']:.3f}x "
        f"on {out['device']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--k-est", type=int, default=K_EST)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n, args.chain, args.k_est)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
