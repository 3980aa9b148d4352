"""Count the bytes that the elementwise torch ops of one BFV mult+relin read
and write, from shapes alone (a CPU run: nothing here is a device time).

    python -m abc_tpu_torch.scripts.op_traffic [--n 8192] [--batch 1 8]

The evaluation runs once on CPU tensors under a dispatch hook that adds up,
for every torch op that makes a new tensor, the bytes of its outputs and of
its inputs (an input broadcast over the output counts at most the output's
elements). Views are free. The NTT is left out (its kernels are the card's,
the CPU stage loop is not what runs there): a transform counts as one read
and one write of its rows. The sum is what the unfused chains of
ops/modarith.py ask of device memory per op, to hold against the bytes a
fused kernel must move (bench.mult_relin_census: operands, key and result).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import abc_tpu_torch.crypto.ntt as ntt_module
from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.params import BfvParams

_VIEWS = ("view", "reshape", "expand", "slice", "select.int", "unsqueeze",
          "alias", "detach", "t.default")


class ByteCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not outs or ("index_select" not in name
                        and any(v in name for v in _VIEWS)):
            return out
        widest = max(t.numel() for t in outs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in outs) + sum(
            min(t.numel(), widest) * t.element_size() for t in ins)
        self.ops += 1
        return out


def count(n=8192, batches=(1,), ks_digits=1):
    ctx = BfvContext(BfvParams.create(n, seed=123, ks_digits=ks_digits),
                     "cpu")
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a, b = ctx.encrypt_many([ctx.encode([1, 2, 3, 4]),
                             ctx.encode([5, 6, 7, 8])])
    saved = ntt_module.ntt_fwd, ntt_module.ntt_inv
    ntt_module.ntt_fwd = ntt_module.ntt_inv = lambda x, *tables: x.clone()
    rows = {}
    try:
        for B in batches:
            x = a.data if B == 1 else torch.stack([a.data] * B)
            y = b.data if B == 1 else torch.stack([b.data] * B)
            with ctx.fresh_caches(), ByteCount() as counted:
                ctx.multiply(BfvCiphertext(x), BfvCiphertext(y))
            rows[str(B)] = {"torch_ops": counted.ops,
                            "bytes_per_step": counted.bytes,
                            "bytes_per_op": counted.bytes / B}
    finally:
        ntt_module.ntt_fwd, ntt_module.ntt_inv = saved
    return {"n": n, "L": ctx.params.L, "k": ks_digits, "by_batch": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--ks-digits", type=int, default=1)
    args = ap.parse_args(argv)
    print(json.dumps(count(args.n, tuple(args.batch), args.ks_digits)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
