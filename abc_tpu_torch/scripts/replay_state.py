"""Probe: does the time of a latency-bound CUDA graph depend on what the
process did before it was captured?

    python -m abc_tpu_torch.scripts.replay_state

The BFV mult+relin at n=8192 is 33 small kernels; as a chain of 12 steps in
one CUDA graph its time per step is set by kernel-to-kernel latency, not by
bytes or arithmetic. The measurement entry point (abc_tpu_torch.bench) read
that time at two and three distinct levels within one process and between
processes. This script captures the same chain again and again, each time
after changing one thing about the process, and prints ms per step with the
SM and memory clocks read while the card is busy: a fresh process; device
memory allocated but untouched; the same memory written once; freed again;
many small live tensors; other graphs alive. One JSON object per line.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys

import torch

from abc_tpu_torch.benchsuite import require_device, whole_op_chain
from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.utils.timing import graph_of, replay_s

CHAIN = 12
BIG_BYTES = 20 << 30


def smi(fields="clocks.sm,clocks.mem,power.draw,clocks_throttle_reasons."
        "active"):
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    dev = require_device("cuda")
    ctx = BfvContext(BfvParams.create(8192, seed=123), dev)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a, b = ctx.encrypt_many([ctx.encode([1, 2, 3, 4]),
                             ctx.encode([5, 6, 7, 8])])
    y = BfvCiphertext(b.data)
    make_chain = whole_op_chain(
        ctx, lambda x: ctx.multiply(BfvCiphertext(x), y).data, (5, 3))
    make_chain(1)(a.data)
    torch.cuda.synchronize()
    print(json.dumps({"card": smi("name,power.limit")}), flush=True)

    def measure(what):
        g = graph_of(make_chain(CHAIN), a.data)
        ms = [replay_s(g) / CHAIN * 1e3 for _ in range(3)]
        for _ in range(40):         # keep the card busy while it is read
            g.replay()
        busy = smi()
        torch.cuda.synchronize()
        print(json.dumps({
            "after": what, "ms_per_step": ms, "under_load": busy,
            "reserved_MiB": torch.cuda.memory_reserved() >> 20,
            "allocated_MiB": torch.cuda.memory_allocated() >> 20}),
            flush=True)

    def drop():
        gc.collect()
        torch.cuda.empty_cache()

    measure("a fresh process")
    measure("nothing (again)")
    big = torch.empty(BIG_BYTES, dtype=torch.uint8, device=dev)
    measure("20 GiB allocated, untouched")
    big.fill_(1)
    torch.cuda.synchronize()
    measure("those 20 GiB written once")
    del big
    drop()
    measure("the 20 GiB freed, allocator cache emptied")
    small = [torch.empty(3 << 20, dtype=torch.uint8, device=dev)
             for _ in range(400)]
    measure("400 tensors of 3 MiB alive")
    del small
    drop()
    measure("those freed, allocator cache emptied")
    others = [graph_of(make_chain(CHAIN), a.data) for _ in range(4)]
    measure("4 other graphs of the same chain alive")
    del others
    drop()
    measure("those graphs deleted, allocator cache emptied")
    return 0


if __name__ == "__main__":
    sys.exit(main())
