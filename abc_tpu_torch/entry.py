"""Entry point of the flagship workload (after the reference's
__graft_entry__.py): BFV n=8192 ct·ct multiply + relinearization
(benchsuite config 2) as a function of tensors on one device.

    fn, example_args = entry()          # on the card; raises without one
    out = fn(*example_args)             # [2, L, n] int32 ciphertext words

The reference's second entry point, `dryrun_multichip(n)`, builds a mesh of n
shards and runs the sharded step, the compiled hamming workload and the
coefficient-sharded CKKS multiply on it, at small and at production shapes
(parallel/dryrun.py). Here the n shards live on one card (parallel/mesh.py:
LocalComm), as the reference's n virtual devices lived on one host:

    python -m abc_tpu_torch.entry dryrun [n]     # on the card; n = 8
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def entry(device="cuda") -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (fn, example_args): fn(ct_a, ct_b) -> ct_out data tensors on
    `device`, each [2, L, n] int32 (or [B, 2, L, n]: B independent
    ciphertexts). Keys, the BEHZ tables and, on a CUDA device, the kernel
    library are made here, so fn itself only evaluates: it can be captured
    in a CUDA graph as it is, inside `ctx.fresh_caches()` if the same tensors
    will hold new contents from run to run. A CUDA device that is not there
    raises."""
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams

    ctx = BfvContext(BfvParams.create(8192, seed=123), device)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a, b = ctx.encrypt_many([ctx.encode([1, 2, 3, 4]),
                             ctx.encode([5, 6, 7, 8])])

    def fn(ct_a, ct_b):
        # the operand transforms are not cached across calls: the caller's
        # tensors may hold new words under the same identity
        with ctx.fresh_caches():
            return ctx.multiply(BfvCiphertext(ct_a), BfvCiphertext(ct_b)).data

    fn.context = ctx
    return fn, (a.data, b.data)


def dryrun_multichip(n_devices: int) -> dict:
    """parallel.dryrun.run_dryrun on a mesh of n_devices shards of the card
    (LocalComm), production shapes included; returns its report. There is
    no CPU fallback: without a CUDA device it raises."""
    from abc_tpu_torch.parallel.dryrun import run_dryrun

    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on a CUDA device; none is "
                           "available")
    return run_dryrun(n_devices, device="cuda")


if __name__ == "__main__":
    import sys

    from abc_tpu_torch.crypto.bfv import BfvCiphertext

    if sys.argv[1:2] == ["dryrun"]:
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
        sys.exit(0)
    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    out = fn(*args)
    ctx = fn.context
    print("entry() ran:", tuple(out.shape), out.dtype, out.device,
          "decrypts", ctx.decode(ctx.decrypt(BfvCiphertext(out)))[:4])
