"""Carry a reference BFV context's state onto a torch device.

`context_from_reference` is the FHE counterpart of converting a model's
weights: it takes an `abc_tpu` np64 `BfvContext` and returns the port's
`BfvContext` with the secret key (NTT form over q∪P), the public key, every
switching key built so far and the reference's scalar tables copied to the
device as int32. The host half (keygen, encode/decode, encrypt/decrypt) stays
on the reference context. Both sides then compute the same words, which is
how the tests hold the port against the reference.
"""

from __future__ import annotations

import torch

from abc_tpu_torch.crypto.bfv import BfvContext


def context_from_reference(ref_ctx, device) -> BfvContext:
    """The port's BfvContext on `device` for an abc_tpu np64 BfvContext."""
    if ref_ctx.params.engine != "np64":
        raise ValueError("context_from_reference takes an np64 BfvContext "
                         f"(host keys and tables), got engine "
                         f"{ref_ctx.params.engine!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           "available")
    return BfvContext(ref_ctx, device)
