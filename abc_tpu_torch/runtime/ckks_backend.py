"""CKKS runtime backend on torch (port of abc_tpu/runtime/ckks_backend.py):
approximate (float) arithmetic behind the same AbstractCiphertextFactory
interface.

float/double DSL programs execute encrypted: Cleartext<float/double> values
encode through the canonical embedding, and the executor's op dispatch maps
onto leveled CKKS multiply/rescale. The factory builds a CkksContext from
(n, levels, seed, scale_bits) on `device`, or takes a pre-built one; as with
BFV the caller names the device, and a CUDA device without a GPU is an
error.

Plaintext operands are ENCRYPTIONS here (encrypt-and-operate, as in the
reference): host draws from the context's generator, then a copy to the
device. Under whole-program capture they go onto the HostConstants tape
(runtime/host_constants.py), keyed by values, level and scale.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from abc_tpu_torch.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
from abc_tpu_torch.runtime.host_constants import TapedFactory, zero_pad
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.errors import RuntimeExecutionError


class TorchCkksCiphertext(AbstractCiphertext):
    """Ciphertext handle with LAZY relinearization and rescale (the CKKS
    analogue of the BFV runtime's deferred key switch,
    runtime/bfv_backend.py): multiply returns the raw size-3 product at the
    composed scale; size-3 ciphertexts flow through add/sub (zero-padded)
    and plaintext ops (plaintexts encode at the operand's CURRENT scale),
    and decrypt reads c0 + c1·s + c2·s² directly — so a sum of k products
    costs 0 relins and 0 rescales instead of k each. The key switch and the
    level-dropping rescale fire only when a later multiply needs a
    size-2, base-scale operand; rotations relinearize but keep the scale
    (rotate-reduce over products stays at the product scale)."""

    __slots__ = ("ct", "factory")

    def __init__(self, ct: CkksCiphertext, factory: "CkksCiphertextFactory"):
        self.ct = ct
        self.factory = factory

    def _ctx(self) -> CkksContext:
        return self.factory.context

    def _wrap(self, ct):
        return TorchCkksCiphertext(ct, self.factory)

    def _relin(self) -> CkksCiphertext:
        """Size-2 form (deferred key switch if this is a raw product)."""
        return self._ctx().relinearize(self.ct)

    def _mult_ready(self) -> CkksCiphertext:
        """Size-2 AND base-scale form: relinearize, then rescale down any
        composed (product) scale so the next multiply starts clean."""
        ct = self._relin()
        base = self.factory.params.scale
        while ct.scale > base * 1.5 and ct.level > 1:
            ct = self._ctx().rescale(ct)
        return ct

    def _aligned(self, other):
        a, b = self.ct, other.ct
        if a.data.shape[0] < b.data.shape[0]:
            a = CkksCiphertext(zero_pad(a.data, b.data.shape[0]),
                               a.level, a.scale)
        elif b.data.shape[0] < a.data.shape[0]:
            b = CkksCiphertext(zero_pad(b.data, a.data.shape[0]),
                               b.level, b.scale)
        return a, b

    # ctxt ⊕ ctxt
    def add(self, other):
        a, b = self._aligned(other)
        return self._wrap(self._ctx().add(a, b))

    def subtract(self, other):
        a, b = self._aligned(other)
        return self._wrap(self._ctx().sub(a, b))

    def multiply(self, other):
        a = self._mult_ready()
        b = other._mult_ready() if other is not self else a
        return self._wrap(self._ctx().multiply(
            a, b, relinearize=False, rescale=False))

    # ctxt ⊕ plain — encrypt-and-operate keeps the implementation small.
    # Plaintexts encode at the operand's CURRENT scale so deferred-rescale
    # products stay addable.
    def _enc(self, cleartext: Cleartext, level: int,
             scale: float) -> CkksCiphertext:
        return self.factory._encrypt_values(cleartext.values, level,
                                            scale=scale)

    def add_plain(self, other):
        p = self._wrap(self._enc(other, self.ct.level, self.ct.scale))
        return self.add(p)

    def subtract_plain(self, other):
        p = self._wrap(self._enc(other, self.ct.level, self.ct.scale))
        return self.subtract(p)

    def subtract_from_plain(self, other):
        p = self._wrap(self._enc(other, self.ct.level, self.ct.scale))
        return p.subtract(self)

    def multiply_plain(self, other):
        a = self._mult_ready()
        p = self._enc(other, a.level, self.factory.params.scale)
        return self._wrap(self._ctx().multiply(
            a, p, relinearize=False, rescale=False))

    def rotate_rows(self, steps: int):
        return self._wrap(self._ctx().rotate(self._relin(), steps))

    def clone(self):
        return TorchCkksCiphertext(self.ct, self.factory)

    @property
    def level(self) -> int:
        return self.ct.level


class CkksCiphertextFactory(TapedFactory):
    """Factory for approximate arithmetic, evaluating on `device`; slot
    count = n/2. Hybrid digits (ks_digits > 1) come with a pre-built
    context, as in the reference."""

    def __init__(self, n: int = 2048, levels: int = 3,
                 seed: Optional[int] = None, scale_bits: int = 25,
                 context: Optional[CkksContext] = None, device="cuda"):
        """context: a pre-built CkksContext (e.g. of auto-chosen per-circuit
        parameters, crypto/noise.py choose_ckks_parameters); the other
        arguments are then not read."""
        super().__init__()
        if context is not None:
            self.context = context
            self.params = context.params
            return
        self.params = CkksParams.create(n, levels=levels, seed=seed,
                                        scale_bits=scale_bits)
        self.context = CkksContext(self.params, device)

    @property
    def slot_count(self) -> int:
        return self.params.slot_count

    def _encrypt_values(self, values: Sequence[float], level: Optional[int],
                        scale: Optional[float] = None) -> CkksCiphertext:
        vals = [float(v) for v in values]

        def make():
            ctx = self.context
            full = ctx.encrypt(ctx.encode(self.expand_vector(vals),
                                          scale=scale))
            if level is not None and level < full.level:
                return ctx.mod_drop_to(full, level)
            return full

        return self._host_made(("encrypt", tuple(vals), level, scale), make)

    def create_ciphertext(self, value: Union[Cleartext, Sequence, float]
                          ) -> TorchCkksCiphertext:
        if isinstance(value, Cleartext):
            vals = value.values
        elif isinstance(value, (int, float)):
            vals = [value]
        else:
            vals = list(value)
        return TorchCkksCiphertext(self._encrypt_values(vals, None), self)

    def create_many(self, values: Sequence) -> List[TorchCkksCiphertext]:
        """Encrypt a batch of inputs, one after the other in the order given
        (the generator's draws are per ciphertext)."""
        return [self.create_ciphertext(v) for v in values]

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[float]:
        if not isinstance(ciphertext, TorchCkksCiphertext):
            raise RuntimeExecutionError(
                "CkksCiphertextFactory can only decrypt its own ciphertexts")
        z = self.context.decode(self.context.decrypt(ciphertext.ct))
        return [float(v) for v in np.real(z)]

    # --- whole-program protocol (runtime/jit_executor.py) -------------------
    def jit_pack(self, handle: TorchCkksCiphertext):
        """(device tensor, static metadata): CKKS carries (level, scale) as
        capture-time constants alongside the RNS tensor."""
        return handle.ct.data, (handle.ct.level, handle.ct.scale)

    def jit_unpack(self, tensor: torch.Tensor, meta) -> TorchCkksCiphertext:
        level, scale = meta
        return TorchCkksCiphertext(CkksCiphertext(tensor, level, scale), self)
