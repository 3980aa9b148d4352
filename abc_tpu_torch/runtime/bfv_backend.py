"""BFV runtime backend on torch (port of abc_tpu/runtime/bfv_backend.py).

The factory plugs into RuntimeVisitor / run_compiled like abc_tpu's
BfvCiphertextFactory. It builds a BfvContext from (slots, seed, ks_digits)
on `device`: keys, encryption, evaluation and decryption all run there.
There is no backend sniffing: the caller names the device, and a CUDA
device without a GPU is an error.

A program's evaluation meets two kinds of values that are made on the host
and copied to the device: plaintext operands (encode_cleartext) and
encryptions inside the program (`secret int v = 0;`). Under jax.jit these are
trace constants. A CUDA graph cannot hold a host copy, so the whole-program
executor records them from one eager run and serves them again, in the same
order, to the run it captures: HostConstants, switched on with
`factory.host_constants(tape)` (runtime/host_constants.py, shared with the
CKKS factory).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext, Plaintext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.runtime.host_constants import TapedFactory, zero_pad
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.errors import RuntimeExecutionError


class TorchBfvCiphertext(AbstractCiphertext):
    """Ciphertext handle dispatching to the BFV context (pure ops).

    Relinearization is lazy, as in the reference: multiply returns the raw
    size-3 product; size-3 ciphertexts flow through add/subtract (the
    shorter operand is zero-padded) and plaintext ops, and decrypt reads them
    directly. The key switch runs only when a rotation or a ciphertext
    multiply needs a size-2 operand."""

    __slots__ = ("ct", "factory")

    def __init__(self, ct: BfvCiphertext, factory: "BfvCiphertextFactory"):
        self.ct = ct
        self.factory = factory

    def _ctx(self) -> BfvContext:
        return self.factory.context

    def _relin(self) -> BfvCiphertext:
        """The size-2 form of this ciphertext (key switch if deferred)."""
        return self._ctx().relinearize(self.ct)

    def _aligned(self, other) -> tuple:
        a, b = self.ct.data, other.ct.data
        if a.shape[0] < b.shape[0]:
            a = zero_pad(a, b.shape[0])
        elif b.shape[0] < a.shape[0]:
            b = zero_pad(b, a.shape[0])
        return BfvCiphertext(a), BfvCiphertext(b)

    def _wrap(self, ct: BfvCiphertext) -> "TorchBfvCiphertext":
        return TorchBfvCiphertext(ct, self.factory)

    def add(self, other):
        return self._wrap(self._ctx().add(*self._aligned(other)))

    def subtract(self, other):
        return self._wrap(self._ctx().sub(*self._aligned(other)))

    def multiply(self, other):
        a = self._relin()
        if other is self:
            return self._wrap(self._ctx().square(a, relinearize=False))
        return self._wrap(
            self._ctx().multiply(a, other._relin(), relinearize=False))

    # ctxt ⊕ plain
    def _encode(self, cleartext: Cleartext) -> Plaintext:
        return self.factory.encode_cleartext(cleartext)

    def add_plain(self, other):
        return self._wrap(self._ctx().add_plain(self.ct, self._encode(other)))

    def subtract_plain(self, other):
        return self._wrap(self._ctx().sub_plain(self.ct, self._encode(other)))

    def subtract_from_plain(self, other):
        return self._wrap(
            self._ctx().sub_from_plain(self.ct, self._encode(other)))

    def multiply_plain(self, other):
        return self._wrap(
            self._ctx().multiply_plain(self.ct, self._encode(other)))

    def rotate_rows(self, steps: int):
        return self._wrap(self._ctx().rotate_rows(self._relin(), steps))

    def rotate_columns(self):
        return self._wrap(self._ctx().rotate_columns(self._relin()))

    def clone(self):
        return TorchBfvCiphertext(self.ct, self.factory)  # immutable: share

    def noise_bits(self) -> int:
        return self._ctx().noise_budget(self.ct)


class BfvCiphertextFactory(TapedFactory):
    """Factory owning the BFV context + keys, evaluating on `device`."""

    def __init__(self, slots: int = 8192, seed: int = None,
                 ks_digits: int = 1, device="cuda", plain_bits: int = 20,
                 context: Optional[BfvContext] = None):
        """context: a pre-built BfvContext (e.g. of auto-chosen parameters);
        the other arguments are then not read."""
        super().__init__()
        if context is not None:
            self.context = context
            self.params = context.params
            return
        self.params = BfvParams.create(slots, seed=seed, ks_digits=ks_digits,
                                       plain_bits=plain_bits)
        self.context = BfvContext(self.params, device)

    @property
    def slot_count(self) -> int:
        return self.params.slot_count

    def encode_cleartext(self, cleartext: Cleartext) -> Plaintext:
        """Cleartext → plaintext with last-element padding to all slots."""
        vals = [int(v) for v in cleartext.values]
        return self._host_made(
            ("encode", tuple(vals)),
            lambda: self.context.encode(self.expand_vector(vals)))

    def create_ciphertext(self, value: Union[Cleartext, Sequence[int], int]
                          ) -> TorchBfvCiphertext:
        return self.create_many([value])[0]

    def create_many(self, values: Sequence) -> List[TorchBfvCiphertext]:
        """Encrypt a batch of inputs in one batched device pass."""
        rows = []
        for value in values:
            if isinstance(value, Cleartext):
                rows.append(tuple(int(v) for v in value.values))
            elif isinstance(value, int):
                rows.append((int(value),))
            else:
                rows.append(tuple(int(v) for v in value))
        cts = self._host_made(
            ("encrypt", tuple(rows)),
            lambda: self.context.encrypt_many(
                [self.context.encode(self.expand_vector(list(vals)))
                 for vals in rows]))
        return [TorchBfvCiphertext(ct, self) for ct in cts]

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[int]:
        if not isinstance(ciphertext, TorchBfvCiphertext):
            raise RuntimeExecutionError(
                "BfvCiphertextFactory can only decrypt its own ciphertexts")
        return self.context.decode(self.context.decrypt(ciphertext.ct))

    # --- whole-program protocol (runtime/jit_executor.py) -------------------
    def jit_pack(self, handle: TorchBfvCiphertext):
        """(device tensor, static metadata) of a ciphertext handle."""
        return handle.ct.data, None

    def jit_unpack(self, tensor: torch.Tensor, meta=None
                   ) -> TorchBfvCiphertext:
        return TorchBfvCiphertext(BfvCiphertext(tensor), self)
