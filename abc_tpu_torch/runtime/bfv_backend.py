"""BFV runtime backend on torch (port of abc_tpu/runtime/bfv_backend.py).

The factory plugs into RuntimeVisitor / run_compiled like abc_tpu's
BfvCiphertextFactory. It builds a BfvContext from (slots, seed, ks_digits)
on `device`: keys, encryption, evaluation and decryption all run there.
There is no backend sniffing: the caller names the device, and a CUDA
device without a GPU is an error.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext, Plaintext
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.errors import RuntimeExecutionError


def _zero_pad(data: torch.Tensor, size: int) -> torch.Tensor:
    """Pad a [k, L, n] ciphertext component stack with zero components."""
    pad = data.new_zeros((size - data.shape[0],) + tuple(data.shape[1:]))
    return torch.cat([data, pad])


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
            a = _zero_pad(a, b.shape[0])
        elif b.shape[0] < a.shape[0]:
            b = _zero_pad(b, a.shape[0])
        return BfvCiphertext(a), BfvCiphertext(b)

    def _wrap(self, ct: BfvCiphertext) -> "TorchBfvCiphertext":
        return TorchBfvCiphertext(ct, self.factory)

    def add(self, other):
        return self._wrap(self._ctx().add(*self._aligned(other)))

    def subtract(self, other):
        return self._wrap(self._ctx().sub(*self._aligned(other)))

    def multiply(self, other):
        a = self._relin()
        b = other._relin() if other is not self else a
        return self._wrap(self._ctx().multiply(a, b, relinearize=False))

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


class BfvCiphertextFactory(AbstractCiphertextFactory):
    """Factory owning the BFV context + keys, evaluating on `device`."""

    def __init__(self, slots: int = 8192, seed: int = None,
                 ks_digits: int = 1, device="cuda"):
        self.params = BfvParams.create(slots, seed=seed, ks_digits=ks_digits)
        self.context = BfvContext(self.params, device)

    @property
    def slot_count(self) -> int:
        return self.params.slot_count

    def encode_cleartext(self, cleartext: Cleartext) -> Plaintext:
        """Cleartext → plaintext with last-element padding to all slots."""
        vals = [int(v) for v in cleartext.values]
        return self.context.encode(self.expand_vector(vals))

    def create_ciphertext(self, value: Union[Cleartext, Sequence[int], int]
                          ) -> TorchBfvCiphertext:
        return self.create_many([value])[0]

    def create_many(self, values: Sequence) -> List[TorchBfvCiphertext]:
        """Encrypt a batch of inputs in one batched device pass."""
        pts = []
        for value in values:
            if isinstance(value, Cleartext):
                vals = [int(v) for v in value.values]
            elif isinstance(value, int):
                vals = [int(value)]
            else:
                vals = [int(v) for v in value]
            pts.append(self.context.encode(self.expand_vector(vals)))
        return [TorchBfvCiphertext(ct, self)
                for ct in self.context.encrypt_many(pts)]

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[int]:
        if not isinstance(ciphertext, TorchBfvCiphertext):
            raise RuntimeExecutionError(
                "BfvCiphertextFactory can only decrypt its own ciphertexts")
        return self.context.decode(self.context.decrypt(ciphertext.ct))
