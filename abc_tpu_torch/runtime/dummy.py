"""Dummy ("fake FHE") backend: plaintext int64 vectors with full slot
semantics, for fast pipeline testing without crypto.

Reference: src/runtime/DummyCiphertext.cpp / DummyCiphertextFactory.cpp —
but improved: the reference's rotateRows throws "Not yet implemented"
(DummyCiphertext.cpp:244-249); here rotation is implemented with exact
SEAL row semantics so every pipeline test (incl. rotations and batching)
can run without the real crypto backend (SURVEY.md §4: "testing FHE
without crypto" is the multi-node-without-a-cluster analogue).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.errors import RuntimeExecutionError


class DummyCiphertext(AbstractCiphertext):
    """Fake ciphertext: an int64 slot vector (no noise, no crypto)."""

    __slots__ = ("data", "factory")

    def __init__(self, data: np.ndarray, factory: "DummyCiphertextFactory"):
        self.data = data
        self.factory = factory

    # --- ctxt ⊕ ctxt ----------------------------------------------------------
    def add(self, other):
        return type(self)(self.data + other.data, self.factory)

    def subtract(self, other):
        return type(self)(self.data - other.data, self.factory)

    def multiply(self, other):
        return type(self)(self.data * other.data, self.factory)

    # --- ctxt ⊕ plain ----------------------------------------------------------
    def _plain(self, cleartext: Cleartext) -> np.ndarray:
        vals = self.factory.expand_vector([int(v) for v in cleartext.values])
        return np.asarray(vals, dtype=np.int64)

    def add_plain(self, other):
        return type(self)(self.data + self._plain(other), self.factory)

    def subtract_plain(self, other):
        return type(self)(self.data - self._plain(other), self.factory)

    def subtract_from_plain(self, other):
        return type(self)(self._plain(other) - self.data, self.factory)

    def multiply_plain(self, other):
        return type(self)(self.data * self._plain(other), self.factory)

    # --- rotation --------------------------------------------------------------
    def rotate_rows(self, steps: int) -> "DummyCiphertext":
        # SEAL batching views the n slots as a 2×(n/2) matrix; rotate_rows
        # rotates each row cyclically, positive steps to the left
        # (ref: SealCiphertext.cpp:52-61; expected output for rotate(x,-4)
        # at RuntimeVisitorTest.cpp:100-103)
        half = self.data.shape[0] // 2
        rows = self.data.reshape(2, half)
        rotated = np.roll(rows, -steps, axis=1)
        return type(self)(rotated.reshape(-1), self.factory)

    def clone(self) -> "DummyCiphertext":
        return type(self)(self.data.copy(), self.factory)

    # --- relational ops (dummy-only extension) --------------------------------
    # The secret-branching pass lowers `if (secret cond)` to mux arithmetic
    # whose CONDITION is an encrypted comparison. Real FHE backends cannot
    # evaluate comparisons (BFV raises, like SealCiphertext.cpp:241-309);
    # the plaintext fake backend CAN, which is what lets lowered circuits
    # run end-to-end in tests (tests/test_pipeline_fuzz.py). Division /
    # logical-not stay unsupported (the reference's ported matrix pins
    # them, RuntimeVisitorTest.cpp:383-479).
    _REL = None   # filled below (Op import ordering)

    def apply_binary_op(self, op, other, self_is_lhs: bool = True):
        from abc_tpu_torch.utils.operators import Op
        rel = {Op.LESS: np.less, Op.LESS_EQUAL: np.less_equal,
               Op.GREATER: np.greater, Op.GREATER_EQUAL: np.greater_equal,
               Op.EQUAL: np.equal, Op.NOTEQUAL: np.not_equal}
        fn = rel.get(op)
        if fn is None:
            return super().apply_binary_op(op, other, self_is_lhs)
        from abc_tpu_torch.runtime.values import unwrap_value
        other = unwrap_value(other)
        if isinstance(other, DummyCiphertext):
            rhs = other.data
        elif isinstance(other, Cleartext):
            rhs = self._plain(other)
        else:
            return super().apply_binary_op(op, other, self_is_lhs)
        a, b = (self.data, rhs) if self_is_lhs else (rhs, self.data)
        return type(self)(fn(a, b).astype(np.int64), self.factory)


class DummyCiphertextFactory(AbstractCiphertextFactory):
    """ref: DummyCiphertextFactory.h; slot count configurable (default 8192
    like a small BFV parameter set)."""

    handle_cls = DummyCiphertext   # subclass hook (e.g. key-census shim)

    def __init__(self, slots: int = 8192):
        if slots % 2 != 0:
            raise ValueError("slot count must be even (2×n/2 row structure)")
        self._slots = slots

    @property
    def slot_count(self) -> int:
        return self._slots

    def create_ciphertext(self, value: Union[Cleartext, Sequence[int], int]
                          ) -> DummyCiphertext:
        if isinstance(value, Cleartext):
            vals = [int(v) for v in value.values]
        elif isinstance(value, (int, np.integer)):
            vals = [int(value)]
        else:
            vals = [int(v) for v in value]
        data = np.asarray(self.expand_vector(vals), dtype=np.int64)
        return self.handle_cls(data, self)

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[int]:
        if not isinstance(ciphertext, DummyCiphertext):
            raise RuntimeExecutionError("DummyCiphertextFactory can only decrypt "
                                        "DummyCiphertexts")
        return [int(v) for v in ciphertext.data]
