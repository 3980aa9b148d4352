"""Runtime value model: AbstractValue / Cleartext / AbstractCiphertext.

Reference: include/ast_opt/runtime/AbstractValue.h:4-48 (18 in-place ops),
Cleartext.h:30-382 (plaintext vector value, elementwise std::transform ops,
allEqual, setValueAtIndex), AbstractCiphertext.h:12-99 (ciphertext interface).

Design difference: values here are IMMUTABLE — every operation returns a new
value. That matches JAX semantics (jnp arrays are immutable) and removes the
reference's defensive clone-on-every-variable-read (RuntimeVisitor.cpp:429-443,
a full ciphertext copy per read). Broadcasting between a scalar (length-1) and
a vector is supported explicitly; the reference's std::transform silently
assumed equal lengths.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from abc_tpu_torch.utils.datatype import Type
from abc_tpu_torch.utils.errors import RuntimeExecutionError
from abc_tpu_torch.utils.operators import Op


class AbstractValue:
    """Marker base for runtime values."""


class Cleartext(AbstractValue):
    """Plaintext vector value with an element type tag."""

    __slots__ = ("values", "dtype")

    def __init__(self, values: Sequence[Any], dtype: Type):
        self.values: List[Any] = list(values)
        self.dtype = dtype

    # --- constructors ---------------------------------------------------
    @staticmethod
    def from_scalar(value: Any, dtype: Type) -> "Cleartext":
        return Cleartext([value], dtype)

    # --- predicates -------------------------------------------------------
    def all_equal(self, value: Any = None) -> bool:
        # ref: Cleartext::allEqual, Cleartext.h:81-90 (with an argument:
        # every element equals `value`; without: every element equal)
        ref = self.values[0] if value is None else value
        return all(v == ref for v in self.values)

    def is_scalar(self) -> bool:
        return len(self.values) == 1

    def scalar(self) -> Any:
        if not self.all_equal():
            raise RuntimeExecutionError("expected a scalar cleartext value")
        return self.values[0]

    # --- mutation helpers (used by indexed assignment) ---------------------
    def with_value_at_index(self, index: int, value: Any) -> "Cleartext":
        # ref: Cleartext::setValueAtIndex; grows the vector when needed
        vals = list(self.values)
        if index >= len(vals):
            fill = 0 if self.dtype in (Type.INT, Type.BOOL) else (
                0.0 if self.dtype in (Type.FLOAT, Type.DOUBLE) else "")
            vals.extend([fill] * (index + 1 - len(vals)))
        vals[index] = value
        return Cleartext(vals, self.dtype)

    # --- operations ---------------------------------------------------------
    def binary_op(self, op: Op, other: "Cleartext") -> "Cleartext":
        a, b = self.values, other.values
        if len(a) != len(b):
            if len(a) == 1:
                a = a * len(b)
            elif len(b) == 1:
                b = b * len(a)
            else:
                raise RuntimeExecutionError(
                    f"cleartext length mismatch: {len(a)} vs {len(b)}")
        fn = _CLEARTEXT_OPS.get(op)
        if fn is None:
            raise RuntimeExecutionError(f"unsupported cleartext operator: {op}")
        result = [fn(x, y) for x, y in zip(a, b)]
        if op in _RELATIONAL_OPS or op in (Op.LOGICAL_AND, Op.LOGICAL_OR):
            return Cleartext(result, Type.BOOL)
        return Cleartext(result, self.dtype)

    def unary_op(self, op: Op) -> "Cleartext":
        if op == Op.LOGICAL_NOT:
            return Cleartext([not bool(v) for v in self.values], Type.BOOL)
        if op == Op.BITWISE_NOT:
            return Cleartext([~int(v) for v in self.values], self.dtype)
        raise RuntimeExecutionError(f"unsupported unary operator: {op}")

    def __repr__(self) -> str:
        return f"Cleartext<{self.dtype.value}>({self.values})"


_RELATIONAL_OPS = {Op.LESS, Op.LESS_EQUAL, Op.GREATER, Op.GREATER_EQUAL,
                   Op.EQUAL, Op.NOTEQUAL}

_CLEARTEXT_OPS = {
    Op.ADD: lambda x, y: x + y,
    Op.SUB: lambda x, y: x - y,
    Op.MUL: lambda x, y: x * y,
    Op.DIV: lambda x, y: x // y if isinstance(x, int) and isinstance(y, int) else x / y,
    Op.MOD: lambda x, y: x % y,
    Op.FHE_ADD: lambda x, y: x + y,
    Op.FHE_SUB: lambda x, y: x - y,
    Op.FHE_MUL: lambda x, y: x * y,
    Op.LOGICAL_AND: lambda x, y: bool(x) and bool(y),
    Op.LOGICAL_OR: lambda x, y: bool(x) or bool(y),
    Op.LESS: lambda x, y: x < y,
    Op.LESS_EQUAL: lambda x, y: x <= y,
    Op.GREATER: lambda x, y: x > y,
    Op.GREATER_EQUAL: lambda x, y: x >= y,
    Op.EQUAL: lambda x, y: x == y,
    Op.NOTEQUAL: lambda x, y: x != y,
    Op.BITWISE_AND: lambda x, y: x & y,
    Op.BITWISE_XOR: lambda x, y: x ^ y,
    Op.BITWISE_OR: lambda x, y: x | y,
}


class AbstractCiphertext(AbstractValue):
    """Backend-agnostic ciphertext interface (ref: AbstractCiphertext.h:12-99).

    All operations are pure: they return new ciphertexts.
    """

    def add(self, other: "AbstractCiphertext") -> "AbstractCiphertext":
        raise NotImplementedError

    def subtract(self, other: "AbstractCiphertext") -> "AbstractCiphertext":
        raise NotImplementedError

    def multiply(self, other: "AbstractCiphertext") -> "AbstractCiphertext":
        raise NotImplementedError

    def add_plain(self, other: Cleartext) -> "AbstractCiphertext":
        raise NotImplementedError

    def subtract_plain(self, other: Cleartext) -> "AbstractCiphertext":
        raise NotImplementedError

    def subtract_from_plain(self, other: Cleartext) -> "AbstractCiphertext":
        """plain - ctxt (needed because subtraction is not commutative)."""
        raise NotImplementedError

    def multiply_plain(self, other: Cleartext) -> "AbstractCiphertext":
        raise NotImplementedError

    def rotate_rows(self, steps: int) -> "AbstractCiphertext":
        """SEAL-compatible row rotation: slots form a 2×(n/2) matrix and each
        row rotates cyclically; positive steps rotate left
        (ref: SealCiphertext.cpp:52-61; expected vectors
        RuntimeVisitorTest.cpp:100-103)."""
        raise NotImplementedError

    def apply_binary_op(self, op: Op, other: AbstractValue,
                        self_is_lhs: bool = True) -> "AbstractCiphertext":
        """Dispatch helper mirroring SealCiphertext's RTTI dispatch
        (SealCiphertext.cpp:208-239)."""
        other = unwrap_value(other)  # collapse lazy masked views (see below)
        plain_op = {Op.FHE_ADD: Op.ADD, Op.FHE_SUB: Op.SUB, Op.FHE_MUL: Op.MUL}.get(op, op)
        if isinstance(other, AbstractCiphertext):
            if plain_op == Op.ADD:
                return self.add(other)
            if plain_op == Op.SUB:
                return self.subtract(other) if self_is_lhs else other.subtract(self)
            if plain_op == Op.MUL:
                return self.multiply(other)
        elif isinstance(other, Cleartext):
            if plain_op == Op.ADD:
                return self.add_plain(other)
            if plain_op == Op.SUB:
                return self.subtract_plain(other) if self_is_lhs \
                    else self.subtract_from_plain(other)
            if plain_op == Op.MUL:
                return self.multiply_plain(other)
        raise RuntimeExecutionError(
            f"operation ({op}) not supported on ciphertexts "
            "(division/modulo/logical/bitwise require binary circuits)")


class LazyMaskedCiphertext(AbstractCiphertext):
    """Deferred masked-slot-write view over a ciphertext store.

    A slot write ``x[i] = v`` on a ciphertext is algebraically
    ``x' = x*keep_i + onehot_i*align(v)``. Applying the keep-mask multiply
    eagerly re-multiplies the WHOLE stored ciphertext per write, compounding
    ~log2(n*t) noise bits into the store for every write — a handful of
    writes exhausts any practical budget. (The reference never hit this: it
    supports indexed assignment only on cleartext vectors,
    RuntimeVisitor.cpp:362-381, and left secret IndexAccess as a TODO,
    LaplaceSharpeningTest.cpp:180.)

    This view defers the mask: writes to distinct slots accumulate a combined
    keep mask, a plaintext write vector, and a ciphertext accumulator. N
    writes cost ONE multiply_plain on the base at materialization (plus one
    per ciphertext-valued write to isolate its slot), so the store's noise is
    a max over the written values, not a sum over the writes. Any other use
    of the value (arithmetic, rotation, decryption) materializes it.
    """

    __slots__ = ("base", "keep", "plain_writes", "acc", "_cached")

    def __init__(self, base: "AbstractCiphertext", slots: int):
        self.base = base
        self.keep = [1] * slots
        self.plain_writes: List[Any] = [0] * slots
        self.acc: AbstractCiphertext | None = None
        self._cached: AbstractCiphertext | None = None

    @property
    def slots(self) -> int:
        return len(self.keep)

    # --- lazy write API ----------------------------------------------------
    def with_slot_write(self, index: int, value: AbstractValue
                        ) -> "LazyMaskedCiphertext":
        """Return a new view with slot `index` overwritten by `value`
        (a scalar Cleartext, or a slot-0-aligned ciphertext)."""
        idx = index % self.slots
        if self.keep[idx] == 0:
            # slot rewritten: collapse first so the old contribution is
            # actually erased by the new keep mask
            return LazyMaskedCiphertext(self.materialize(), self.slots) \
                .with_slot_write(idx, value)
        new = LazyMaskedCiphertext(self.base, self.slots)
        new.keep = list(self.keep)
        new.plain_writes = list(self.plain_writes)
        new.acc = self.acc
        new.keep[idx] = 0
        if isinstance(value, Cleartext):
            new.plain_writes[idx] = value.scalar()
        elif isinstance(value, AbstractCiphertext):
            if idx >= self.slots // 2:
                # rotate_rows is the SEAL 2×(n/2) row rotation: it cannot
                # move slot 0 into the second row, so a ciphertext-valued
                # write there would mask rotated garbage. First-row-only is
                # the supported convention for ciphertext writes; plain
                # writes to any slot are fine.
                raise RuntimeExecutionError(
                    f"ciphertext-valued slot write at index {idx} >= "
                    f"{self.slots // 2} (second SEAL row) is not reachable "
                    "by rotate_rows; only first-row slots support "
                    "ciphertext writes")
            moved = value.rotate_rows(-idx) if idx else value
            onehot = [0] * self.slots
            onehot[idx] = 1
            masked = moved.multiply_plain(Cleartext(onehot, Type.INT))
            new.acc = masked if new.acc is None else new.acc.add(masked)
        else:
            raise RuntimeExecutionError(
                f"cannot write value of type {type(value).__name__} into a "
                "ciphertext slot")
        return new

    def materialize(self) -> "AbstractCiphertext":
        if self._cached is None:
            ct = self.base
            if not all(self.keep):
                ct = ct.multiply_plain(Cleartext(self.keep, Type.INT))
            if any(self.plain_writes):
                ct = ct.add_plain(Cleartext(self.plain_writes, Type.INT))
            if self.acc is not None:
                ct = ct.add(self.acc)
            self._cached = ct
        return self._cached

    # --- AbstractCiphertext interface: forward through materialization -----
    def add(self, other):
        return self.materialize().add(unwrap_value(other))

    def subtract(self, other):
        return self.materialize().subtract(unwrap_value(other))

    def multiply(self, other):
        return self.materialize().multiply(unwrap_value(other))

    def add_plain(self, other):
        return self.materialize().add_plain(other)

    def subtract_plain(self, other):
        return self.materialize().subtract_plain(other)

    def subtract_from_plain(self, other):
        return self.materialize().subtract_from_plain(other)

    def multiply_plain(self, other):
        return self.materialize().multiply_plain(other)

    def rotate_rows(self, steps: int):
        return self.materialize().rotate_rows(steps)

    def apply_binary_op(self, op, other, self_is_lhs: bool = True):
        return self.materialize().apply_binary_op(op, unwrap_value(other),
                                                  self_is_lhs)

    def noise_bits(self) -> int:
        return self.materialize().noise_bits()

    def __repr__(self) -> str:
        written = self.slots - sum(self.keep)
        return f"LazyMaskedCiphertext({written} pending writes over {self.base!r})"


def unwrap_value(value: AbstractValue) -> AbstractValue:
    """Collapse a lazy masked view to its backend ciphertext; identity on
    everything else. Call before handing values to a backend/factory."""
    if isinstance(value, LazyMaskedCiphertext):
        return value.materialize()
    return value
