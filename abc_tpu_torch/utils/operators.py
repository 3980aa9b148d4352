"""Operators of the DSL: arithmetic, logical/relational, unary, FHE variants.

Reference: include/ast_opt/utilities/Operator.h:14-74 and
src/utilities/Operator.cpp (toString tables, isCommutative :39-46,
comparePrecedence :62-110). The FHE operators +++/---/*** explicitly mark
ciphertext arithmetic in the surface language (src/parser/Tokens.cpp:23-25).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class OpKind(enum.Enum):
    ARITHMETIC = "arithmetic"
    LOGICAL = "logical"
    UNARY = "unary"


class Op(enum.Enum):
    # arithmetic (ref: ArithmeticOp, Operator.h:14-16)
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    FHE_ADD = "+++"
    FHE_SUB = "---"
    FHE_MUL = "***"
    # logical / relational / bitwise (ref: LogicalOp, Operator.h:18-24)
    LOGICAL_AND = "&&"
    LOGICAL_OR = "||"
    LESS = "<"
    LESS_EQUAL = "<="
    GREATER = ">"
    GREATER_EQUAL = ">="
    EQUAL = "=="
    NOTEQUAL = "!="
    BITWISE_AND = "&"
    BITWISE_XOR = "^"
    BITWISE_OR = "|"
    # unary (ref: UnaryOp, Operator.h:26-28)
    LOGICAL_NOT = "!"
    BITWISE_NOT = "~"

    def __str__(self) -> str:  # ref: Operator::toString
        return self.value


_ARITH = {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD, Op.FHE_ADD, Op.FHE_SUB, Op.FHE_MUL}
_UNARY = {Op.LOGICAL_NOT, Op.BITWISE_NOT}

_COMMUTATIVE = {
    # ref: Operator::isCommutative, Operator.cpp:39-52
    Op.MUL, Op.FHE_MUL, Op.ADD, Op.FHE_ADD,
    Op.EQUAL, Op.NOTEQUAL,
    Op.BITWISE_AND, Op.BITWISE_XOR, Op.BITWISE_OR,
    Op.LOGICAL_AND, Op.LOGICAL_OR,
}

_RELATIONAL = {Op.LESS, Op.LESS_EQUAL, Op.GREATER, Op.GREATER_EQUAL, Op.EQUAL, Op.NOTEQUAL}

# cppreference operator precedence levels; LOWER number = HIGHER precedence.
# ref: comparePrecedence, Operator.cpp:66-101
_PRECEDENCE = {
    Op.LOGICAL_NOT: 3, Op.BITWISE_NOT: 3,
    Op.MUL: 5, Op.FHE_MUL: 5, Op.DIV: 5, Op.MOD: 5,
    Op.ADD: 6, Op.FHE_ADD: 6, Op.SUB: 6, Op.FHE_SUB: 6,
    Op.LESS: 9, Op.LESS_EQUAL: 9, Op.GREATER: 9, Op.GREATER_EQUAL: 9,
    Op.EQUAL: 10, Op.NOTEQUAL: 10,
    Op.BITWISE_AND: 11,
    Op.BITWISE_XOR: 12,
    Op.BITWISE_OR: 13,
    Op.LOGICAL_AND: 14,
    Op.LOGICAL_OR: 15,
}

# map FHE-specific operators to their plain counterparts (for evaluation)
FHE_TO_PLAIN = {Op.FHE_ADD: Op.ADD, Op.FHE_SUB: Op.SUB, Op.FHE_MUL: Op.MUL}

_BY_SYMBOL = {op.value: op for op in Op}


@dataclass(frozen=True)
class Operator:
    """Value-semantics wrapper over Op, mirroring the reference's Operator class."""

    op: Op

    @staticmethod
    def from_symbol(symbol: str) -> "Operator":
        if symbol not in _BY_SYMBOL:
            raise ValueError(f"unknown operator symbol: {symbol!r}")
        return Operator(_BY_SYMBOL[symbol])

    @property
    def kind(self) -> OpKind:
        if self.op in _UNARY:
            return OpKind.UNARY
        if self.op in _ARITH:
            return OpKind.ARITHMETIC
        return OpKind.LOGICAL

    def is_unary(self) -> bool:
        return self.op in _UNARY

    def is_commutative(self) -> bool:
        return self.op in _COMMUTATIVE

    def is_relational(self) -> bool:
        return self.op in _RELATIONAL

    def is_right_associative(self) -> bool:
        # only unary operators are right-associative (ref: Operator.cpp:29-32)
        return self.is_unary()

    def is_fhe_operator(self) -> bool:
        return self.op in FHE_TO_PLAIN

    def as_plain(self) -> "Operator":
        """+++ → +, --- → -, *** → *; identity for plain operators."""
        return Operator(FHE_TO_PLAIN.get(self.op, self.op))

    def precedence(self) -> int:
        return _PRECEDENCE[self.op]

    def compare_precedence(self, other: "Operator") -> int:
        """1 if self binds tighter than other, 0 equal, -1 looser."""
        a, b = self.precedence(), other.precedence()
        return 1 if a < b else (0 if a == b else -1)

    def __str__(self) -> str:
        return self.op.value
