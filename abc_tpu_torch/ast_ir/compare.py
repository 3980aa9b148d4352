"""Structural AST equality, used pervasively by tests.

Reference: test/ASTComparison.{h,cpp} (recursive comparison on typeid +
node attributes).
"""

from __future__ import annotations

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, Assignment, BinaryExpression, Block, Call, ExpressionList,
    For, Function, FunctionParameter, If, IndexAccess, Literal,
    OperatorExpression, Return, TernaryOperator, UnaryExpression, Variable,
    VariableDeclaration,
)


def compare_ast(a: AbstractNode | None, b: AbstractNode | None) -> bool:
    if a is None or b is None:
        return a is b
    if type(a) is not type(b):
        return False
    if isinstance(a, Literal):
        return a.value == b.value and a.literal_type == b.literal_type
    if isinstance(a, Variable):
        return a.identifier == b.identifier
    if isinstance(a, (BinaryExpression, OperatorExpression, UnaryExpression)):
        if a.operator != b.operator:
            return False
    if isinstance(a, Call):
        if a.identifier != b.identifier:
            return False
    if isinstance(a, FunctionParameter):
        return a.parameter_type == b.parameter_type and a.identifier == b.identifier
    if isinstance(a, VariableDeclaration):
        if a.datatype != b.datatype:
            return False
    if isinstance(a, Function):
        if a.return_type != b.return_type or a.identifier != b.identifier:
            return False
    ca, cb = a.children(), b.children()
    if len(ca) != len(cb):
        return False
    return all(compare_ast(x, y) for x, y in zip(ca, cb))


def assert_ast_equal(a: AbstractNode, b: AbstractNode) -> None:
    if not compare_ast(a, b):
        raise AssertionError(
            f"ASTs differ:\n--- got ---\n{a}\n--- expected ---\n{b}")
