"""Compile-time expression simplifier (CTES).

The reference DOCUMENTS this pass (README.md:79-91: "compile-time expression
simplifier... precompute expressions over known values, remove branching on
plaintext conditions") and names it in the intended pipeline
(CardioTest.cpp:61-64 STAGE_02_ctestTest), but ships no implementation —
this module is authored to that spec.

What it does (AST → AST, repeated to fixpoint):
  * constant folding of literal operands (1+2 → 3, all operators)
  * algebraic identities: x+0, 0+x, x-0, x*1, 1*x, x*0, 0*x, x/1 and the
    FHE-operator variants; !true, !!x; true&&x, false||x, ...
  * ternary / If over literal conditions → taken branch (If lowering of
    plaintext branches)
  * For loops whose condition is literally false → removed
  * empty If branches / empty Blocks cleanup
"""

from __future__ import annotations

from typing import Any, Optional

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, AbstractNode, AbstractStatement, Assignment,
    BinaryExpression, Block, Call, ExpressionList, For, Function, If,
    IndexAccess, Literal, LiteralBool, LiteralInt, OperatorExpression, Return,
    TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.utils.datatype import Type
from abc_tpu_torch.utils.operators import Op, Operator

_FOLD = {
    Op.ADD: lambda a, b: a + b,
    Op.SUB: lambda a, b: a - b,
    Op.MUL: lambda a, b: a * b,
    Op.FHE_ADD: lambda a, b: a + b,
    Op.FHE_SUB: lambda a, b: a - b,
    Op.FHE_MUL: lambda a, b: a * b,
    Op.DIV: lambda a, b: a // b if isinstance(a, int) and isinstance(b, int) else a / b,
    Op.MOD: lambda a, b: a % b,
    Op.LESS: lambda a, b: a < b,
    Op.LESS_EQUAL: lambda a, b: a <= b,
    Op.GREATER: lambda a, b: a > b,
    Op.GREATER_EQUAL: lambda a, b: a >= b,
    Op.EQUAL: lambda a, b: a == b,
    Op.NOTEQUAL: lambda a, b: a != b,
    Op.LOGICAL_AND: lambda a, b: bool(a) and bool(b),
    Op.LOGICAL_OR: lambda a, b: bool(a) or bool(b),
    Op.BITWISE_AND: lambda a, b: a & b,
    Op.BITWISE_XOR: lambda a, b: a ^ b,
    Op.BITWISE_OR: lambda a, b: a | b,
}


def _lit_value(node: AbstractNode) -> Optional[Any]:
    if isinstance(node, Literal) and node.literal_type in (
            Type.INT, Type.BOOL, Type.FLOAT, Type.DOUBLE):
        return node.value
    return None


def _make_literal(value: Any, like_op: Op) -> Literal:
    if isinstance(value, bool):
        return Literal(value, Type.BOOL)
    if isinstance(value, int):
        return LiteralInt(value)
    return Literal(float(value), Type.DOUBLE)


def _is_zero(node) -> bool:
    v = _lit_value(node)
    return v == 0 and not isinstance(v, bool)


def _is_one(node) -> bool:
    v = _lit_value(node)
    return v == 1 and not isinstance(v, bool)


def simplify_expression(expr: AbstractExpression) -> AbstractExpression:
    """Bottom-up simplification; returns the (possibly new) expression."""
    if isinstance(expr, BinaryExpression):
        expr.left = simplify_expression(expr.left)
        expr.right = simplify_expression(expr.right)
        lv, rv = _lit_value(expr.left), _lit_value(expr.right)
        op = expr.operator.op
        if lv is not None and rv is not None and op in _FOLD:
            return _make_literal(_FOLD[op](lv, rv), op)
        plain = expr.operator.as_plain().op
        if plain == Op.ADD:
            if _is_zero(expr.left):
                return expr.right
            if _is_zero(expr.right):
                return expr.left
        elif plain == Op.SUB:
            if _is_zero(expr.right):
                return expr.left
        elif plain == Op.MUL:
            if _is_one(expr.left):
                return expr.right
            if _is_one(expr.right):
                return expr.left
            if _is_zero(expr.left) or _is_zero(expr.right):
                return LiteralInt(0)
        elif op == Op.DIV and _is_one(expr.right):
            return expr.left
        elif op == Op.LOGICAL_AND:
            if lv is True:
                return expr.right
            if rv is True:
                return expr.left
            if lv is False or rv is False:
                return LiteralBool(False)
        elif op == Op.LOGICAL_OR:
            if lv is False:
                return expr.right
            if rv is False:
                return expr.left
            if lv is True or rv is True:
                return LiteralBool(True)
        return expr
    if isinstance(expr, OperatorExpression):
        expr.operands = [expr._adopt(simplify_expression(o))
                         for o in expr.operands if o is not None]
        values = [_lit_value(o) for o in expr.operands]
        if all(v is not None for v in values) and expr.operator.op in _FOLD:
            acc = values[0]
            for v in values[1:]:
                acc = _FOLD[expr.operator.op](acc, v)
            return _make_literal(acc, expr.operator.op)
        return expr
    if isinstance(expr, UnaryExpression):
        expr.operand = simplify_expression(expr.operand)
        v = _lit_value(expr.operand)
        if expr.operator.op == Op.LOGICAL_NOT:
            if v is not None:
                return LiteralBool(not bool(v))
            inner = expr.operand
            if isinstance(inner, UnaryExpression) and \
                    inner.operator.op == Op.LOGICAL_NOT:
                return inner.operand  # !!x → x
        elif expr.operator.op == Op.BITWISE_NOT and isinstance(v, int):
            return LiteralInt(~v)
        return expr
    if isinstance(expr, TernaryOperator):
        expr.condition = simplify_expression(expr.condition)
        expr.then_expr = simplify_expression(expr.then_expr)
        expr.else_expr = simplify_expression(expr.else_expr)
        v = _lit_value(expr.condition)
        if v is not None:
            return expr.then_expr if v else expr.else_expr
        return expr
    if isinstance(expr, IndexAccess):
        expr.index = simplify_expression(expr.index)
        if not isinstance(expr.target, Variable):
            expr.target = simplify_expression(expr.target)
        return expr
    if isinstance(expr, Call):
        expr.arguments = [expr._adopt(simplify_expression(a))
                          for a in expr.arguments if a is not None]
        return expr
    if isinstance(expr, ExpressionList):
        expr.expressions = [expr._adopt(simplify_expression(e))
                            for e in expr.expressions if e is not None]
        return expr
    return expr


def simplify_statement(stmt: AbstractStatement) -> Optional[AbstractStatement]:
    """Returns the simplified statement, or None if it can be removed."""
    if isinstance(stmt, Block):
        new_stmts = []
        for s in stmt.statements:
            if s is None:
                continue
            simplified = simplify_statement(s)
            if simplified is not None:
                new_stmts.append(simplified)
        stmt.statements = [stmt._adopt(s) for s in new_stmts]
        return stmt
    if isinstance(stmt, VariableDeclaration):
        if stmt.value is not None:
            stmt.value = simplify_expression(stmt.value)
        return stmt
    if isinstance(stmt, Assignment):
        stmt.value = simplify_expression(stmt.value)
        if isinstance(stmt.target, IndexAccess):
            stmt.target.index = simplify_expression(stmt.target.index)
        return stmt
    if isinstance(stmt, Return):
        if stmt.value is not None:
            stmt.value = simplify_expression(stmt.value)
        return stmt
    if isinstance(stmt, If):
        stmt.condition = simplify_expression(stmt.condition)
        simplify_statement(stmt.then_branch)
        if stmt.else_branch is not None:
            simplify_statement(stmt.else_branch)
            if stmt.else_branch.is_empty():
                stmt.else_branch = None
        v = _lit_value(stmt.condition)
        if v is not None:
            # plaintext branching removal (README.md:79-91)
            if v:
                return stmt.then_branch
            return stmt.else_branch  # may be None → statement removed
        if stmt.then_branch.is_empty() and stmt.else_branch is None:
            return None
        return stmt
    if isinstance(stmt, For):
        simplify_statement(stmt.initializer)
        stmt.condition = simplify_expression(stmt.condition)
        simplify_statement(stmt.update)
        simplify_statement(stmt.body)
        if _lit_value(stmt.condition) is False:
            # loop never runs; keep initializer side effects
            return stmt.initializer if not stmt.initializer.is_empty() else None
        return stmt
    if isinstance(stmt, Function):
        simplify_statement(stmt.body)
        return stmt
    return stmt


def run_ctes(ast: AbstractNode, max_rounds: int = 8) -> AbstractNode:
    """Simplify to fixpoint (bounded rounds)."""
    for _ in range(max_rounds):
        before = str(ast)
        if isinstance(ast, AbstractStatement):
            ast = simplify_statement(ast) or Block([])
        else:
            ast = simplify_expression(ast)
        if str(ast) == before:
            break
    return ast
