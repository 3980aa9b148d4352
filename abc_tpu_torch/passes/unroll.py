"""Loop unrolling: expand For loops with compile-time-evaluable headers.

Named in the reference's intended pipeline (CardioTest.cpp:71-74
STAGE_04_loopUnrollingTest) but never implemented there — authored here to
that spec. Unrolling is what turns DSL loops into the straight-line circuit
the batching pass (and XLA tracing) needs: after unrolling, every loop index
is a literal, so IndexAccess nodes have constant indices.

Strategy: symbolically execute the loop header over an environment of
literal-valued loop variables (a small interpreter over Literal arithmetic);
each iteration emits the body with loop-variable reads substituted by their
current literal values. Loops whose header cannot be evaluated statically
(e.g. a secret bound) are left untouched. Nested loops unroll recursively.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, AbstractNode, AbstractStatement, Assignment,
    BinaryExpression, Block, For, Function, If, IndexAccess, Literal,
    TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.passes.ctes import _FOLD, _lit_value, _make_literal
from abc_tpu_torch.utils.errors import CompilerError

MAX_UNROLL_ITERATIONS = 65536


def _eval_static(expr: AbstractExpression, env: Dict[str, int]) -> Optional[int]:
    """Evaluate an expression over literal env; None if not static."""
    if isinstance(expr, Literal):
        v = _lit_value(expr)
        return v
    if isinstance(expr, Variable):
        return env.get(expr.identifier)
    if isinstance(expr, BinaryExpression):
        a = _eval_static(expr.left, env)
        b = _eval_static(expr.right, env)
        if a is None or b is None or expr.operator.op not in _FOLD:
            return None
        return _FOLD[expr.operator.op](a, b)
    if isinstance(expr, UnaryExpression):
        v = _eval_static(expr.operand, env)
        if v is None:
            return None
        from abc_tpu_torch.utils.operators import Op
        return (not bool(v)) if expr.operator.op == Op.LOGICAL_NOT else ~int(v)
    return None


def _substitute(node: AbstractNode, env: Dict[str, int]) -> AbstractNode:
    """Clone `node` with loop-variable READS replaced by literal values."""
    clone = node.clone()
    _substitute_in_place(clone, env)
    return clone


def _substitute_in_place(node: AbstractNode, env: Dict[str, int]) -> None:
    """Replace Variable reads found in child slots by literals, recursively.

    Write targets are skipped: the `_target` slot of Assignment /
    VariableDeclaration when it holds a bare Variable. (Loop variables are
    scalars, so the root of an IndexAccess write chain can never be one;
    its index expressions are reads and DO substitute.)
    """
    skip_slot = None
    if isinstance(node, (Assignment, VariableDeclaration)) and \
            isinstance(node.target, Variable):
        skip_slot = "_target"
    for name in node._child_attrs():
        val = getattr(node, name)
        if isinstance(val, list):
            for i, item in enumerate(val):
                if item is None:
                    continue
                if isinstance(item, Variable) and item.identifier in env:
                    val[i] = node._adopt(_make_literal(env[item.identifier], None))
                else:
                    _substitute_in_place(item, env)
        elif val is not None:
            if name == skip_slot:
                continue
            if isinstance(val, Variable) and val.identifier in env:
                setattr(node, name, node._adopt(_make_literal(env[val.identifier],
                                                              None)))
            else:
                _substitute_in_place(val, env)


class LoopUnroller:
    """Unrolls statically-evaluable For loops bottom-up."""

    def __init__(self, max_iterations: int = MAX_UNROLL_ITERATIONS):
        self.max_iterations = max_iterations

    def unroll_block(self, block: Block) -> None:
        new_statements: List[AbstractStatement] = []
        for stmt in block.children():
            expanded = self.unroll_statement(stmt)
            new_statements.extend(expanded)
        block.statements = [block._adopt(s) for s in new_statements]

    def unroll_statement(self, stmt: AbstractStatement) -> List[AbstractStatement]:
        if isinstance(stmt, For):
            return self._unroll_for(stmt)
        if isinstance(stmt, If):
            self.unroll_block(stmt.then_branch)
            if stmt.else_branch is not None:
                self.unroll_block(stmt.else_branch)
            return [stmt]
        if isinstance(stmt, (Block,)):
            self.unroll_block(stmt)
            return [stmt]
        if isinstance(stmt, Function):
            self.unroll_block(stmt.body)
            return [stmt]
        return [stmt]

    def _header_vars(self, loop: For) -> Optional[Dict[str, int]]:
        """Extract loop variables with literal initial values from the
        initializer; None if any initializer statement is not static."""
        env: Dict[str, int] = {}
        for init in loop.initializer.children():
            if isinstance(init, VariableDeclaration) and init.value is not None:
                v = _eval_static(init.value, env)
                if v is None:
                    return None
                env[init.target.identifier] = v
            elif isinstance(init, Assignment) and isinstance(init.target, Variable):
                v = _eval_static(init.value, env)
                if v is None:
                    return None
                env[init.target.identifier] = v
            else:
                return None
        return env

    def _unroll_for(self, loop: For) -> List[AbstractStatement]:
        # first unroll nested loops inside the body
        self.unroll_block(loop.body)

        env = self._header_vars(loop)
        if env is None or not env:
            return [loop]
        cond0 = _eval_static(loop.condition, env)
        if cond0 is None:
            return [loop]

        out: List[AbstractStatement] = []
        iterations = 0
        while True:
            cond = _eval_static(loop.condition, env)
            if cond is None:
                return [loop]  # became non-static (shouldn't happen)
            if not cond:
                break
            iterations += 1
            if iterations > self.max_iterations:
                raise CompilerError(
                    f"loop exceeds the unrolling bound ({self.max_iterations})")
            for body_stmt in loop.body.children():
                out.append(_substitute(body_stmt, env))
            # execute the update statements on the literal env
            for upd in loop.update.children():
                if isinstance(upd, Assignment) and isinstance(upd.target, Variable) \
                        and upd.target.identifier in env:
                    v = _eval_static(upd.value, env)
                    if v is None:
                        return [loop]
                    env[upd.target.identifier] = v
                else:
                    return [loop]
        return out


def run_loop_unrolling(ast: AbstractNode,
                       max_iterations: int = MAX_UNROLL_ITERATIONS) -> AbstractNode:
    unroller = LoopUnroller(max_iterations)
    if isinstance(ast, Block):
        unroller.unroll_block(ast)
    return ast
