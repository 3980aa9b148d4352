"""Visitor infrastructure.

Reference: include/ast_opt/utilities/IVisitor.h:50-96 (22 visit overloads),
Visitor.h:51-178 (CRTP/SFINAE template dispatching to the most specific
overload a pass implements, including superclass-level handlers like
visit(AbstractStatement&)), ScopedVisitor.h:10-84 (default traversal + scope
tracking, special For handling ScopedVisitor.cpp:123-143), PlainVisitor.h
(traversal without scopes).

Python equivalent: `visit()` walks the node class MRO looking for a
`visit_<ClassName>` method — so a pass may implement `visit_BinaryExpression`,
or catch all statements with `visit_AbstractStatement`, with the same
most-specific-wins semantics as the reference's SFINAE dispatch.
"""

from __future__ import annotations

from typing import Any, Optional

from abc_tpu_torch.ast_ir.nodes import AbstractNode, Block, For, Function
from abc_tpu_torch.utils.scope import Scope


class PlainVisitor:
    """Depth-first traversal without scope bookkeeping (ref: PlainVisitor.h)."""

    def visit(self, node: AbstractNode) -> Any:
        for cls in type(node).__mro__:
            method = getattr(self, f"visit_{cls.__name__}", None)
            if method is not None:
                return method(node)
        return self.generic_visit(node)

    def generic_visit(self, node: AbstractNode) -> Any:
        self.visit_children(node)

    def visit_children(self, node: AbstractNode) -> None:
        for child in node.children():
            child.accept(self)

    # default handler so visit_AbstractNode acts as the catch-all hook
    def visit_AbstractNode(self, node: AbstractNode) -> Any:
        return self.generic_visit(node)


class ScopedVisitor(PlainVisitor):
    """Traversal with lexical scope tracking (ref: ScopedVisitor.h:10-84).

    Scopes open at Block, For (one scope shared by init/cond/update/body,
    ref: ScopedVisitor.cpp:123-143) and Function (params in body scope).
    """

    def __init__(self) -> None:
        self.root_scope: Optional[Scope] = None
        self.current_scope: Optional[Scope] = None

    # --- scope management ---------------------------------------------------
    def set_root_scope(self, scope: Scope) -> None:
        self.root_scope = scope
        self.current_scope = scope

    def get_root_scope(self) -> Scope:
        assert self.root_scope is not None
        return self.root_scope

    def enter_scope(self, node: AbstractNode) -> None:
        if self.current_scope is None:
            self.root_scope = Scope(node)
            self.current_scope = self.root_scope
        else:
            # re-enter an existing child scope for this node if present
            for child in self.current_scope.children:
                if child.ast_node is node:
                    self.current_scope = child
                    return
            self.current_scope = Scope(node, self.current_scope)

    def exit_scope(self) -> None:
        assert self.current_scope is not None
        self.current_scope = self.current_scope.parent

    def declare(self, identifier: str):
        if self.current_scope is None:
            self.enter_scope_root_fallback()
        return self.current_scope.add_identifier(identifier)

    def enter_scope_root_fallback(self) -> None:
        if self.current_scope is None:
            raise RuntimeError("visitor has no active scope; call set_root_scope "
                               "or start at a Block")

    # --- default node handlers ---------------------------------------------
    def visit_Block(self, node: Block) -> Any:
        # the root Block may be pre-bound to root_scope by set_root_scope
        if self.current_scope is not None and self.current_scope.ast_node is node:
            self.visit_children(node)
            return
        self.enter_scope(node)
        self.visit_children(node)
        self.exit_scope()

    def visit_For(self, node: For) -> Any:
        # initializer/condition/update/body all share the single loop scope;
        # the child Blocks then open their own nested scopes as in the
        # reference (ScopedVisitor.cpp:123-143)
        self.enter_scope(node)
        for child in node.children():
            child.accept(self)
        self.exit_scope()

    def visit_Function(self, node: Function) -> Any:
        self.enter_scope(node)
        for p in node.parameters:
            self.declare(p.identifier)
            p.accept(self)
        node.body.accept(self)
        self.exit_scope()

    def visit_VariableDeclaration(self, node) -> Any:
        if node.value is not None:
            node.value.accept(self)
        self.declare(node.target.identifier)
        node.target.accept(self)
