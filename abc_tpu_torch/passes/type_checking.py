"""Type checking + secret-taint inference.

Reference: src/visitor/TypeCheckingVisitor.cpp (full file) /
TypeCheckingVisitor.h:15-17, 42-46, 116-126. Infers a Datatype for every
expression, checks operand compatibility (same base type,
TypeCheckingVisitor.cpp:305-307), and computes the SecretTaintedNodesMap
(unique_node_id → bool): secretness propagates UP through expressions and
stops at statements. Program inputs are pre-registered via
add_variable_datatype (ref: TypeCheckingVisitor.h:126).

Implementation note: where the reference threads expression types through an
explicit typesVisitedNodes stack, we return them from visit() — same
semantics, no stack discipline to police.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    Assignment, BinaryExpression, Block, Call, ExpressionList, For, Function,
    FunctionParameter, If, IndexAccess, Literal, OperatorExpression, Return,
    TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.passes.visitor import ScopedVisitor
from abc_tpu_torch.utils.datatype import Datatype, Type
from abc_tpu_torch.utils.errors import CompilerError
from abc_tpu_torch.utils.scope import ScopedIdentifier, VariableMap

# unique_node_id → bool (ref: TypeCheckingVisitor.h:17)
SecretTaintedNodesMap = Dict[str, bool]


class TypeCheckingVisitor(ScopedVisitor):
    """Walk the AST, infer datatypes, and record secret tainting."""

    def __init__(self) -> None:
        super().__init__()
        self.variables_datatype: VariableMap[Datatype] = VariableMap()
        self.expression_datatypes: Dict[str, Datatype] = {}
        self.secret_tainted: SecretTaintedNodesMap = {}
        # (datatype, is_literal) per return statement (ref: returnExpressionTypes)
        self._return_types: List[Tuple[Datatype, bool]] = []
        # identifiers pre-registered before the scope walk begins
        self._pending_inputs: List[Tuple[ScopedIdentifier, Datatype]] = []

    # --- public API ---------------------------------------------------------
    def add_variable_datatype(self, scoped_id: ScopedIdentifier, datatype: Datatype) -> None:
        """Pre-register a program input's type (ref: TypeCheckingVisitor.h:126)."""
        self.variables_datatype.insert_or_assign(scoped_id, datatype)

    def is_secret_tainted(self, unique_node_id: str) -> bool:
        return self.secret_tainted.get(unique_node_id, False)

    def get_secret_tainted_nodes(self) -> SecretTaintedNodesMap:
        return self.secret_tainted

    def get_expression_datatype(self, expr) -> Datatype:
        nid = expr.unique_node_id
        if nid not in self.expression_datatypes:
            raise CompilerError(f"no datatype known for expression {nid}")
        return self.expression_datatypes[nid]

    # --- helpers ------------------------------------------------------------
    def _record(self, node, datatype: Datatype) -> Datatype:
        self.expression_datatypes[node.unique_node_id] = datatype
        self.secret_tainted[node.unique_node_id] = datatype.secret
        return datatype

    def _taint(self, node, tainted: bool) -> None:
        self.secret_tainted[node.unique_node_id] = tainted

    # --- expressions --------------------------------------------------------
    def visit_Literal(self, node: Literal) -> Datatype:
        return self._record(node, Datatype(node.literal_type, False))

    def visit_Variable(self, node: Variable) -> Datatype:
        scoped_id = self.current_scope.resolve_identifier(node.identifier)
        dt = self.variables_datatype.try_get(scoped_id)
        if dt is None:
            raise CompilerError(
                f"no datatype information found for variable ({node.identifier}); "
                "did you forget to initialize it?")
        return self._record(node, dt)

    def visit_BinaryExpression(self, node: BinaryExpression) -> Datatype:
        lhs = node.left.accept(self)
        rhs = node.right.accept(self)
        if lhs.type != rhs.type:
            raise CompilerError(
                f"cannot apply operator ({node.operator}) on operands of type "
                f"{lhs.type} and {rhs.type}")
        # result type: operand base type; relational operators stay in the
        # operand type domain like the reference (result used as 0/1)
        secret = lhs.secret or rhs.secret
        return self._record(node, Datatype(lhs.type, secret))

    def visit_OperatorExpression(self, node: OperatorExpression) -> Datatype:
        types = [o.accept(self) for o in node.operands if o is not None]
        base = types[0].type
        if any(t.type != base for t in types):
            raise CompilerError("OperatorExpression operands must share one type")
        secret = any(t.secret for t in types)
        return self._record(node, Datatype(base, secret))

    def visit_UnaryExpression(self, node: UnaryExpression) -> Datatype:
        t = node.operand.accept(self)
        return self._record(node, t)

    def visit_ExpressionList(self, node: ExpressionList) -> Datatype:
        types = [e.accept(self) for e in node.expressions if e is not None]
        if not types:
            raise CompilerError("empty ExpressionList has no type")
        base = types[0].type
        if any(t.type != base for t in types):
            raise CompilerError("values in ExpressionList must all be of the same type")
        secret = any(t.secret for t in types)
        return self._record(node, Datatype(base, secret))

    def visit_IndexAccess(self, node: IndexAccess) -> Datatype:
        target_t = node.target.accept(self)
        index_t = node.index.accept(self)
        if index_t.type != Type.INT:
            raise CompilerError("IndexAccess requires an integer index")
        # taint/type follow the target (ref: TypeCheckingVisitor.cpp:96-108)
        return self._record(node, target_t)

    def visit_Call(self, node: Call) -> Datatype:
        # only rotate(ctxt, steps) is executable; its type/taint follow the
        # rotated expression (improvement over the reference's TODO at
        # TypeCheckingVisitor.cpp:50-53, needed for runtime taint dispatch)
        if node.identifier == "rotate":
            if len(node.arguments) != 2:
                raise CompilerError("rotate() expects exactly two arguments")
            ctxt_t = node.arguments[0].accept(self)
            steps_t = node.arguments[1].accept(self)
            if steps_t.type != Type.INT or steps_t.secret:
                raise CompilerError("rotate() steps must be a public integer")
            return self._record(node, ctxt_t)
        types = [a.accept(self) for a in node.arguments if a is not None]
        secret = any(t.secret for t in types)
        return self._record(node, Datatype(types[0].type if types else Type.VOID, secret))

    def visit_TernaryOperator(self, node: TernaryOperator) -> Datatype:
        cond_t = node.condition.accept(self)
        then_t = node.then_expr.accept(self)
        else_t = node.else_expr.accept(self)
        if then_t.type != else_t.type:
            raise CompilerError("ternary branches must have the same type")
        secret = cond_t.secret or then_t.secret or else_t.secret
        return self._record(node, Datatype(then_t.type, secret))

    def visit_FunctionParameter(self, node: FunctionParameter) -> Datatype:
        scoped_id = self.current_scope.resolve_identifier(node.identifier)
        self.variables_datatype.insert_or_assign(scoped_id, node.parameter_type)
        return self._record(node, node.parameter_type)

    # --- statements ---------------------------------------------------------
    def visit_VariableDeclaration(self, node: VariableDeclaration) -> None:
        # register identifier + declared type BEFORE checking the value
        scoped_id = self.declare(node.target.identifier)
        self.variables_datatype.insert_or_assign(scoped_id, node.datatype)
        tainted = False
        if node.value is not None:
            value_t = node.value.accept(self)
            tainted = self.is_secret_tainted(node.value.unique_node_id)
            if value_t.type != node.datatype.type and not _coercible(value_t.type,
                                                                    node.datatype.type):
                raise CompilerError(
                    f"declared type {node.datatype} does not match value type {value_t}")
        self._taint(node, tainted)

    def visit_Assignment(self, node: Assignment) -> None:
        # visit the target to validate the identifier exists (and index types)
        node.target.accept(self)
        node.value.accept(self)
        self._taint(node, self.is_secret_tainted(node.value.unique_node_id))

    def visit_Return(self, node: Return) -> None:
        tainted = False
        if node.value is not None:
            t = node.value.accept(self)
            self._return_types.append((t, isinstance(node.value, Literal)))
            tainted = self.is_secret_tainted(node.value.unique_node_id)
        self._taint(node, tainted)

    def visit_If(self, node: If) -> None:
        self.enter_scope(node)
        node.condition.accept(self)
        tainted = self.is_secret_tainted(node.condition.unique_node_id)
        node.then_branch.accept(self)
        tainted = tainted or self.is_secret_tainted(node.then_branch.unique_node_id)
        if node.else_branch is not None:
            node.else_branch.accept(self)
            tainted = tainted or self.is_secret_tainted(node.else_branch.unique_node_id)
        self.exit_scope()
        self._taint(node, tainted)

    def visit_For(self, node: For) -> None:
        # initializer/update children are visited WITHOUT opening their own
        # Block scopes so initializer declarations stay visible in the
        # condition/update (ref: TypeCheckingVisitor.cpp:180-198)
        self.enter_scope(node)
        for stmt in node.initializer.children():
            stmt.accept(self)
        node.condition.accept(self)
        for stmt in node.update.children():
            stmt.accept(self)
        node.body.accept(self)
        self.exit_scope()

    def visit_Function(self, node: Function) -> None:
        self.enter_scope(node)
        for p in node.parameters:
            self.declare(p.identifier)
            p.accept(self)
        node.body.accept(self)
        self.exit_scope()
        sig = node.return_type
        if sig.type != Type.VOID and not self._return_types:
            raise CompilerError("return type specified (not void) but no return value found")
        for t, is_literal_value in self._return_types:
            if sig.type == Type.VOID:
                raise CompilerError("return value found although function is declared void")
            if t.type != sig.type:
                raise CompilerError(
                    "type in function signature does not match type of return statement")
            if not is_literal_value and t.secret != sig.secret:
                raise CompilerError(
                    "secretness in function signature does not match secretness of "
                    "return statement (an expression with any secret operand is secret)")
        self._return_types.clear()


def _coercible(value_type: Type, declared: Type) -> bool:
    # bool↔int coercion mirrors the parser's 0/1 handling
    pair = {value_type, declared}
    return pair == {Type.BOOL, Type.INT}


def run_type_checking(ast, inputs: Optional[Dict[str, Datatype]] = None
                      ) -> TypeCheckingVisitor:
    """Convenience entry point: build a root scope over `ast`, pre-register the
    given input variables, and run the checker (mirrors the e2e test harness,
    e.g. HammingDistanceTest.cpp:57-70)."""
    from abc_tpu_torch.utils.scope import Scope

    tcv = TypeCheckingVisitor()
    root = Scope(ast)
    for name, dt in (inputs or {}).items():
        sid = root.add_identifier(name)
        tcv.add_variable_datatype(sid, dt)
    tcv.set_root_scope(root)
    ast.accept(tcv)
    return tcv
