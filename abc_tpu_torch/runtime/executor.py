"""Program executor — the RuntimeVisitor equivalent.

Reference: src/runtime/RuntimeVisitor.cpp (full file) / RuntimeVisitor.h:30-139.
Protocol (mirrored exactly, see RuntimeVisitorTest.cpp:15-108):
  * constructor takes (factory, input AST, secret-tainted map); the input AST
    must be a Block of VariableDeclarations — secret ones are encrypted
    (RuntimeVisitor.cpp:445-479)
  * execute_ast(program) runs the program; a Return statement unwinds via the
    ReturnStatementReached exception (RuntimeVisitor.h:16-24)
  * get_output(output AST) expects a Block of `y = var` / `y = var[i]`
    assignments; the IndexAccess form decodes as a row rotation by i
    (RuntimeVisitor.cpp:489-530)
Semantics mirrored: cleartext-only For conditions evaluated per iteration
(RuntimeVisitor.cpp:198-239), plain If executes one branch while secret Ifs
must have been lowered (:245-269), secret-aware operand ordering with
commutativity swap (:58-64), rotate only on ciphertext variables (:128-159).

Deliberate deviations (documented, all strict supersets):
  * assigning a plain value to a secret variable encrypts it (the reference's
    cast would throw);
  * rotate() accepts an arbitrary ciphertext expression and any scalar-int
    steps expression (the reference requires Variable + LiteralInt);
  * values are immutable, so no defensive ciphertext clone per variable read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, Assignment, BinaryExpression, Block, Call, ExpressionList,
    For, Function, If, IndexAccess, Literal, OperatorExpression, Return,
    TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.values import (
    AbstractCiphertext, AbstractValue, Cleartext, LazyMaskedCiphertext,
    unwrap_value)
from abc_tpu_torch.utils.datatype import Datatype, Type
from abc_tpu_torch.utils.errors import RuntimeExecutionError

OutputIdentifierValuePairs = List[Tuple[str, AbstractValue]]


class ReturnStatementReached(Exception):
    """Raised to unwind when a Return executes (ref: RuntimeVisitor.h:16-24)."""


class _Env:
    """Chain of lexical environments mapping identifier → (Datatype, value)."""

    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: Dict[str, Tuple[Datatype, AbstractValue]] = {}
        self.parent = parent

    def declare(self, name: str, datatype: Datatype, value: AbstractValue) -> None:
        self.vars[name] = (datatype, value)

    def _find(self, name: str) -> "_Env":
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        raise RuntimeExecutionError(f"variable {name!r} is not declared")

    def lookup(self, name: str) -> Tuple[Datatype, AbstractValue]:
        return self._find(name).vars[name]

    def assign(self, name: str, value: AbstractValue) -> None:
        env = self._find(name)
        dt = env.vars[name][0]
        env.vars[name] = (dt, value)


class RuntimeVisitor:
    """Tree-walking executor over a circuit-compatible AST."""

    def __init__(self, factory: AbstractCiphertextFactory, input_ast: AbstractNode,
                 secret_tainted_map: Dict[str, bool]):
        self.factory = factory
        self.tainted = secret_tainted_map
        self.globals = _Env()
        self.env = self.globals
        self.return_value: Optional[AbstractValue] = None
        # encrypt the program inputs (ref: RuntimeVisitor.cpp:473-479)
        self._check_ast_structure(input_ast, VariableDeclaration, "input")
        for decl in input_ast.children():
            self._exec_variable_declaration(decl)

    # --- public API ---------------------------------------------------------
    def execute_ast(self, program: AbstractNode) -> None:
        try:
            if isinstance(program, Block):
                for stmt in program.children():
                    self._exec(stmt)
            else:
                self._exec(program)
        except ReturnStatementReached:
            pass

    def get_output(self, output_ast: AbstractNode) -> OutputIdentifierValuePairs:
        self._check_ast_structure(output_ast, Assignment, "output")
        out: OutputIdentifierValuePairs = []
        for assignment in output_ast.children():
            name = assignment.target.identifier
            value = assignment.value
            if isinstance(value, Variable):
                _, stored = self.globals.lookup(value.identifier)
                out.append((name, unwrap_value(stored)))
            elif isinstance(value, IndexAccess):
                if not isinstance(value.target, Variable) or not isinstance(
                        value.index, Literal):
                    raise RuntimeExecutionError(
                        "output AST index access must be var[int-literal]")
                _, stored = self.globals.lookup(value.target.identifier)
                if not isinstance(stored, AbstractCiphertext):
                    raise RuntimeExecutionError(
                        "output AST index-access decode requires a ciphertext")
                out.append((name, stored.rotate_rows(value.index.value)))
            else:
                raise RuntimeExecutionError(
                    "output AST right-hand side must be a Variable or IndexAccess")
        return out

    def print_output(self, output_ast: AbstractNode) -> str:
        # ref: RuntimeVisitor.cpp:532-543
        lines = []
        for name, val in self.get_output(output_ast):
            if isinstance(val, AbstractCiphertext):
                lines.append(f"{name}: {self.factory.get_string(val)}")
            else:
                lines.append(f"{name}: {val.values}")
        return "\n".join(lines)

    # --- helpers --------------------------------------------------------------
    @staticmethod
    def _check_ast_structure(ast: AbstractNode, stmt_type, which: str) -> None:
        # ref: checkAstStructure, RuntimeVisitor.cpp:445-471
        if not isinstance(ast, Block):
            raise RuntimeExecutionError(f"root of {which} AST must be a Block")
        for stmt in ast.children():
            if not isinstance(stmt, stmt_type):
                raise RuntimeExecutionError(
                    f"{which} AST must contain only {stmt_type.__name__} statements")
            if stmt_type is Assignment and not isinstance(stmt.target, Variable):
                raise RuntimeExecutionError(
                    "output AST assignments must target plain variables")

    def _is_tainted(self, node: AbstractNode) -> bool:
        return self.tainted.get(node.unique_node_id, False)

    def _push_scope(self) -> None:
        self.env = _Env(self.env)

    def _pop_scope(self) -> None:
        assert self.env.parent is not None
        self.env = self.env.parent

    # --- statements -----------------------------------------------------------
    def _exec(self, stmt) -> None:
        if isinstance(stmt, VariableDeclaration):
            self._exec_variable_declaration(stmt)
        elif isinstance(stmt, Assignment):
            self._exec_assignment(stmt)
        elif isinstance(stmt, Block):
            self._push_scope()
            try:
                for s in stmt.children():
                    self._exec(s)
            finally:
                self._pop_scope()
        elif isinstance(stmt, For):
            self._exec_for(stmt)
        elif isinstance(stmt, If):
            self._exec_if(stmt)
        elif isinstance(stmt, Return):
            if stmt.value is not None:
                # unwrap so external callers (factory.decrypt) never see a
                # LazyMaskedCiphertext view
                self.return_value = unwrap_value(self._eval(stmt.value))
            raise ReturnStatementReached()
        elif isinstance(stmt, Function):
            raise RuntimeExecutionError(
                "Function statements are not supported by the executor "
                "(ref: RuntimeVisitor.cpp:241-243)")
        else:
            raise RuntimeExecutionError(f"cannot execute statement {stmt.node_type}")

    def _exec_variable_declaration(self, decl: VariableDeclaration) -> None:
        if decl.value is None:
            raise RuntimeExecutionError(
                "variable declaration without initializer is not supported; "
                "please specify an initialization value")
        value = self._eval(decl.value)
        name = decl.target.identifier
        if decl.datatype.secret:
            if not isinstance(value, AbstractCiphertext):
                value = self.factory.create_ciphertext(value)
            self.env.declare(name, decl.datatype, value)
        else:
            if isinstance(value, AbstractCiphertext):
                raise RuntimeExecutionError(
                    f"cannot initialize plain variable {name!r} with a ciphertext")
            self.env.declare(name, decl.datatype, value)

    def _exec_assignment(self, stmt: Assignment) -> None:
        value = self._eval(stmt.value)
        target = stmt.target
        if isinstance(target, Variable):
            dt, _ = self.env.lookup(target.identifier)
            if isinstance(value, AbstractCiphertext):
                self.env.assign(target.identifier, value)
            elif dt.secret:
                # deviation: encrypt instead of throwing (see module docstring)
                self.env.assign(target.identifier, self.factory.create_ciphertext(value))
            else:
                self.env.assign(target.identifier, value)
        elif isinstance(target, IndexAccess):
            # only simple var[index] on cleartexts (ref: RuntimeVisitor.cpp:362-381)
            if not isinstance(target.target, Variable):
                raise RuntimeExecutionError(
                    "only simple, non-nested IndexAccess assignment is supported")
            idx = self._eval_scalar_int(target.index, "index of IndexAccess")
            name = target.target.identifier
            dt, stored = self.env.lookup(name)
            if isinstance(stored, AbstractCiphertext):
                # Masked slot write on a ciphertext store (beyond the
                # reference, which only supports cleartext vectors,
                # RuntimeVisitor.cpp:362-381): algebraically
                # x' = x*keep + onehot*align(value). Writes are DEFERRED via
                # LazyMaskedCiphertext so N writes cost one keep-mask multiply
                # at materialization instead of compounding ~log2(n*t) noise
                # bits into the store per write. A ciphertext value is
                # slot-0-aligned (see _eval_index_access) and moved to slot
                # idx by the inverse rotation inside with_slot_write.
                if not isinstance(stored, LazyMaskedCiphertext):
                    stored = LazyMaskedCiphertext(stored,
                                                  self.factory.slot_count)
                self.env.assign(name, stored.with_slot_write(idx, value))
            elif not isinstance(stored, Cleartext):
                raise RuntimeExecutionError(
                    "indexed assignment requires a vector store")
            elif not isinstance(value, Cleartext):
                raise RuntimeExecutionError(
                    "indexed assignment of a secret value into a cleartext "
                    "vector is not supported (declare the vector secret)")
            else:
                self.env.assign(name,
                                stored.with_value_at_index(idx, value.scalar()))
        else:
            raise RuntimeExecutionError("assignment target must be Variable or IndexAccess")

    def _exec_for(self, stmt: For) -> None:
        # loops run at runtime with cleartext conditions, not unrolled
        # (ref: RuntimeVisitor.cpp:198-239)
        if self._is_tainted(stmt.condition):
            raise RuntimeExecutionError(
                "For loops over secret conditions are not supported")
        self._push_scope()
        try:
            for init in stmt.initializer.children():
                self._exec(init)
            while self._eval_condition(stmt.condition):
                self._push_scope()
                try:
                    for s in stmt.body.children():
                        self._exec(s)
                finally:
                    self._pop_scope()
                for upd in stmt.update.children():
                    self._exec(upd)
        finally:
            self._pop_scope()

    def _exec_if(self, stmt: If) -> None:
        if self._is_tainted(stmt.condition):
            raise RuntimeExecutionError(
                "If statements over secret conditions must be lowered by the "
                "secret-branching pass before execution")
        if self._eval_condition(stmt.condition):
            self._exec(stmt.then_branch)
        elif stmt.else_branch is not None:
            self._exec(stmt.else_branch)

    def _eval_condition(self, expr) -> bool:
        result = self._eval(expr)
        if not isinstance(result, Cleartext):
            raise RuntimeExecutionError("condition must be evaluable to a cleartext bool")
        if not result.all_equal():
            raise RuntimeExecutionError("condition did not evaluate to a scalar bool")
        return bool(result.values[0])

    # --- expressions ------------------------------------------------------------
    def _eval(self, expr) -> AbstractValue:
        if isinstance(expr, Literal):
            return Cleartext.from_scalar(expr.value, expr.literal_type)
        if isinstance(expr, Variable):
            return self.env.lookup(expr.identifier)[1]
        if isinstance(expr, ExpressionList):
            values = []
            dtype = Type.INT
            for e in expr.expressions:
                if e is None:
                    continue
                v = self._eval(e)
                if not isinstance(v, Cleartext):
                    raise RuntimeExecutionError(
                        "ExpressionList elements must evaluate to cleartexts")
                values.append(v.scalar())
                dtype = v.dtype
            return Cleartext(values, dtype)
        if isinstance(expr, BinaryExpression):
            return self._eval_binary(expr)
        if isinstance(expr, OperatorExpression):
            # n-ary fold (the reference leaves this unimplemented,
            # RuntimeVisitor.cpp:325-327; needed by the batching passes)
            operands = [self._eval(o) for o in expr.operands if o is not None]
            result = operands[0]
            for rhs in operands[1:]:
                result = self._apply_binary(expr.operator.op, result, rhs)
            return result
        if isinstance(expr, UnaryExpression):
            operand = self._eval(expr.operand)
            if isinstance(operand, AbstractCiphertext):
                raise RuntimeExecutionError(
                    "unary operators on ciphertexts are not supported")
            return operand.unary_op(expr.operator.op)
        if isinstance(expr, IndexAccess):
            return self._eval_index_access(expr)
        if isinstance(expr, Call):
            return self._eval_call(expr)
        if isinstance(expr, TernaryOperator):
            if self._is_tainted(expr.condition):
                raise RuntimeExecutionError(
                    "ternary over a secret condition must be lowered first")
            branch = expr.then_expr if self._eval_condition(expr.condition) \
                else expr.else_expr
            return self._eval(branch)
        raise RuntimeExecutionError(f"cannot evaluate expression {expr.node_type}")

    def _eval_binary(self, expr: BinaryExpression) -> AbstractValue:
        lhs = self._eval(expr.left)
        rhs = self._eval(expr.right)
        return self._apply_binary(expr.operator.op, lhs, rhs)

    @staticmethod
    def _apply_binary(op, lhs: AbstractValue, rhs: AbstractValue) -> AbstractValue:
        lhs_ct = isinstance(lhs, AbstractCiphertext)
        rhs_ct = isinstance(rhs, AbstractCiphertext)
        if lhs_ct:
            return lhs.apply_binary_op(op, rhs, self_is_lhs=True)
        if rhs_ct:
            # ciphertext must carry the op; handles the commutative swap and
            # plain-minus-ciphertext (ref: RuntimeVisitor.cpp:58-64)
            return rhs.apply_binary_op(op, lhs, self_is_lhs=False)
        return lhs.binary_op(op, rhs)

    def _eval_index_access(self, expr: IndexAccess) -> AbstractValue:
        target = self._eval(expr.target)
        idx = self._eval_scalar_int(expr.index, "IndexAccess index")
        if isinstance(target, AbstractCiphertext):
            # Slot-0-aligned secret read: ct[i] ≡ rotate(ct, i), the same
            # decode convention the output AST uses (RuntimeVisitor.cpp:
            # 489-530). Slots other than 0 carry rotated garbage; every
            # consumer of a secret scalar reads slot 0. This implements the
            # reference's TODO ("Implement IndexAccess for secret
            # variables", LaplaceSharpeningTest.cpp:180) that kept its only
            # SEAL end-to-end test disabled.
            return target.rotate_rows(idx) if idx else target
        if not isinstance(target, Cleartext):
            raise RuntimeExecutionError("IndexAccess target must be a cleartext vector")
        try:
            return Cleartext.from_scalar(target.values[idx], target.dtype)
        except IndexError:
            raise RuntimeExecutionError(
                f"index {idx} out of range for vector of length {len(target.values)}")

    def _eval_call(self, expr: Call) -> AbstractValue:
        if expr.identifier != "rotate":
            raise RuntimeExecutionError(
                "calls other than rotate(ciphertext, steps) are not supported")
        if len(expr.arguments) != 2:
            raise RuntimeExecutionError("rotate requires (ciphertext, steps)")
        ctxt = self._eval(expr.arguments[0])
        steps = self._eval_scalar_int(expr.arguments[1], "rotate() steps")
        if isinstance(ctxt, Cleartext):
            # plain vector rotation (the batching passes emit rotate() on
            # packed PLAIN inputs too; the reference only supports the
            # ciphertext case, RuntimeVisitor.cpp:128-159)
            vals = list(ctxt.values)
            if vals and not ctxt.all_equal():
                s = steps % len(vals)
                vals = vals[s:] + vals[:s]
            return Cleartext(vals, ctxt.dtype)
        if not isinstance(ctxt, AbstractCiphertext):
            raise RuntimeExecutionError("rotate() requires a ciphertext argument")
        return ctxt.rotate_rows(steps)

    def _eval_scalar_int(self, expr, what: str) -> int:
        v = self._eval(expr)
        if not isinstance(v, Cleartext) or not v.all_equal():
            raise RuntimeExecutionError(f"{what} must be a scalar integer")
        return int(v.values[0])
