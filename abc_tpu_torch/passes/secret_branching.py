"""Secret-branch circuit lowering: rewrite If statements over secret
conditions into mux arithmetic using the FHE operators.

Reference: src/visitor/SecretBranchingVisitor.cpp (full file). The rewrite
(createDependentAssignment, :34-67):
    if (c) { x = t; } else { x = e; }   ⇒   x = c *** t +++ (1 --- c) *** e
with the one-sided variants c***t (new variable, then-only) and (1---c)***e
(changed only in else). Bails out (leaves the If untouched) when a branch
body contains an unsupported statement — For or Return (:179-182, 213-216).
Statement replacement happens in the Block visit via null-slot + insert
(:184-211).

The lowered program is circuit-compatible: the condition must itself evaluate
to a 0/1 ciphertext (comparisons over encrypted data are not FHE-evaluable
without binary circuits).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, Assignment, BinaryExpression, Block, For, Function,
    FunctionParameter, If, LiteralInt, Return, TernaryOperator, Variable,
    VariableDeclaration,
)
from abc_tpu_torch.passes.visitor import ScopedVisitor
from abc_tpu_torch.utils.operators import Op, Operator
from abc_tpu_torch.utils.scope import ScopedIdentifier
from abc_tpu_torch.utils.errors import CompilerError

# ScopedIdentifier → value expression (None = declared but value unknown)
VariableValueMap = Dict[ScopedIdentifier, Optional[AbstractExpression]]


def _safe_to_reeval(expr: AbstractExpression) -> bool:
    """True when re-evaluating `expr` at a LATER program point provably
    yields the variable's current value: only expressions with no
    variable/index/call references qualify (literal arithmetic).

    The reference substitutes the raw tracked expression unconditionally
    (SecretBranchingVisitor.cpp:34-67), which is unsound the moment the
    expression references mutated state — `r = r + 1; if (sN) {...}`
    emitted a mux whose false side re-ADDED the 1 (found by
    tests/test_pipeline_fuzz.py, round 4). Falling back to a plain
    Variable reference is always correct for initialized variables."""
    from abc_tpu_torch.ast_ir.nodes import Call, IndexAccess
    return not any(isinstance(x, (Variable, IndexAccess, Call))
                   for x in expr.iter_preorder())


def create_dependent_assignment(target_id: str,
                                condition: AbstractExpression,
                                true_value: Optional[AbstractExpression],
                                false_value: Optional[AbstractExpression]
                                ) -> Assignment:
    """x = c***true +++ (1---c)***false (ref: SecretBranchingVisitor.cpp:34-67)."""
    cond_then = condition.clone()
    cond_else = BinaryExpression(LiteralInt(1), Operator(Op.FHE_SUB),
                                 condition.clone())
    if true_value is not None:
        clause_true = BinaryExpression(cond_then, Operator(Op.FHE_MUL), true_value)
        if false_value is not None:
            clause_false = BinaryExpression(cond_else, Operator(Op.FHE_MUL),
                                            false_value)
            return Assignment(Variable(target_id),
                              BinaryExpression(clause_true, Operator(Op.FHE_ADD),
                                               clause_false))
        return Assignment(Variable(target_id), clause_true)
    if false_value is not None:
        return Assignment(Variable(target_id),
                          BinaryExpression(cond_else, Operator(Op.FHE_MUL),
                                           false_value))
    raise CompilerError("dependent assignment needs a true or false value")


class SecretBranchingVisitor(ScopedVisitor):
    """Removes If statements over secret conditions (ref:
    SpecialSecretBranchingVisitor)."""

    def __init__(self, secret_tainted_map: Dict[str, bool]):
        super().__init__()
        self.tainted = secret_tainted_map
        self.expression_values: VariableValueMap = {}
        self._delete_current = False
        self._replacements: List[Assignment] = []
        # branch-entry snapshots, pushed ONLY for branches that WILL be
        # rewritten (decided up front by _will_rewrite); [0] (the outermost
        # such entry) is the symbolic-substitution baseline: statements
        # inside these branches are guaranteed to be DELETED, so values
        # recorded since [0] exist only symbolically. A KEPT enclosing if
        # (plain condition / unsupported body) must NOT contribute a
        # baseline — its statements still execute, and substituting their
        # recorded expressions would double-apply updates (advisor r4).
        self._branch_entry_stack: List[VariableValueMap] = []
        # memoized rewrite decision per If unique_node_id
        self._rewrite_decision: Dict[str, bool] = {}
        # declared datatype per variable, so re-emitted declarations keep
        # the source base type instead of assuming INT (advisor r4)
        self._datatypes: Dict[ScopedIdentifier, "Datatype"] = {}

    # --- rewrite pre-decision --------------------------------------------------
    #
    # Whether an If gets rewritten must be known at BRANCH ENTRY, not after
    # traversal: symbolic value substitution inside the branch is only sound
    # when the branch's statements are guaranteed to be deleted. The round-4
    # advisor found two soundness bugs (double-applied updates under a kept
    # plain enclosing if; a kept nested plain if silently dropped / crashing
    # on None) that both trace to deciding "will this branch be deleted?"
    # with a mutable flag AFTER visiting. The pre-scan below decides it up
    # front, recursively: a secret-condition If rewrites iff every statement
    # in its branches is straight-line (no For/Return, ref
    # SecretBranchingVisitor.cpp:179-182) and every nested If itself
    # rewrites (a kept nested If would be deleted along with the branch,
    # silently dropping its conditional semantics).

    def _will_rewrite(self, node: If) -> bool:
        cached = self._rewrite_decision.get(node.unique_node_id)
        if cached is not None:
            return cached
        cond_id = node.condition.unique_node_id
        if cond_id not in self.tainted:
            raise CompilerError(
                f"no secret-tainting information for condition node {cond_id}")
        result = bool(self.tainted[cond_id])
        if result:
            for branch in (node.then_branch, node.else_branch):
                if branch is not None and not self._branch_supported(branch):
                    result = False
                    break
        self._rewrite_decision[node.unique_node_id] = result
        return result

    def _branch_supported(self, block: Block) -> bool:
        for stmt in block.statements:
            if stmt is None:
                continue
            if isinstance(stmt, (For, Return)):
                return False
            if isinstance(stmt, If):
                if not self._will_rewrite(stmt):
                    return False
            elif isinstance(stmt, Block):
                if not self._branch_supported(stmt):
                    return False
        return True

    def _recorded_in_branch(self, sid, expr) -> bool:
        """True when `expr` is sid's value recorded SINCE the outermost
        branch entry (symbolic: its source statement will be deleted)."""
        if not self._branch_entry_stack or expr is None:
            return False
        base = self._branch_entry_stack[0]
        return sid not in base or expr is not base[sid]

    def _substitute_branch_values(self, expr: AbstractExpression
                                  ) -> AbstractExpression:
        """Clone `expr` with every variable reference whose value was
        assigned earlier IN THE CURRENT BRANCH replaced by that (symbolic)
        value — `{ r = r + 1; r = r * 2; }` must fold to ((r+1)*2), not
        lose the +1 (the raw-expression storage the reference uses drops
        every non-final branch assignment; found by the round-4 fuzz)."""
        if not self._branch_entry_stack:
            return expr

        def value_for(var: Variable):
            try:
                sid = self.current_scope.resolve_identifier(var.identifier)
            except Exception:
                return None
            cur = self.expression_values.get(sid)
            if self._recorded_in_branch(sid, cur):
                return cur.clone()
            return None

        clone = expr.clone()
        if isinstance(clone, Variable):
            v = value_for(clone)
            return v if v is not None else clone
        for node in list(clone.iter_preorder()):
            if isinstance(node, Variable) and node is not clone:
                v = value_for(node)
                if v is not None:
                    node.parent.replace_child(node, v)
        return clone

    # --- secret ternary lowering -----------------------------------------------
    def _lower_ternaries(self, expr: Optional[AbstractExpression]
                         ) -> Optional[AbstractExpression]:
        """c ? a : b with a SECRET condition ⇒ c***a +++ (1---c)***b — the
        expression-level analogue of the If rewrite. The reference's two
        ternary cases are GTEST_SKIP'd pending this
        (SecretBranchingVisitorTest.cpp:359-430); lowered here for real,
        post-order so nested ternaries compose. Plain-condition ternaries
        stay for the runtime to branch on."""
        if expr is None:
            return None
        for child in list(expr.children()):
            if isinstance(child, AbstractExpression):
                lowered = self._lower_ternaries(child)
                if lowered is not child:
                    expr.replace_child(child, lowered)
        if isinstance(expr, TernaryOperator) and \
                self.tainted.get(expr.condition.unique_node_id):
            cond = expr.condition
            clause_true = BinaryExpression(cond.clone(), Operator(Op.FHE_MUL),
                                           expr.then_expr.clone())
            clause_false = BinaryExpression(
                BinaryExpression(LiteralInt(1), Operator(Op.FHE_SUB),
                                 cond.clone()),
                Operator(Op.FHE_MUL), expr.else_expr.clone())
            return BinaryExpression(clause_true, Operator(Op.FHE_ADD),
                                    clause_false)
        return expr

    # --- value tracking -------------------------------------------------------
    def visit_Assignment(self, node: Assignment) -> None:
        node.value = self._lower_ternaries(node.value)
        # only plain-variable targets are tracked (ref: :228-236); inside
        # a branch the recorded value is fully SYMBOLIC (branch-local
        # assignments substituted — their statements get deleted)
        if isinstance(node.target, Variable):
            sid = self.current_scope.resolve_identifier(node.target.identifier)
            self.expression_values[sid] = \
                self._substitute_branch_values(node.value)

    def visit_VariableDeclaration(self, node: VariableDeclaration) -> None:
        if node.value is not None:
            node.value = self._lower_ternaries(node.value)
        sid = self.declare(node.target.identifier)
        self._datatypes[sid] = node.datatype
        # the recorded value must be fully pre-branch-symbolic, exactly
        # like visit_Assignment — an initializer reading a variable already
        # mutated in the same branch captured the pre-mutation reference
        # otherwise (advisor r4)
        self.expression_values[sid] = (
            self._substitute_branch_values(node.value)
            if node.value is not None else None)

    def visit_FunctionParameter(self, node: FunctionParameter) -> None:
        sid = self.declare(node.identifier)
        self._datatypes[sid] = node.parameter_type
        self.expression_values[sid] = None

    # --- loop bodies ----------------------------------------------------------
    def visit_For(self, node: For) -> None:
        before = dict(self.expression_values)
        super().visit_For(node)
        # loop-body recordings are not straight-line values (the body runs
        # 0..N times): any entry the loop changed is now only "the variable
        # holds its current value" (None → Variable-reference fallback)
        for sid, expr in list(self.expression_values.items()):
            if sid not in before or expr is not before[sid]:
                self.expression_values[sid] = None

    def visit_Return(self, node: Return) -> None:
        if node.value is not None:
            node.value = self._lower_ternaries(node.value)

    # --- the rewrite ------------------------------------------------------------
    @staticmethod
    def _changed_variables(base: VariableValueMap, changed: VariableValueMap
                           ) -> VariableValueMap:
        # "changed" = new identifier or different value expression (object
        # identity, ref: :18-31)
        return {sid: expr for sid, expr in changed.items()
                if sid not in base or expr is not base[sid]}

    def visit_If(self, node: If) -> None:
        will_rewrite = self._will_rewrite(node)

        values_before = dict(self.expression_values)
        node.condition.accept(self)
        if will_rewrite:
            self._branch_entry_stack.append(values_before)
        node.then_branch.accept(self)
        values_after_then = dict(self.expression_values)
        values_after_else: VariableValueMap = {}
        if node.else_branch is not None:
            self.expression_values = dict(values_before)
            node.else_branch.accept(self)
            values_after_else = dict(self.expression_values)
        if will_rewrite:
            self._branch_entry_stack.pop()

        if not will_rewrite:
            # plain condition or unsupported body: the If stays in the
            # program, so its branches execute CONDITIONALLY — recordings
            # made inside them must not survive as known values (a later
            # secret-if would substitute a value the runtime may never
            # have assigned). Restore the pre-if map and mark every
            # branch-touched variable value-unknown.
            merged = dict(values_before)
            for m in (values_after_then, values_after_else):
                for sid, expr in m.items():
                    if sid not in values_before or \
                            expr is not values_before[sid]:
                        merged[sid] = None
            self.expression_values = merged
            return

        self._delete_current = True
        cond = node.condition
        emitted: List = []

        def emit(sid, assignment):
            """Branch-DECLARED variables lose their declaration with the
            deleted branch: re-emit as a declaration carrying the mux
            value — the source base type, marked secret (it is a
            secret-condition mux) — so the program stays well-formed;
            pre-existing variables keep the plain assignment."""
            self.expression_values[sid] = assignment.value
            if sid in values_before:
                emitted.append(assignment)
            else:
                emitted.append(VariableDeclaration(
                    self._mux_datatype(sid),
                    Variable(sid.identifier), assignment.value))

        if node.else_branch is None:
            changed = self._changed_variables(values_before, values_after_then)
            for sid, expr in changed.items():
                if sid in values_before:
                    # oldValue: the prior expression when it is SYMBOLIC
                    # (recorded in an enclosing branch — its statement gets
                    # deleted, so the expression is the only record) or
                    # safe to re-evaluate (literal arithmetic); else a
                    # self-reference, which is also the reference's
                    # uninitialized-variable emission (ref: :115-123)
                    old = values_before[sid]
                    if old is not None and (
                            self._recorded_in_branch(sid, old)
                            or _safe_to_reeval(old)):
                        old_expr = old.clone()
                    else:
                        old_expr = Variable(sid.identifier)
                    assignment = create_dependent_assignment(
                        sid.identifier, cond, expr.clone(), old_expr)
                else:
                    # declared inside the then branch only
                    assignment = create_dependent_assignment(
                        sid.identifier, cond, expr.clone(), None)
                emit(sid, assignment)
        else:
            then_modified = self._changed_variables(values_before, values_after_then)
            else_modified = self._changed_variables(values_before, values_after_else)
            for sid, expr in then_modified.items():
                if sid in else_modified:
                    assignment = create_dependent_assignment(
                        sid.identifier, cond, expr.clone(),
                        else_modified.pop(sid).clone())
                else:
                    assignment = create_dependent_assignment(
                        sid.identifier, cond, expr.clone(), None)
                emit(sid, assignment)
            for sid, expr in else_modified.items():
                assignment = create_dependent_assignment(
                    sid.identifier, cond, None, expr.clone())
                emit(sid, assignment)
        self._replacements.extend(self._emit_with_snapshots(emitted))

    _snap_counter = 0

    def _mux_datatype(self, sid: ScopedIdentifier):
        """Datatype for a synthesized declaration holding a secret mux of
        `sid`'s values: the declared base type (bool/float/… preserved,
        advisor r4), secret=True (the mux condition is secret)."""
        from abc_tpu_torch.utils.datatype import Datatype, Type
        dt = self._datatypes.get(sid)
        return Datatype(dt.type if dt is not None else Type.INT, secret=True)

    def _ident_mux_datatype(self, identifier: str):
        """_mux_datatype by identifier, resolved in the current (flat)
        scope — used for snapshot temporaries in _emit_with_snapshots."""
        from abc_tpu_torch.utils.datatype import Datatype, Type
        try:
            sid = self.current_scope.resolve_identifier(identifier)
        except Exception:
            return Datatype(Type.INT, secret=True)
        return self._mux_datatype(sid)

    def _emit_with_snapshots(self, assignments: List[Assignment]
                             ) -> List:
        """The emitted muxes execute SEQUENTIALLY, but every variable
        reference inside them means the PRE-branch value — a mux reading a
        variable another mux already overwrote would use the post-mux
        value ({ r = r + 1; q = q + r; } read r's mux result into q,
        found by the round-4 fuzz). Emit `__sbN_x = x;` snapshot copies
        for every changed variable referenced by a DIFFERENT variable's
        mux, and point those references at the snapshots. The recorded
        symbolic values (expression_values) stay clean — outer secret-if
        folds delete these statements wholesale."""
        if len(assignments) <= 1:
            return list(assignments)
        changed = {a.target.identifier for a in assignments}
        need = set()
        for a in assignments:
            for n in a.value.iter_preorder():
                if isinstance(n, Variable) and n.identifier in changed \
                        and n.identifier != a.target.identifier:
                    need.add(n.identifier)
        if not need:
            return list(assignments)
        SecretBranchingVisitor._snap_counter += 1
        snap = {ident: f"__sb{self._snap_counter}_{ident}"
                for ident in sorted(need)}
        out: List = []
        for ident, tmp in snap.items():
            out.append(VariableDeclaration(
                self._ident_mux_datatype(ident), Variable(tmp),
                Variable(ident)))
        for a in assignments:
            value = a.value.clone()
            if isinstance(value, Variable) and value.identifier in snap:
                value = Variable(snap[value.identifier])
            else:
                for n in list(value.iter_preorder()):
                    if isinstance(n, Variable) and n.identifier in snap \
                            and n is not value:
                        n.parent.replace_child(n, Variable(snap[n.identifier]))
            if isinstance(a, VariableDeclaration):    # branch-declared var
                out.append(VariableDeclaration(
                    a.datatype, Variable(a.target.identifier), value))
            else:
                out.append(Assignment(Variable(a.target.identifier), value))
        return out

    def visit_Block(self, node: Block) -> None:
        # no scope entry: mirrors the reference's flat resolution so branch
        # variables compare equal across then/else (ref Block visit
        # :184-211). Replacements are spliced IN PLACE of each deleted If
        # immediately — the reference's collect-then-insert-at-last-slot
        # scheme reordered the first If's muxes past any statements between
        # two secret Ifs in the same block (found by the round-4 fuzz:
        # `if(..){r=..} r = r + s1; if(..){..}` executed the r update
        # before the first mux).
        new_stmts: List = []
        for stmt in node.statements:
            if stmt is None:
                continue
            stmt.accept(self)
            if self._delete_current:
                self._delete_current = False
                for repl in self._replacements:
                    repl.parent = node
                    new_stmts.append(repl)
                self._replacements.clear()
            else:
                new_stmts.append(stmt)
        node.statements[:] = new_stmts


def run_secret_branching(ast, tainted_map, input_identifiers=()):
    """Convenience entry point mirroring the e2e test harness usage; program
    inputs (declared in the separate input AST) are pre-registered in the
    root scope with unknown values, like FunctionParameters."""
    from abc_tpu_torch.utils.scope import Scope

    sbv = SecretBranchingVisitor(tainted_map)
    root = Scope(ast)
    for name in input_identifiers:
        sid = root.add_identifier(name)
        sbv.expression_values[sid] = None
    sbv.set_root_scope(root)
    ast.accept(sbv)
    return sbv
