"""Automatic SIMD batching — the Vectorizer / ExpressionBatcher.

Reference: the WIP skeleton at src/visitor/Vectorizer.cpp /
ExpressionBatcher.cpp and the design doc in Vectorizer.h:16-107 (batching
compatibility = same structure + compatible slot constraints +
rotation-compatibility; log-depth rotate-reduce; offset-normalized expression
reuse). The reference never finished this pass — its DISABLED tests are the
executable spec (VectorizerTest.cpp:7-260):
  * trivialVectors:            x[0..9]=y[0..9]           ⇒ x = y
  * trivialInterleavedVectors: interleaved x/a plans coexist
  * singleOutlierVector:       literal outlier           ⇒ mask-mult + add
  * sumStatements*:            accumulation chains       ⇒ rotate-reduce
                               (ExpressionBatcher.cpp:306-323 pattern)
  * matrixVectorTest:          flattened matvec          ⇒ b-rotation form
  * batchableExpression:       x=(a*b)+(c*d)             ⇒ packed columns
  * batchableExpressionVectorizable: per-slot products   ⇒ one packed plan
  * cardioTest(+Simplified/MegaExpression): guarded-comparison chains
                               ⇒ flags***(lhs>rhs) + affine corrections

Algorithm implemented here:
  1. Scan a straight-line Block (post-unroll, literal indices).
  2. Indexed writes  `x[i] = expr`  accumulate into per-variable SLOT PLANS.
     Each slot's expression is OFFSET-NORMALIZED: every leaf v[j] becomes
     (v, j−i) so slot-invariant structure is detectable; leaves may be
     (rot, v, δ) | per-slot constants | broadcast scalar variables.
  3. Accumulations `s = s + E_j` (E_j slot-normalized against j) become
     REDUCTION PLANS: the batched elementwise E, then the log-depth
     rotate-and-add  s = s + rotate(s, k/2) … rotate(s, 1), masking up to a
     power of two when the count requires it. Requires s provably zero
     before the chain (tracked), since the reduce overwrites all slots.
  4. Emission covers: full coverage (x = E), literal outliers (mask-mult +
     add, the singleOutlier spec), and partial coverage
     (x = x***keep + E***write) for kernels that only write interior slots.
  5. Batched slot-0 results are reported via auxiliary information
     (ref: the getAuxiliaryInformation stub, Vectorizer.cpp:86-89).

Vectors with incompatible slot expressions are left untouched (the pass is
sound: it only rewrites when it can prove the batched form equivalent on the
written slots; unwritten tail slots become unspecified, which the auxiliary
report records).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, Assignment, BinaryExpression, Block, Call,
    ExpressionList, IndexAccess, Literal, LiteralInt, UnaryExpression,
    Variable, VariableDeclaration,
)
from abc_tpu_torch.utils.operators import Op, Operator

# ---------------------------------------------------------------------------
# offset normalization
# ---------------------------------------------------------------------------
# A normalized expression is a nested tuple template whose leaves are:
#   ("rot", var_name, delta)   — v[slot+delta]
#   ("const", value)           — literal (may vary per slot → vector constant)
#   ("var", name)              — broadcast scalar variable read
# Templates from different slots match iff the tuple trees are equal except
# for ("const", ·) leaf VALUES (compared structurally via _template_key).


def normalize(expr: AbstractExpression, slot: int) -> Optional[tuple]:
    if isinstance(expr, Literal):
        return ("const", expr.value)
    if isinstance(expr, Variable):
        return ("var", expr.identifier)
    if isinstance(expr, IndexAccess):
        if isinstance(expr.target, Variable) and isinstance(expr.index, Literal) \
                and isinstance(expr.index.value, int):
            return ("rot", expr.target.identifier, expr.index.value - slot)
        return None
    if isinstance(expr, BinaryExpression):
        left = normalize(expr.left, slot)
        right = normalize(expr.right, slot)
        if left is None or right is None:
            return None
        return ("bin", str(expr.operator), left, right)
    if isinstance(expr, UnaryExpression):
        inner = normalize(expr.operand, slot)
        if inner is None:
            return None
        return ("un", str(expr.operator), inner)
    return None


def _template_key(norm: tuple) -> tuple:
    """Structure with const VALUES erased (for cross-slot matching)."""
    kind = norm[0]
    if kind == "const":
        return ("const",)
    if kind in ("rot", "var"):
        return norm
    if kind == "bin":
        return ("bin", norm[1], _template_key(norm[2]), _template_key(norm[3]))
    return ("un", norm[1], _template_key(norm[2]))


def _collect_consts(norm: tuple, out: list) -> None:
    kind = norm[0]
    if kind == "const":
        out.append(norm[1])
    elif kind == "bin":
        _collect_consts(norm[2], out)
        _collect_consts(norm[3], out)
    elif kind == "un":
        _collect_consts(norm[2], out)


def _reads_of(norm: tuple, out: set) -> None:
    kind = norm[0]
    if kind in ("rot", "var"):
        out.add(norm[1])
    elif kind == "bin":
        _reads_of(norm[2], out)
        _reads_of(norm[3], out)
    elif kind == "un":
        _reads_of(norm[2], out)


# ---------------------------------------------------------------------------
# emission helpers
# ---------------------------------------------------------------------------

def _vec(values: Sequence[int], trailing: Optional[int]) -> ExpressionList:
    """Vector literal; `trailing` pins the padding value (encode repeats the
    LAST element to all remaining slots, SealCiphertextFactory.cpp:102-115)."""
    vals = list(values)
    if trailing is not None and (not vals or vals[-1] != trailing):
        vals.append(trailing)
    return ExpressionList([LiteralInt(v) for v in vals])


def _rotate(expr: AbstractExpression, steps: int) -> AbstractExpression:
    return expr if steps == 0 else Call("rotate", [expr, LiteralInt(steps)])


def _emit_template(norm_by_slot: Dict[int, tuple], slots: List[int]) -> AbstractExpression:
    """Instantiate the shared template of `slots` as one batched expression."""
    first = norm_by_slot[slots[0]]

    def build(path_consts: List[List[int]], norm: tuple) -> AbstractExpression:
        kind = norm[0]
        if kind == "rot":
            return _rotate(Variable(norm[1]), norm[2])
        if kind == "var":
            return Variable(norm[1])
        if kind == "const":
            consts = path_consts.pop(0)
            if all(c == consts[0] for c in consts):
                return LiteralInt(consts[0])
            # per-slot constant vector (assumes slots are 0..N-1 in order)
            return _vec(consts, trailing=0)
        if kind == "bin":
            return BinaryExpression(build(path_consts, norm[2]),
                                    Operator.from_symbol(norm[1]),
                                    build(path_consts, norm[3]))
        return UnaryExpression(build(path_consts, norm[2]),
                               Operator.from_symbol(norm[1]))

    # gather the const leaves of each slot in template order
    const_columns: List[List[int]] = []
    per_slot = []
    for s in slots:
        consts: list = []
        _collect_consts(norm_by_slot[s], consts)
        per_slot.append(consts)
    num_consts = len(per_slot[0])
    for ci in range(num_consts):
        const_columns.append([per_slot[si][ci] for si in range(len(slots))])
    return build(const_columns, first)


def _flatten_chain(expr: AbstractExpression,
                   ops: tuple) -> Optional[List[AbstractExpression]]:
    """Operand list of a same-family binary chain, or None if expr's root
    is not in the family."""
    if not (isinstance(expr, BinaryExpression) and expr.operator.op in ops):
        return None
    out: List[AbstractExpression] = []

    def walk(e: AbstractExpression) -> None:
        if isinstance(e, BinaryExpression) and e.operator.op in ops:
            walk(e.left)
            walk(e.right)
        else:
            out.append(e)

    walk(expr)
    return out


def _root_op(expr: AbstractExpression) -> Op:
    return expr.operator.op


def _flatten_norm_sum(norm: tuple):
    """Flatten a normalized ("bin", +) chain → (op_str, [term tuples])."""
    if norm[0] != "bin" or norm[1] not in ("+", "+++"):
        return None
    op_str = norm[1]
    out: List[tuple] = []

    def walk(t: tuple) -> None:
        if t[0] == "bin" and t[1] == op_str:
            walk(t[2])
            walk(t[3])
        else:
            out.append(t)

    walk(norm)
    return op_str, out


def _parse_norm_product(t: tuple):
    """("bin", *, (rot,n1,d1), (rot,n2,d2)) → (op_str, (n1,d1), (n2,d2))."""
    if t[0] != "bin" or t[1] not in ("*", "***"):
        return None
    l, r = t[2], t[3]
    if l[0] != "rot" or r[0] != "rot":
        return None
    return t[1], (l[1], l[2]), (r[1], r[2])


def _flatten_norm_product(t: tuple):
    """Flatten a normalized ("bin", *) chain → (op_str, [factor tuples])."""
    if t[0] != "bin" or t[1] not in ("*", "***"):
        return None
    op_str = t[1]
    out: List[tuple] = []

    def walk(x: tuple) -> None:
        if x[0] == "bin" and x[1] == op_str:
            walk(x[2])
            walk(x[3])
        else:
            out.append(x)

    walk(t)
    return op_str, out


# ---------------------------------------------------------------------------
# condition terms (the cardio packing specs)
# ---------------------------------------------------------------------------
# A condition term is  flag && (lhs > rhs)  /  (lhs > rhs)  /  bare flag,
# where each comparison side is a variable, an int literal, or var ± const.
# Sides are parsed to (elem, delta): elem = ("var", name) | ("const", v).


def _parse_cond_side(e: AbstractExpression):
    if isinstance(e, Literal) and isinstance(e.value, int):
        return (("const", int(e.value)), 0)
    if isinstance(e, Variable):
        return (("var", e.identifier), 0)
    if isinstance(e, BinaryExpression):
        op = e.operator.as_plain().op
        if op not in (Op.ADD, Op.SUB):
            return None
        l, r = e.left, e.right
        if isinstance(l, Variable) and isinstance(r, Literal) \
                and isinstance(r.value, int):
            return (("var", l.identifier),
                    int(r.value) if op == Op.ADD else -int(r.value))
        if op == Op.ADD and isinstance(l, Literal) \
                and isinstance(l.value, int) and isinstance(r, Variable):
            return (("var", r.identifier), int(l.value))
    return None


def _parse_comparison(e: AbstractExpression):
    """Normalize a > b / a < b to GREATER orientation → (lhs, rhs) sides."""
    if not isinstance(e, BinaryExpression):
        return None
    if e.operator.op == Op.GREATER:
        l, r = e.left, e.right
    elif e.operator.op == Op.LESS:
        l, r = e.right, e.left
    else:
        return None
    ls, rs = _parse_cond_side(l), _parse_cond_side(r)
    if ls is None or rs is None:
        return None
    return ls, rs


_TRIVIAL_SIDES = ((("const", 1), 0), (("const", 0), 0))


def _parse_condition_term(e: AbstractExpression):
    """→ (flag_elem, (lhs_elem, ldelta), (rhs_elem, rdelta)) or None.
    Bare flags become  flag && (1 > 0)."""
    if isinstance(e, Variable):
        return (("var", e.identifier), *_TRIVIAL_SIDES)
    if isinstance(e, Literal) and isinstance(e.value, int):
        return (("const", int(e.value)), *_TRIVIAL_SIDES)
    cmp = _parse_comparison(e)
    if cmp is not None:
        return (("const", 1), cmp[0], cmp[1])
    if isinstance(e, BinaryExpression) and \
            e.operator.op in (Op.LOGICAL_AND, Op.MUL, Op.FHE_MUL):
        for flag_side, cmp_side in ((e.left, e.right), (e.right, e.left)):
            if isinstance(flag_side, Variable):
                flag = ("var", flag_side.identifier)
            elif isinstance(flag_side, Literal) and \
                    isinstance(flag_side.value, int):
                flag = ("const", int(flag_side.value))
            else:
                continue
            c = _parse_comparison(cmp_side)
            if c is not None:
                return (flag, c[0], c[1])
    return None


def _is_real_comparison(term: tuple) -> bool:
    return (term[1], term[2]) != _TRIVIAL_SIDES


def _cond_term_reads(term: tuple) -> set:
    out = set()
    for elem in (term[0], term[1][0], term[2][0]):
        if elem[0] == "var":
            out.add(elem[1])
    return out


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclass
class SlotPlan:
    target: str
    slots: Dict[int, tuple] = field(default_factory=dict)   # slot → normalized
    statement_positions: List[int] = field(default_factory=list)
    # True when the target held a DEFINED value before the first write
    # (initialized declaration, input, or earlier whole-variable
    # assignment). Initialized ciphertexts are fully slot-defined
    # (last-element padding), so overwriting emissions (x = E) would
    # clobber live tail slots — only the masked partial-coverage form is
    # sound (round-5 write-emission fuzz).
    target_defined: bool = False

    def reads(self) -> set:
        out: set = set()
        for norm in self.slots.values():
            _reads_of(norm, out)
        return out


@dataclass
class ReductionPlan:
    target: str
    op: Op
    entries: List[tuple] = field(default_factory=list)      # normalized E_j
    statement_positions: List[int] = field(default_factory=list)


@dataclass
class ConditionPlan:
    """Accumulation chain of heterogeneous guarded comparisons
    (the cardioTest specs, VectorizerTest.cpp:225-368)."""
    target: str
    entries: List[tuple] = field(default_factory=list)      # condition terms
    statement_positions: List[int] = field(default_factory=list)


@dataclass
class AuxiliaryInformation:
    """Client-facing packing report (ref: Vectorizer.cpp:86-89 stub)."""
    # variable → number of valid slots after batching (tail is unspecified)
    valid_slots: Dict[str, int] = field(default_factory=dict)
    # variable → slot holding the scalar result of a reduction
    result_slot: Dict[str, int] = field(default_factory=dict)
    # fresh packed input → the scalar sources packed into its slots
    # (ref: the expectedAuxiliary strings of DISABLED_batchableExpression,
    # VectorizerTest.cpp:434-484: "__input0__ = {a,c}")
    input_packings: Dict[str, List[object]] = field(default_factory=dict)
    # matvec results land at slots stride·s (DISABLED_matrixVectorTest)
    result_stride: Dict[str, int] = field(default_factory=dict)
    # variable → first slot index that MUST be zero-padded by the client
    required_zero_tail: Dict[str, int] = field(default_factory=dict)
    # variable → k: client must pack the k-vector REPLICATED (x‖x) so slot
    # reads past k wrap onto the vector (the BSGS matvec contract)
    required_replicated: Dict[str, int] = field(default_factory=dict)
    batched_statements: int = 0


class Vectorizer:
    """Batches one straight-line Block (recursing into nested blocks)."""

    def __init__(self, input_types=None) -> None:
        self.aux = AuxiliaryInformation()
        self._fresh = 0
        # non-secret variable names (inputs + in-program declarations):
        # the plain-matrix matvec specialization keys off these
        self._plain_names = {name for name, dt in (input_types or {}).items()
                             if not getattr(dt, "secret", False)}
        # variables with a defined value before any indexed write: inputs
        # (always initialized) + initialized declarations (dominate later
        # writes). Per-block whole-variable assignments are added during
        # the scan. See SlotPlan.target_defined.
        self._defined_seed = set((input_types or {}).keys())

    # --- public -----------------------------------------------------------
    def run(self, block: Block) -> None:
        for stmt in block.iter_preorder():
            if isinstance(stmt, VariableDeclaration):
                if not stmt.datatype.secret:
                    self._plain_names.add(stmt.target.identifier)
                if stmt.value is not None:
                    self._defined_seed.add(stmt.target.identifier)
        self._run_blocks(block)

    def _run_blocks(self, block: Block) -> None:
        for stmt in block.children():
            if isinstance(stmt, Block):
                self._run_blocks(stmt)
            elif hasattr(stmt, "body") and isinstance(getattr(stmt, "body"), Block):
                self._run_blocks(stmt.body)
        self._batch_block(block)

    # --- scanning ------------------------------------------------------------
    def _batch_block(self, block: Block) -> None:
        statements = block.children()
        replacement: List[Optional[object]] = list(statements)
        slot_plans: Dict[str, SlotPlan] = {}
        defined = set(self._defined_seed)
        literal_values: Dict[str, Optional[int]] = {}
        reduction: Optional[ReductionPlan] = None
        cond_plan: Optional[ConditionPlan] = None

        def flush_slot_plan(name: str) -> None:
            plan = slot_plans.pop(name, None)
            if plan is not None:
                self._emit_slot_plan(plan, replacement)

        def flush_reduction() -> None:
            nonlocal reduction
            if reduction is not None:
                self._emit_reduction(reduction, replacement,
                                     literal_values.get(reduction.target))
                literal_values[reduction.target] = None
                reduction = None

        def flush_cond() -> None:
            nonlocal cond_plan
            if cond_plan is not None:
                self._emit_condition_chain(
                    cond_plan, replacement,
                    literal_values.get(cond_plan.target))
                literal_values[cond_plan.target] = None
                cond_plan = None

        def flush_all() -> None:
            flush_reduction()
            flush_cond()
            for name in list(slot_plans):
                flush_slot_plan(name)

        for pos, stmt in enumerate(statements):
            handled = False
            if isinstance(stmt, Assignment):
                target = stmt.target
                # --- indexed write: slot plan ------------------------------
                if isinstance(target, IndexAccess) and \
                        isinstance(target.target, Variable) and \
                        isinstance(target.index, Literal) and \
                        isinstance(target.index.value, int):
                    flush_reduction()
                    flush_cond()
                    name = target.target.identifier
                    norm = normalize(stmt.value, target.index.value)
                    if norm is not None:
                        reads = set()
                        _reads_of(norm, reads)
                        # flush plans this statement reads (except self-reads)
                        for r in reads - {name}:
                            flush_slot_plan(r)
                        plan = slot_plans.get(name)
                        if plan is None:
                            # a scalar-LITERAL initializer (`int y = 0;`)
                            # is the declare-output idiom of the reference
                            # matvec/reduction specs: every slot holds the
                            # same broadcast constant, and overwrite
                            # emissions stay allowed (tail documented via
                            # aux.valid_slots). Anything else live-defined
                            # forces the masked partial form.
                            broadcast_lit = \
                                literal_values.get(name) is not None
                            plan = slot_plans[name] = SlotPlan(
                                name, target_defined=(name in defined
                                                      and not broadcast_lit))
                        plan.slots[target.index.value] = norm
                        plan.statement_positions.append(pos)
                        literal_values[name] = None
                        handled = True
                # --- accumulation: reduction plan --------------------------
                elif isinstance(target, Variable):
                    name = target.identifier
                    defined.add(name)
                    acc = self._match_accumulation(stmt, name)
                    if acc is not None:
                        op, norm_entry = acc
                        reads = set()
                        _reads_of(norm_entry[1], reads)
                        if name in reads:
                            acc = None  # self-referential entry: not batchable
                        for r in reads:
                            flush_slot_plan(r)
                    if acc is not None:
                        op, norm_entry = acc
                        flush_cond()
                        if reduction is not None and (
                                reduction.target != name or reduction.op != op):
                            flush_reduction()
                        if reduction is None:
                            reduction = ReductionPlan(name, op)
                        reduction.entries.append(norm_entry)
                        reduction.statement_positions.append(pos)
                        handled = True
                    else:
                        cterm = self._match_cond_accumulation(stmt, name)
                        if cterm is not None:
                            flush_reduction()
                            if cond_plan is not None and \
                                    cond_plan.target != name:
                                flush_cond()
                            for r in _cond_term_reads(cterm):
                                flush_slot_plan(r)
                            if cond_plan is None:
                                cond_plan = ConditionPlan(name)
                            cond_plan.entries.append(cterm)
                            cond_plan.statement_positions.append(pos)
                            handled = True
                        else:
                            flush_all()
                            if self._try_scalar_products(stmt, pos,
                                                         replacement) or \
                                    self._try_condition_packing(stmt, pos,
                                                                replacement):
                                literal_values[name] = None
                                handled = True
                            else:
                                literal_values[name] = stmt.value.value \
                                    if isinstance(stmt.value, Literal) else None
            elif isinstance(stmt, VariableDeclaration):
                if reduction is not None or slot_plans:
                    flush_all()
                if stmt.value is not None and isinstance(stmt.value, Literal):
                    literal_values[stmt.target.identifier] = stmt.value.value
                else:
                    literal_values[stmt.target.identifier] = None
                handled = True
            if not handled:
                flush_all()

        flush_all()

        # apply replacements (deletions + insertions recorded in-place)
        block.statements = [block._adopt(s) for s in replacement if s is not None]

    @staticmethod
    def _match_accumulation(stmt: Assignment, name: str
                            ) -> Optional[Tuple[Op, tuple]]:
        """Match `s = s op E_j` where E_j normalizes against some slot j
        determined by its rot-leaves (all leaves must share one j)."""
        v = stmt.value
        if not isinstance(v, BinaryExpression):
            return None
        op = v.operator.as_plain().op
        if op not in (Op.ADD, Op.MUL):
            return None
        if isinstance(v.left, Variable) and v.left.identifier == name:
            e = v.right
        elif isinstance(v.right, Variable) and v.right.identifier == name \
                and v.operator.is_commutative():
            e = v.left
        else:
            return None
        # find the slot from the first IndexAccess leaf
        slot = _first_index(e)
        if slot is None:
            return None
        norm = normalize(e, slot)
        if norm is None:
            return None
        # require all rot deltas to be slot-aligned (delta must not depend on
        # which leaf we picked): re-normalizing with slot gives consistent
        # deltas by construction; record the slot inside the entry
        return (v.operator.op, (slot, norm))

    @staticmethod
    def _match_cond_accumulation(stmt: Assignment, name: str
                                 ) -> Optional[tuple]:
        """Match `risk = risk +++ <condition term>` (the cardioTest chain,
        VectorizerTest.cpp:225-306). Returns the parsed condition term."""
        v = stmt.value
        if not isinstance(v, BinaryExpression) or \
                v.operator.as_plain().op != Op.ADD:
            return None
        if isinstance(v.left, Variable) and v.left.identifier == name:
            e = v.right
        elif isinstance(v.right, Variable) and v.right.identifier == name:
            e = v.left
        else:
            return None
        term = _parse_condition_term(e)
        if term is None or name in _cond_term_reads(term):
            return None
        return term

    # --- emission --------------------------------------------------------------
    def _emit_slot_plan(self, plan: SlotPlan,
                        replacement: List[Optional[object]]) -> None:
        slots = sorted(plan.slots)
        if len(slots) < 2:
            return  # nothing to batch
        n_slots = slots[-1] + 1

        # group by template
        groups: Dict[tuple, List[int]] = {}
        for s in slots:
            groups.setdefault(_template_key(plan.slots[s]), []).append(s)
        base_key = max(groups, key=lambda k: len(groups[k]))
        base_slots = groups[base_key]
        outliers = [s for s in slots if s not in base_slots]

        if len(base_slots) < 2 and not plan.target_defined:
            # per-slot templates differ: try the structured patterns
            # (plain-matrix BSGS first: more specific, O(√k) key switches).
            # Defined targets are excluded: these emissions overwrite every
            # slot (see full_overwrite_ok below).
            if self._try_plain_matvec_bsgs(plan, replacement):
                return
            if self._try_matvec_plan(plan, replacement):
                return
            if self._try_scalar_product_plan(plan, replacement):
                return

        # outliers must be pure literals (the singleOutlier spec)
        if any(plan.slots[s][0] != "const" for s in outliers):
            return
        if len(base_slots) < 2:
            return
        # a batched x = f(x) reads OLD x; sequential slot writes with a
        # nonzero self-offset would read UPDATED slots — not batchable
        for s in base_slots:
            reads_self = []
            _collect_rot_deltas(plan.slots[s], plan.target, reads_self)
            if any(d != 0 for d in reads_self):
                return

        covered = set(slots)
        contiguous = covered == set(range(n_slots))
        base_contiguous = set(base_slots) == set(range(len(base_slots))) \
            and base_slots[0] == 0

        # A target with a live pre-write value is fully slot-defined (any
        # initializer pads to the slot count): x = E would clobber slots
        # past the written range, so only the masked partial form — which
        # preserves unwritten slots exactly like the scalar writes do — is
        # sound (round-5 write-emission fuzz, seed 7000+0).
        full_overwrite_ok = not plan.target_defined

        stmts: List[Assignment] = []
        target = plan.target
        if full_overwrite_ok and contiguous and base_contiguous \
                and not outliers:
            # x = E
            stmts.append(Assignment(Variable(target),
                                    _emit_template(plan.slots, base_slots)))
        elif full_overwrite_ok and contiguous and base_contiguous \
                and outliers:
            # x = E; x = x *** mask; x = x +++ outlier_vec
            stmts.append(Assignment(Variable(target),
                                    _emit_template(plan.slots, base_slots)))
            mask = [1] * n_slots
            corr = [0] * n_slots
            for s in outliers:
                mask[s] = 0
                corr[s] = plan.slots[s][1]
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), Operator(Op.FHE_MUL),
                                 _vec(mask, trailing=0 if mask[-1] != 0 else None))))
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), Operator(Op.FHE_ADD),
                                 _vec(corr, trailing=0 if corr[-1] != 0 else None))))
        elif not outliers and len(base_slots) >= 2:
            # partial coverage: x = x***keep +++ E***write  (e.g. image
            # kernels writing only interior pixels); masks support arbitrary
            # written-slot sets
            lo, hi = base_slots[0], base_slots[-1]
            keep = [1] * (hi + 2)
            write = [0] * (hi + 2)
            for s in base_slots:
                keep[s] = 0
                write[s] = 1
            keep[hi + 1] = 1     # padding repeats 1 → tail preserved
            write[hi + 1] = 0    # padding repeats 0 → tail untouched
            e_batched = _emit_template(plan.slots, base_slots)
            # NOTE: const-vector leaves inside E are indexed 0..len(base)-1;
            # with an offset start they would misalign — bail in that case
            if lo != 0 and _has_varying_consts(plan.slots, base_slots):
                return
            masked = BinaryExpression(
                BinaryExpression(Variable(target), Operator(Op.FHE_MUL),
                                 _vec(keep, trailing=None)),
                Operator(Op.FHE_ADD),
                BinaryExpression(e_batched, Operator(Op.FHE_MUL),
                                 _vec(write, trailing=None)))
            stmts.append(Assignment(Variable(target), masked))
        else:
            return  # pattern not supported: leave statements untouched

        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.valid_slots[target] = n_slots
        self.aux.batched_statements += len(plan.statement_positions)

    def _emit_reduction(self, plan: ReductionPlan,
                        replacement: List[Optional[object]],
                        initial_literal: Optional[int]) -> None:
        count = len(plan.entries)
        if count < 2:
            return
        # entries must cover slots 0..count-1 in ascending order
        slots = [e[0] for e in plan.entries]
        if slots != list(range(count)):
            return
        # s must be provably zero (or start fresh) before the chain
        zero_init = (initial_literal == 0)
        if not zero_init:
            return
        norm_by_slot = {e[0]: e[1] for e in plan.entries}
        if len({_template_key(n) for n in norm_by_slot.values()}) != 1:
            return

        target = plan.target
        plain_op = Operator(plan.op).as_plain()
        stmts: List[Assignment] = []
        e_batched = _emit_template(norm_by_slot, sorted(norm_by_slot))
        k = _next_pow2(count)
        if k != count:
            # mask the tail garbage before reducing
            mask = [1] * count
            e_batched = BinaryExpression(e_batched, Operator(Op.FHE_MUL),
                                         _vec(mask, trailing=0))
        stmts.append(Assignment(Variable(target), e_batched))
        half = k // 2
        while half >= 1:
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), plain_op,
                                 _rotate(Variable(target), half))))
            half //= 2

        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.result_slot[target] = 0
        self.aux.batched_statements += len(plan.statement_positions)

    # --- condition packing (the cardioTest specs) -------------------------------
    def _emit_condition_chain(self, plan: ConditionPlan,
                              replacement: List[Optional[object]],
                              initial_literal: Optional[int]) -> None:
        """Batch `risk = risk +++ cond_i` chains (DISABLED_cardioTest /
        DISABLED_cardioTestSimplified, VectorizerTest.cpp:225-368)."""
        if len(plan.entries) < 2 or initial_literal != 0:
            return
        if not any(_is_real_comparison(t) for t in plan.entries):
            return  # plain scalar sums: not worth a ciphertext
        stmts = self._condition_packing_stmts(plan.target, plan.entries)
        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.result_slot[plan.target] = 0
        self.aux.batched_statements += len(plan.statement_positions)

    def _try_condition_packing(self, stmt: Assignment, pos: int,
                               replacement: List[Optional[object]]) -> bool:
        """Batch the mega-expression form `risk = c1 +++ c2 +++ …`
        (DISABLED_cardioTestMegaExpression, ExpressionBatcherTest.cpp:49)."""
        terms = _flatten_chain(stmt.value, (Op.ADD, Op.FHE_ADD))
        if terms is None or len(terms) < 2:
            return False
        parsed = []
        for t in terms:
            p = _parse_condition_term(t)
            if p is None:
                return False
            parsed.append(p)
        if not any(_is_real_comparison(t) for t in parsed):
            return False
        target = stmt.target.identifier
        if any(target in _cond_term_reads(t) for t in parsed):
            return False
        stmts = self._condition_packing_stmts(target, parsed)
        self._replace([pos], stmts, replacement)
        self.aux.result_slot[target] = 0
        self.aux.batched_statements += 1
        return True

    def _condition_packing_stmts(self, target: str,
                                 terms: List[tuple]) -> List[object]:
        """Emit the packed form (VectorizerTest.cpp:307-368 expected):

            __flags__ = {flag_0, …};   __lhs__ = {lhs_0, …};   __rhs__ = {…}
            [__lhs__ = __lhs__ + {delta vector}]     (affine sides, e.g. −90)
            risk = __flags__ *** (__lhs__ > __rhs__)
            risk = risk + rotate(risk, k) …          (sum to slot 0)

        Comparisons are normalized to `>` orientation (a < b ⇒ b > a); bare
        flags become flag***(1>0). Flag slots K..Kp−1 are zero-padded so the
        rotate-reduce needs no mask."""
        from abc_tpu_torch.utils.datatype import Datatype, Type

        K = len(terms)
        Kp = _next_pow2(K)
        cols = [[t[0] for t in terms],
                [t[1][0] for t in terms],
                [t[2][0] for t in terms]]
        deltas = [[t[1][1] for t in terms], [t[2][1] for t in terms]]
        stmts: List[object] = []
        names: List[str] = []
        for col in cols:
            nm = f"__input{self._fresh}__"
            self._fresh += 1
            names.append(nm)
            elems = [Variable(e[1]) if e[0] == "var" else LiteralInt(e[1])
                     for e in col] + [LiteralInt(0)] * (Kp - K)
            self.aux.input_packings[nm] = \
                [e[1] for e in col] + [0] * (Kp - K)
            stmts.append(VariableDeclaration(Datatype(Type.INT),
                                             Variable(nm),
                                             ExpressionList(elems)))
        for side, ds in enumerate(deltas):
            if any(d != 0 for d in ds):
                nm = names[side + 1]
                stmts.append(Assignment(
                    Variable(nm),
                    BinaryExpression(Variable(nm), Operator(Op.ADD),
                                     _vec(ds + [0] * (Kp - K),
                                          trailing=None))))
        cmp = BinaryExpression(Variable(names[1]), Operator(Op.GREATER),
                               Variable(names[2]))
        stmts.append(Assignment(
            Variable(target),
            BinaryExpression(Variable(names[0]), Operator(Op.FHE_MUL), cmp)))
        half = Kp // 2
        while half >= 1:
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), Operator(Op.ADD),
                                 _rotate(Variable(target), half))))
            half //= 2
        return stmts

    # --- plain-matrix matvec → BSGS diagonal form ------------------------------
    def _try_plain_matvec_bsgs(self, plan: SlotPlan,
                               replacement: List[Optional[object]]) -> bool:
        """Specialize  c[s] = Σ_j M[k·s+j]·x[j]  when the k×k matrix M is
        PLAIN (public input or in-program declaration) and x is secret:
        emit the baby-step/giant-step diagonal form (crypto/linalg.py's
        construction, made COMPILER-REACHABLE per the round-2 review):

            __mvb_j__ = rotate(x, j)            j = 1..g−1   (baby steps —
                                                 at runtime these share ONE
                                                 key-switch decomposition
                                                 via the transparent
                                                 hoisting cache)
            acc_i     = Σ_j pt_{i,j} ∘ __mvb_j__             (plain mults)
            c         = Σ_i rotate(acc_i, g·i)               (giant steps)

        with pt_{i,j}[u] = M[k·(u−g·i) + ((u+j) mod k)] for g·i ≤ u < g·i+k
        (0 elsewhere; the diagonals are emitted as index reads of M, so the
        matrix VALUES need not be compile-time constants — only its
        plainness matters). Key switches: (g−1) baby (one decomposition) +
        (⌈k/g⌉−1) giant ≈ O(√k), vs k−1 for the b-rotation form.

        CLIENT CONTRACT (aux.required_replicated): x must be packed
        REPLICATED (x‖x) so rotate(x, j) reads past slot k wrap onto the
        vector; results are valid in slots 0..k−1 (stride 1)."""
        parsed = self._parse_matvec_layout(plan)
        if parsed is None:
            return False
        a_name, b_name, T, S, add_str, mul_str = parsed
        k = T
        # square, big enough for BSGS to win, small enough that the emitted
        # diagonal ExpressionLists (~k elements × ~2√k lists) stay a
        # reasonable AST; full-slot sizes use the library path
        # (crypto/linalg.matvec_bsgs)
        if S != k or k < 4 or k > 256:
            return False
        if a_name not in self._plain_names or b_name in self._plain_names:
            return False
        import math
        from abc_tpu_torch.utils.datatype import Datatype, Type
        g = max(1, math.isqrt(k))
        n_giant = (k + g - 1) // g
        add_op = Operator(Op.FHE_ADD if add_str == "+++" else Op.ADD)
        mul_op = Operator(Op.FHE_MUL if mul_str == "***" else Op.MUL)
        target = plan.target
        stmts: List[object] = []
        baby_names = {0: b_name}
        for j in range(1, g):
            nm = f"__mvb{self._fresh}__"
            self._fresh += 1
            baby_names[j] = nm
            stmts.append(VariableDeclaration(
                Datatype(Type.INT, True), Variable(nm),
                _rotate(Variable(b_name), j)))
        for i in range(n_giant):
            acc_expr = None
            for j in range(g):
                d = g * i + j
                if d >= k:
                    break
                elems: List[object] = []
                for u in range(g * i + k):
                    if u < g * i:
                        elems.append(LiteralInt(0))
                    else:
                        row = u - g * i
                        col = (u + j) % k
                        elems.append(IndexAccess(Variable(a_name),
                                                 LiteralInt(k * row + col)))
                elems.append(LiteralInt(0))    # encode pads with LAST → 0
                pt = ExpressionList(elems)
                term = BinaryExpression(Variable(baby_names[j]), mul_op, pt)
                acc_expr = term if acc_expr is None else \
                    BinaryExpression(acc_expr, add_op, term)
            if acc_expr is None:
                continue
            if i == 0:
                stmts.append(Assignment(Variable(target), acc_expr))
            else:
                nm = f"__mvg{self._fresh}__"
                self._fresh += 1
                stmts.append(VariableDeclaration(
                    Datatype(Type.INT, True), Variable(nm), acc_expr))
                stmts.append(Assignment(
                    Variable(target),
                    BinaryExpression(Variable(target), add_op,
                                     _rotate(Variable(nm), g * i))))
        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.result_stride[target] = 1
        self.aux.valid_slots[target] = k
        self.aux.required_replicated[b_name] = k
        self.aux.batched_statements += len(plan.statement_positions)
        return True

    # --- matvec batching (the matrixVectorTest spec) ---------------------------
    def _parse_matvec_layout(self, plan: SlotPlan):
        """Recognize  c[s] = Σ_j a[T·s+j]·b[j]  (flattened row-major matrix
        × packed vector) in a slot plan. Returns (a_name, b_name, T, S,
        add_str, mul_str) or None."""
        slots = sorted(plan.slots)
        S = len(slots)
        if S < 2 or slots != list(range(S)):
            return None
        a_name = b_name = None
        add_str = mul_str = None
        layout: Dict[int, Dict[int, int]] = {}     # slot → {j: a_abs_index}
        for s in slots:
            flat = _flatten_norm_sum(plan.slots[s])
            if flat is None:
                return None
            add_str, terms = flat
            parsed = []
            for t in terms:
                pt = _parse_norm_product(t)
                if pt is None:
                    return None
                mul_str = pt[0]
                parsed.append(pt)
            # decide roles: B's absolute index must equal its term position
            entries = []
            for (mstr, (n1, d1), (n2, d2)) in parsed:
                entries.append(((n1, d1 + s), (n2, d2 + s)))
            # try both role assignments consistently
            for flip in (False, True):
                a_c = {e[1 if flip else 0][0] for e in entries}
                b_c = {e[0 if flip else 1][0] for e in entries}
                if len(a_c) == 1 and len(b_c) == 1 and a_c != b_c:
                    b_abs = sorted(e[0 if flip else 1][1] for e in entries)
                    if b_abs == list(range(len(entries))):
                        a_name = a_name or next(iter(a_c))
                        b_name = b_name or next(iter(b_c))
                        if a_c != {a_name} or b_c != {b_name}:
                            return None
                        layout[s] = {e[0 if flip else 1][1]:
                                     e[1 if flip else 0][1] for e in entries}
                        break
            else:
                return None
        T = len(layout[0])
        if any(len(m) != T for m in layout.values()):
            return None
        for s in slots:
            for j, a_abs in layout[s].items():
                if a_abs != T * s + j:
                    return None
        if plan.target in (a_name, b_name):
            return None
        return a_name, b_name, T, S, add_str, mul_str

    def _try_matvec_plan(self, plan: SlotPlan,
                         replacement: List[Optional[object]]) -> bool:
        """Batch  c[s] = Σ_j a[T·s+j]·b[j]  (flattened row-major matrix ×
        vector) into the reference's DISABLED_matrixVectorTest form
        (VectorizerTest.cpp:370-423):

            c = a ∘ b
            c = c + a ∘ rotate(b, −T)        (output row 1's window)
            …                                 (one statement per row)
            [group rotate-reduce]             (completing the WIP spec)

        REQUIRES b's slots ≥ T to be ZERO (the spec's stated assumption) —
        recorded in aux.required_zero_tail for the client. Results land at
        slots T·s (aux.result_stride)."""
        parsed = self._parse_matvec_layout(plan)
        if parsed is None:
            return False
        a_name, b_name, T, S, add_str, mul_str = parsed

        add_op = Operator(Op.FHE_ADD if add_str == "+++" else Op.ADD)
        mul_op = Operator(Op.FHE_MUL if mul_str == "***" else Op.MUL)
        target = plan.target
        stmts: List[Assignment] = []
        first = BinaryExpression(Variable(a_name), mul_op, Variable(b_name))
        stmts.append(Assignment(Variable(target), first))
        for k in range(1, S):
            term = BinaryExpression(Variable(a_name), mul_op,
                                    _rotate(Variable(b_name), -T * k))
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), add_op, term)))
        # group reduction: sum each window of T (valid at slots T·s)
        if T & (T - 1) == 0:
            half = T // 2
            while half >= 1:
                stmts.append(Assignment(
                    Variable(target),
                    BinaryExpression(Variable(target), add_op,
                                     _rotate(Variable(target), half))))
                half //= 2
        else:
            from abc_tpu_torch.utils.datatype import Datatype, Type
            tmp = f"__mv{self._fresh}__"
            self._fresh += 1
            stmts.append(VariableDeclaration(Datatype(Type.INT),
                                             Variable(tmp), Variable(target)))
            for d in range(1, T):
                stmts.append(Assignment(
                    Variable(target),
                    BinaryExpression(Variable(target), add_op,
                                     _rotate(Variable(tmp), d))))
        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.result_stride[target] = T
        self.aux.valid_slots[target] = S * T
        self.aux.required_zero_tail[b_name] = T
        self.aux.batched_statements += len(plan.statement_positions)
        return True

    # --- multi-slot scalar-product batching ------------------------------------
    def _try_scalar_product_plan(self, plan: SlotPlan,
                                 replacement: List[Optional[object]]) -> bool:
        """Batch  x[s] = Σ_k Π_f v_{s,k,f}  over all slots into ONE packed
        plan — the reference's DISABLED_batchableExpressionVectorizable
        (VectorizerTest.cpp:484-540). Its expected output is marked "what we
        would IDEALLY like to see" and is internally inconsistent (two
        multiplies for a two-factor product), so this emits the sound
        equivalent: one packed input per factor column with slot-major
        [s][k] layout (term count padded to a power of two per block),
        F−1 ciphertext multiplies, then a log-depth rotate-reduce over each
        block; x[s]'s result lands at slot s·Kp (aux.result_stride)."""
        slots = sorted(plan.slots)
        S = len(slots)
        if S < 2 or slots != list(range(S)):
            return False
        add_str = mul_str = None
        K = F = None
        grid: List[List[List[str]]] = []   # [slot][term][factor] leaf names
        for s in slots:
            norm = plan.slots[s]
            flat = _flatten_norm_sum(norm)
            terms = flat[1] if flat is not None else [norm]
            if flat is not None:
                if add_str is None:
                    add_str = flat[0]
                elif flat[0] != add_str:
                    return False
            rows: List[List[str]] = []
            for t in terms:
                fp = _flatten_norm_product(t)
                if fp is None:
                    return False
                m_str, leaves = fp
                if mul_str is None:
                    mul_str = m_str
                elif m_str != mul_str:
                    return False
                if not all(l[0] == "var" for l in leaves):
                    return False
                rows.append([l[1] for l in leaves])
            if K is None:
                K = len(rows)
            if len(rows) != K:
                return False
            if F is None:
                F = len(rows[0])
            if any(len(r) != F for r in rows):
                return False
            grid.append(rows)
        if F < 2:
            return False
        if plan.target in {n for rows in grid for r in rows for n in r}:
            return False

        from abc_tpu_torch.utils.datatype import Datatype, Type
        Kp = _next_pow2(K)
        target = plan.target
        stmts: List[object] = []
        names: List[str] = []
        for f in range(F):
            nm = f"__input{self._fresh}__"
            self._fresh += 1
            names.append(nm)
            col: List[Optional[str]] = []
            for s in range(S):
                col += [grid[s][k][f] for k in range(K)]
                col += [None] * (Kp - K)
            elems = [Variable(n) if n is not None else LiteralInt(0)
                     for n in col]
            self.aux.input_packings[nm] = [n if n is not None else 0
                                           for n in col]
            stmts.append(VariableDeclaration(Datatype(Type.INT),
                                             Variable(nm),
                                             ExpressionList(elems)))
        mul_op = Operator(Op.FHE_MUL if mul_str == "***" else Op.MUL)
        add_op = Operator(Op.FHE_ADD if add_str == "+++" else Op.ADD)
        prod: AbstractExpression = Variable(names[0])
        for nm in names[1:]:
            prod = BinaryExpression(prod, mul_op, Variable(nm))
        stmts.append(Assignment(Variable(target), prod))
        half = Kp // 2
        while half >= 1:
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), add_op,
                                 _rotate(Variable(target), half))))
            half //= 2
        self._replace(plan.statement_positions, stmts, replacement)
        self.aux.result_stride[target] = Kp
        self.aux.valid_slots[target] = S * Kp
        self.aux.batched_statements += len(plan.statement_positions)
        return True

    # --- scalar expression batching (the ExpressionBatcher spec) --------------
    def _try_scalar_products(self, stmt: Assignment, pos: int,
                             replacement: List[Optional[object]]) -> bool:
        """Batch `x = (a∘b) + (c∘d) + …`: pack the k-th factor of every term
        into a fresh `__inputN__` vector, multiply the packed vectors
        elementwise, and rotate-reduce the terms — the reference's
        DISABLED_batchableExpression spec (VectorizerTest.cpp:434-484) and
        the ExpressionBatcher computation-tree pattern
        (ExpressionBatcher.cpp:306-323).

        Packing declarations are emitted in-program as ExpressionLists of
        the scalar variables (executable when the scalars are plain; for
        secret scalars the aux input_packings report is the client-side
        packing instruction, as the reference intends)."""
        terms = _flatten_chain(stmt.value, (Op.ADD, Op.FHE_ADD))
        if terms is None or len(terms) < 2:
            return False
        add_op = Operator(_root_op(stmt.value)).as_plain()
        factor_lists = []
        mul_op = None
        for t in terms:
            if isinstance(t, Variable):
                factor_lists.append([t])
                continue
            facs = _flatten_chain(t, (Op.MUL, Op.FHE_MUL))
            if facs is None or not all(isinstance(f, Variable) for f in facs):
                return False
            mul_op = mul_op or Operator(_root_op(t)).as_plain()
            factor_lists.append(facs)
        F = len(factor_lists[0])
        if F < 2:        # sums of bare scalars: not worth a ciphertext
            return False
        if any(len(f) != F for f in factor_lists) or \
                not all(isinstance(f, Variable) for fs in factor_lists
                        for f in fs):
            return False
        target = stmt.target.identifier
        leaves = {f.identifier for fs in factor_lists for f in fs}
        if target in leaves:
            return False

        K = len(terms)
        Kp = _next_pow2(K)
        from abc_tpu_torch.utils.datatype import Datatype, Type
        stmts: List[object] = []
        packed_names = []
        for f in range(F):
            nm = f"__input{self._fresh}__"
            self._fresh += 1
            packed_names.append(nm)
            col = [factor_lists[k][f].identifier for k in range(K)]
            pad = [0] * (Kp - K)
            self.aux.input_packings[nm] = col + pad
            elems = [Variable(c) for c in col] + [LiteralInt(0) for _ in pad]
            stmts.append(VariableDeclaration(Datatype(Type.INT),
                                             Variable(nm),
                                             ExpressionList(elems)))
        prod: AbstractExpression = Variable(packed_names[0])
        for nm in packed_names[1:]:
            prod = BinaryExpression(prod, mul_op or Operator(Op.MUL),
                                    Variable(nm))
        stmts.append(Assignment(Variable(target), prod))
        half = Kp // 2
        while half >= 1:
            stmts.append(Assignment(
                Variable(target),
                BinaryExpression(Variable(target), add_op,
                                 _rotate(Variable(target), half))))
            half //= 2
        self._replace([pos], stmts, replacement)
        self.aux.result_slot[target] = 0
        self.aux.batched_statements += 1
        return True

    @staticmethod
    def _replace(positions: List[int], new_stmts: List[Assignment],
                 replacement: List[Optional[object]]) -> None:
        for p in positions:
            replacement[p] = None
        replacement[positions[0]] = _StatementGroup(new_stmts)


class _StatementGroup:
    """Placeholder expanded during final statement-list assembly."""

    def __init__(self, stmts):
        self.stmts = stmts


def _is_contiguous(slots: List[int]) -> bool:
    return slots == list(range(slots[0], slots[0] + len(slots)))


def _first_index(expr: AbstractExpression) -> Optional[int]:
    for node in expr.iter_preorder():
        if isinstance(node, IndexAccess) and isinstance(node.index, Literal) \
                and isinstance(node.index.value, int):
            return node.index.value
    return None


def _collect_rot_deltas(norm: tuple, var: str, out: list) -> None:
    kind = norm[0]
    if kind == "rot" and norm[1] == var:
        out.append(norm[2])
    elif kind == "bin":
        _collect_rot_deltas(norm[2], var, out)
        _collect_rot_deltas(norm[3], var, out)
    elif kind == "un":
        _collect_rot_deltas(norm[2], var, out)


def _has_varying_consts(norm_by_slot: Dict[int, tuple], slots: List[int]) -> bool:
    cols: Dict[int, list] = {}
    for s in slots:
        consts: list = []
        _collect_consts(norm_by_slot[s], consts)
        for i, c in enumerate(consts):
            cols.setdefault(i, []).append(c)
    return any(len(set(v)) > 1 for v in cols.values())


def run_vectorizer_with_aux(ast: Block, input_types=None, tcv=None):
    """Batch the program; returns (ast, AuxiliaryInformation) — the packing
    report (ref: the getAuxiliaryInformation stub, Vectorizer.cpp:86-89),
    surfaced by the pipeline as CompiledProgram.aux."""
    v = Vectorizer(input_types)
    v.run(ast)
    _expand_groups(ast)
    return ast, v.aux


def run_vectorizer(ast: Block, input_types=None, tcv=None) -> Block:
    """Pipeline hook: batch the program, expanding statement groups."""
    return run_vectorizer_with_aux(ast, input_types, tcv)[0]


def _expand_groups(block: Block) -> None:
    out = []
    for s in block.statements:
        if isinstance(s, _StatementGroup):
            out.extend(s.stmts)
        elif s is not None:
            out.append(s)
            for child in s.children():
                if isinstance(child, Block):
                    _expand_groups(child)
    block.statements = [block._adopt(s) for s in out]
