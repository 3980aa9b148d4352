"""Cone rewriting: multiplicative-depth reduction (Aubry et al.).

Reference: README.md:92-104 — the reference DOCUMENTS this pass (Alg. 1 cone
construction, Alg. 2 C^AND circuit, Alg. 3 flow-based minimum cone selection,
Alg. 4 rewrite) but ships no implementation; the only trace is commented-out
legacy fixtures (test/AstTestingGenerator.cpp:921-986). This module is
authored to that spec.

Multiplicative depth l(v): AND/MUL gates add 1, XOR/ADD gates are free.
The local rewrite is pure ring distributivity + associativity, so it is valid
for boolean circuits (∧ = &, ⊕ = ^) AND arithmetic ones (*, +):

    v = t * (y_1 + … + y_r + u)   with critical  u = t' * U'
      ⇒
    v' = U' * (t' * t)  +  t * (y_1 + … + y_r)

which reduces l(v) = l(U') + 2 down to l(U') + 1 whenever the shallow
operands have ≥2 levels of slack:
    l(t), l(t') ≤ l(v) − 3   and   l(y_i) ≤ l(v) − 2.

Cone SELECTION implements the paper's Alg. 3: build the critical-AND
circuit C^AND (critical AND gates, connected through critical XOR paths —
Alg. 2), then pick Δ^MIN, the MINIMUM set of cones whose rewriting cuts
every critical path, as a minimum vertex cut = max flow on the node-split
C^AND with capacity 1 on reducible critical ANDs and ∞ on irreducible ones
(so the cut never selects a cone the local rewrite cannot fire on). Every
cone rewrite adds gates, so minimizing |Δ^MIN| minimizes the gate-count
cost of each depth level removed — measured in bench config 4 against the
greedy deepest-first selection (ConeRewriter(flow_select=False), kept as
the fallback when no finite cut exists).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    AbstractExpression, AbstractNode, Assignment, BinaryExpression, Block,
    Return, VariableDeclaration,
)
from abc_tpu_torch.utils.operators import Op, Operator

# gate families: ring-distributive (mul over add) pairs
MUL_OPS = {Op.MUL, Op.FHE_MUL, Op.BITWISE_AND, Op.LOGICAL_AND}
ADD_OPS = {Op.ADD, Op.FHE_ADD, Op.BITWISE_XOR}


def _is_mul(n: AbstractNode) -> bool:
    return isinstance(n, BinaryExpression) and n.operator.op in MUL_OPS


def _is_add(n: AbstractNode) -> bool:
    return isinstance(n, BinaryExpression) and n.operator.op in ADD_OPS


def multiplicative_depth(expr: AbstractExpression,
                         memo: Optional[Dict[int, int]] = None) -> int:
    """l(v): number of mul gates on the deepest path to any leaf."""
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    if isinstance(expr, BinaryExpression):
        child = max(multiplicative_depth(expr.left, memo),
                    multiplicative_depth(expr.right, memo))
        depth = child + (1 if expr.operator.op in MUL_OPS else 0)
    else:
        depth = max((multiplicative_depth(c, memo) for c in expr.children()
                     if isinstance(c, AbstractExpression)), default=0)
    memo[key] = depth
    return depth


def _flatten_add_chain(expr: AbstractExpression) -> Optional[List[AbstractExpression]]:
    """Flatten nested same-family additions into an operand list."""
    if not _is_add(expr):
        return None
    out: List[AbstractExpression] = []

    def walk(e: AbstractExpression) -> None:
        if _is_add(e):
            walk(e.left)
            walk(e.right)
        else:
            out.append(e)

    walk(expr)
    return out


def _rebuild_add(operands: List[AbstractExpression], op: Operator
                 ) -> AbstractExpression:
    expr = operands[0]
    for o in operands[1:]:
        expr = BinaryExpression(expr, op, o)
    return expr


def rebalance_depth(expr: AbstractExpression) -> AbstractExpression:
    """Associative rebalancing of multiplication chains — the complementary
    depth reduction to cone rewriting: a left-leaning product chain
    x1·x2·…·xk (depth k−1, what a recursive-descent parser emits) becomes a
    depth-optimal tree via Huffman combination on operand depth (always pair
    the two shallowest operands: max(d1,d2)+1 is the minimal achievable
    combine). Pure associativity — exact for ring AND boolean semantics.

    Recurses through BinaryExpression trees only; chains hidden under other
    node types (calls, ternaries) are left as-is. Returns a NEW expression
    (operands cloned), like ConeRewriter's local rewrites."""
    import heapq
    if not isinstance(expr, BinaryExpression):
        return expr
    if expr.operator.op not in MUL_OPS:
        return BinaryExpression(rebalance_depth(expr.left).clone(),
                                expr.operator,
                                rebalance_depth(expr.right).clone())
    op_enum = expr.operator.op
    mul_op = expr.operator
    operands: List[AbstractExpression] = []

    def collect(x: AbstractExpression) -> None:
        if isinstance(x, BinaryExpression) and x.operator.op == op_enum:
            collect(x.left)
            collect(x.right)
        else:
            operands.append(rebalance_depth(x).clone())

    collect(expr)
    heap = [(multiplicative_depth(o), i, o) for i, o in enumerate(operands)]
    heapq.heapify(heap)
    seq = len(operands)
    while len(heap) > 1:
        d1, _, a = heapq.heappop(heap)
        d2, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (max(d1, d2) + 1, seq,
                              BinaryExpression(a, mul_op, b)))
        seq += 1
    return heap[0][2]


def program_mult_depth(ast: Block) -> int:
    """End-to-end multiplicative depth of a straight-line program: depth
    accumulates through variable definitions (a use of x starts at the
    depth of the expression last assigned to x). This is the circuit-level
    l_max a sorting network or comparator pipeline actually pays."""
    from abc_tpu_torch.ast_ir.nodes import Variable

    var_depth: Dict[str, int] = {}

    def depth(expr: AbstractExpression) -> int:
        if isinstance(expr, Variable):
            return var_depth.get(expr.identifier, 0)
        if isinstance(expr, BinaryExpression):
            d = max(depth(expr.left), depth(expr.right))
            return d + (1 if expr.operator.op in MUL_OPS else 0)
        return max((depth(c) for c in expr.children()
                    if isinstance(c, AbstractExpression)), default=0)

    worst = 0
    for stmt in ast.iter_preorder():
        target = expr = None
        if isinstance(stmt, Assignment):
            target, expr = stmt.target, stmt.value
        elif isinstance(stmt, VariableDeclaration) and stmt.value is not None:
            target, expr = stmt.target, stmt.value
        elif isinstance(stmt, Return) and stmt.value is not None:
            expr = stmt.value
        if expr is None:
            continue
        d = depth(expr)
        worst = max(worst, d)
        if target is not None and hasattr(target, "identifier"):
            var_depth[target.identifier] = d
    return worst


def mul_gate_count(expr: AbstractExpression) -> int:
    """Number of mul/AND gates in the expression tree (the 'gates added'
    cost metric of a cone rewrite — each rewrite duplicates t)."""
    count = 1 if _is_mul(expr) else 0
    return count + sum(mul_gate_count(c) for c in expr.children()
                       if isinstance(c, AbstractExpression))


# ------------------------------------------------------- Alg. 3: flow selection

_INF = 1 << 30


class _FlowGraph:
    """Tiny Edmonds-Karp max-flow over an adjacency-map residual graph.
    Node-split vertex capacities: vertex v becomes v_in → v_out with the
    vertex's capacity; all structural edges have capacity ∞. C^AND graphs
    are small (≤ a few hundred critical ANDs), so BFS augmentation is
    plenty."""

    def __init__(self):
        self.cap: Dict[object, Dict[object, int]] = {}

    def add_edge(self, u, v, c: int) -> None:
        self.cap.setdefault(u, {})
        self.cap.setdefault(v, {})
        self.cap[u][v] = self.cap[u].get(v, 0) + c
        self.cap[v].setdefault(u, 0)

    def max_flow(self, s, t, limit: int = _INF) -> int:
        from collections import deque
        total = 0
        while total < limit:
            parent = {s: None}
            q = deque([s])
            while q and t not in parent:
                u = q.popleft()
                for v, c in self.cap[u].items():
                    if c > 0 and v not in parent:
                        parent[v] = u
                        q.append(v)
            if t not in parent:
                break
            # bottleneck along the path
            bott = _INF
            v = t
            while parent[v] is not None:
                u = parent[v]
                bott = min(bott, self.cap[u][v])
                v = u
            v = t
            while parent[v] is not None:
                u = parent[v]
                self.cap[u][v] -= bott
                self.cap[v][u] += bott
                v = u
            total += bott
        return total

    def min_cut_side(self, s) -> set:
        """Vertices reachable from s in the residual graph."""
        from collections import deque
        seen = {s}
        q = deque([s])
        while q:
            u = q.popleft()
            for v, c in self.cap[u].items():
                if c > 0 and v not in seen:
                    seen.add(v)
                    q.append(v)
        return seen


class ConeRewriter:
    """Cone rewriting to a fixpoint. Selection per round is the paper's
    flow-based Δ^MIN (Alg. 3) by default, or greedy deepest-first with
    flow_select=False."""

    def __init__(self, max_rounds: int = 64, flow_select: bool = True):
        self.max_rounds = max_rounds
        self.flow_select = flow_select
        self.rewrites_applied = 0

    # --- single local rewrite ---------------------------------------------------
    def _try_rewrite_node(self, v: BinaryExpression, memo: Dict[int, int]
                          ) -> Optional[AbstractExpression]:
        """Attempt the cone rewrite at mul gate v; returns the replacement
        expression or None."""
        if not _is_mul(v):
            return None
        l_v = multiplicative_depth(v, memo)

        for t, chain_side in ((v.left, v.right), (v.right, v.left)):
            operands = _flatten_add_chain(chain_side)
            if operands is None or len(operands) < 2:
                continue
            add_op = chain_side.operator
            mul_op = v.operator
            # find the unique critical operand u (an AND/MUL gate at l_v - 1)
            crit = [o for o in operands
                    if multiplicative_depth(o, memo) == l_v - 1]
            if len(crit) != 1 or not _is_mul(crit[0]):
                continue
            u = crit[0]
            ys = [o for o in operands if o is not u]
            if any(multiplicative_depth(y, memo) > l_v - 2 for y in ys):
                continue
            if multiplicative_depth(t, memo) > l_v - 3:
                continue
            # split u = t' * U' with U' the critical side
            l_u = l_v - 1
            for t_p, u_core in ((u.left, u.right), (u.right, u.left)):
                if multiplicative_depth(u_core, memo) != l_u - 1:
                    continue
                if multiplicative_depth(t_p, memo) > l_v - 3:
                    continue
                # v' = U'*(t'*t) + t*(y_1+...+y_r)
                tt = BinaryExpression(t_p.clone(), mul_op, t.clone())
                left = BinaryExpression(u_core.clone(), mul_op, tt)
                y_chain = _rebuild_add([y.clone() for y in ys], add_op)
                right = BinaryExpression(t.clone(), mul_op, y_chain)
                return BinaryExpression(left, add_op, right)
        return None

    # --- Alg. 2 + Alg. 3: C^AND construction and minimum cone selection ---------
    def _flow_cut(self, root: AbstractExpression, memo: Dict[int, int]
                  ) -> Optional[List[BinaryExpression]]:
        """Δ^MIN for one round: the minimum set of REDUCIBLE critical AND
        gates whose cones cut every critical path. Built as a minimum
        vertex cut (node-split max flow) over C^AND — critical AND gates
        linked through critical XOR segments; capacity 1 on reducible
        gates, ∞ on irreducible ones. Returns None when no finite cut
        exists (some critical path carries no reducible cone)."""
        l_max = multiplicative_depth(root, memo)
        if l_max < 3:
            return None
        g = _FlowGraph()
        S, T = "S", "T"
        g.cap.setdefault(S, {})
        g.cap.setdefault(T, {})
        nodes: Dict[int, BinaryExpression] = {}
        reducible_memo: Dict[int, bool] = {}

        def reducible(v: BinaryExpression) -> bool:
            k = id(v)
            if k not in reducible_memo:
                reducible_memo[k] = self._try_rewrite_node(v, memo) is not None
            return reducible_memo[k]

        def walk(v: AbstractExpression, above) -> None:
            # v is on a critical path; `above` = in-node of the nearest
            # critical AND ancestor (or T at the top)
            here = above
            if _is_mul(v):
                vin, vout = ("in", id(v)), ("out", id(v))
                if id(v) not in nodes:
                    nodes[id(v)] = v
                    g.add_edge(vin, vout, 1 if reducible(v) else _INF)
                g.add_edge(vout, above, _INF)
                here = vin
            gate = 1 if _is_mul(v) else 0
            d_v = multiplicative_depth(v, memo)
            kids = [c for c in v.children()
                    if isinstance(c, AbstractExpression)
                    and multiplicative_depth(c, memo) == d_v - gate]
            if d_v - gate == 0:
                # the critical path bottoms out here (leaf or shallow core)
                g.add_edge(S, here, _INF)
                return
            for c in kids:
                walk(c, here)

        walk(root, T)
        flow = g.max_flow(S, T, limit=_INF // 2)
        if flow >= _INF // 2 or flow == 0:
            return None
        reachable = g.min_cut_side(S)
        cut = [nodes[k] for k in nodes
               if ("in", k) in reachable and ("out", k) not in reachable]
        return cut or None

    @staticmethod
    def _attached(v: AbstractNode, root: AbstractNode) -> bool:
        while v is not None:
            if v is root:
                return True
            v = v.parent
        return False

    # --- circuit-level entry ------------------------------------------------------
    def rewrite_expression(self, expr: AbstractExpression) -> AbstractExpression:
        """Reduce the multiplicative depth of one expression to a fixpoint.
        Each round rewrites Δ^MIN (flow_select) or the single deepest
        rewritable cone (greedy fallback)."""
        root = expr
        for _ in range(self.max_rounds):
            memo: Dict[int, int] = {}
            l_max = multiplicative_depth(root, memo)
            if l_max < 3:
                break  # depth < 3 cannot be reduced by this rewrite
            replaced = False
            if self.flow_select:
                cut = self._flow_cut(root, memo)
                for v in (cut or []):
                    if v is not root and not self._attached(v, root):
                        continue   # detached by an earlier rewrite this round
                    fresh: Dict[int, int] = {}
                    replacement = self._try_rewrite_node(v, fresh)
                    if replacement is None:
                        continue
                    if v is root:
                        root = replacement
                    else:
                        v.parent.replace_child(v, replacement)
                    self.rewrites_applied += 1
                    replaced = True
            if not replaced:
                # greedy: deepest rewritable critical mul gate, one per round
                candidates = [n for n in root.iter_preorder()
                              if _is_mul(n)
                              and multiplicative_depth(n, memo) >= 3]
                candidates.sort(key=lambda n: -multiplicative_depth(n, memo))
                for v in candidates:
                    replacement = self._try_rewrite_node(v, memo)
                    if replacement is None:
                        continue
                    if v is root:
                        root = replacement
                    else:
                        v.parent.replace_child(v, replacement)
                    self.rewrites_applied += 1
                    replaced = True
                    break
            if not replaced:
                break
        return root

    def rewrite_ast(self, ast: Block, rebalance: bool = True) -> None:
        """Rewrite every statement expression in a program. With rebalance
        (default), associative mul chains are depth-balanced first — the
        cone rewrite then only fires where slack genuinely exists."""
        def process(expr: AbstractExpression) -> AbstractExpression:
            if rebalance:
                expr = rebalance_depth(expr)
            return self.rewrite_expression(expr)

        for stmt in ast.iter_preorder():
            if isinstance(stmt, Assignment):
                stmt.value = process(stmt.value)
            elif isinstance(stmt, VariableDeclaration) and stmt.value is not None:
                stmt.value = process(stmt.value)
            elif isinstance(stmt, Return) and stmt.value is not None:
                stmt.value = process(stmt.value)


def run_cone_rewriting(ast: Block, max_rounds: int = 64,
                       rebalance: bool = True,
                       flow_select: bool = True) -> ConeRewriter:
    cr = ConeRewriter(max_rounds, flow_select=flow_select)
    cr.rewrite_ast(ast, rebalance=rebalance)
    return cr


def arithmetize_netlist(ast: Block) -> int:
    """Map boolean-netlist operators onto ring operators so a netlist
    circuit executes on the ARITHMETIC FHE backends: & (AND) → FHE mult,
    ^ (XOR) → FHE add. Over Z_t this is an exact ring re-interpretation —
    cone rewriting only uses ring identities (distributivity,
    re-association), so a rewritten netlist and its original compute the
    SAME Z_t value, which is the decrypt-equality gate the measured cone
    benchmark (benchsuite config4) checks. GF(2) boolean semantics would
    need t=2 (no slot packing); the depth/limb economics are identical.
    Returns the number of operators replaced."""
    from abc_tpu_torch.ast_ir.nodes import BinaryExpression
    from abc_tpu_torch.utils.operators import Op, Operator

    replaced = 0
    for node in ast.iter_preorder():
        if isinstance(node, BinaryExpression):
            op = node.operator.op
            if op in (Op.BITWISE_AND, Op.LOGICAL_AND):
                node.operator = Operator(Op.FHE_MUL)
                replaced += 1
            elif op == Op.BITWISE_XOR:
                node.operator = Operator(Op.FHE_ADD)
                replaced += 1
    return replaced
