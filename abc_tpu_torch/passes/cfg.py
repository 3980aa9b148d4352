"""Control-flow + data-flow graph construction over statements.

Reference: src/visitor/controlFlowGraph/ControlFlowGraphVisitor.cpp,
GraphNode.h, NodeRelationship.h. CFG shape (ASCII diagrams at
ControlFlowGraphVisitor.cpp:64-99 for For, :175-215 for If):
  * For: init stmts → condition → body stmts → update stmts → condition
    (back edge); condition → next statement
  * If: If-node(holds condition accesses) → then/else branches → join
  * the For condition — an expression — gets its own graph node because its
    variable accesses matter (:95-99)

DFG (buildDataflowGraph, :355-...): two passes — (1) BFS fixpoint over the
CFG propagating "last writer" sets per variable (loop bodies revisited until
stable), (2) for every node reading a variable, add an edge from each
possible last writer to the reader.
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Dict, List, Optional, Set

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, Assignment, Block, For, Function, FunctionParameter, If,
    IndexAccess, Return, Variable, VariableDeclaration,
)
from abc_tpu_torch.passes.visitor import ScopedVisitor
from abc_tpu_torch.utils.errors import CompilerError
from abc_tpu_torch.utils.scope import Scope, ScopedIdentifier


class VariableAccessType(enum.Enum):
    READ = 0
    WRITE = 1
    READ_AND_WRITE = 2


class GraphNode:
    """A node in the CFG/DFG, associated with one AST statement (or a For
    condition expression)."""

    def __init__(self, ast_node: AbstractNode):
        self.ast_node = ast_node
        self.cfg_children: List[GraphNode] = []
        self.cfg_parents: List[GraphNode] = []
        self.dfg_children: List[GraphNode] = []
        self.dfg_parents: List[GraphNode] = []
        self.accesses: Dict[ScopedIdentifier, VariableAccessType] = {}

    def add_cfg_child(self, child: "GraphNode") -> None:
        if child not in self.cfg_children:
            self.cfg_children.append(child)
            child.cfg_parents.append(self)

    def add_dfg_child(self, child: "GraphNode") -> None:
        if child not in self.dfg_children:
            self.dfg_children.append(child)
            child.dfg_parents.append(self)

    def reads(self) -> Set[ScopedIdentifier]:
        return {sid for sid, t in self.accesses.items()
                if t in (VariableAccessType.READ, VariableAccessType.READ_AND_WRITE)}

    def writes(self) -> Set[ScopedIdentifier]:
        return {sid for sid, t in self.accesses.items()
                if t in (VariableAccessType.WRITE, VariableAccessType.READ_AND_WRITE)}

    def __repr__(self) -> str:
        return f"<GraphNode {self.ast_node.node_type} {self.ast_node.unique_node_id}>"


class ControlFlowGraphVisitor(ScopedVisitor):
    """Builds the CFG while recording per-statement variable accesses
    (ref: SpecialControlFlowGraphVisitor)."""

    def __init__(self, ignore_non_declared_variables: bool = False):
        super().__init__()
        self.nodes: List[GraphNode] = []
        self._last_created: List[GraphNode] = []
        self._accesses: Dict[ScopedIdentifier, VariableAccessType] = {}
        self.ignore_non_declared = ignore_non_declared_variables

    # --- plumbing -------------------------------------------------------------
    def get_root_node(self) -> GraphNode:
        if not self.nodes:
            raise CompilerError("control flow graph is empty")
        return self.nodes[0]

    def _check_entrypoint(self, node: AbstractNode) -> None:
        if self.nodes:
            return
        if not isinstance(node, (Function, Block, If, For)):
            raise CompilerError(
                "ControlFlowGraphVisitor requires a Function, Block, For, or "
                f"If root node, got {node.node_type}")
        if self.current_scope is None:
            self.set_root_scope(Scope(node))

    def _append_node(self, ast_node: AbstractNode,
                     parents: Optional[List[GraphNode]] = None) -> GraphNode:
        gn = GraphNode(ast_node)
        for p in (self._last_created if parents is None else parents):
            p.add_cfg_child(gn)
        self._last_created = [gn]
        self.nodes.append(gn)
        return gn

    def _store_accesses(self, gn: GraphNode) -> None:
        gn.accesses = self._accesses
        self._accesses = {}

    def _mark_access(self, sid: ScopedIdentifier, access: VariableAccessType) -> None:
        existing = self._accesses.get(sid)
        if existing is None:
            self._accesses[sid] = access
        elif existing != access:
            self._accesses[sid] = VariableAccessType.READ_AND_WRITE

    def _resolve(self, identifier: str) -> Optional[ScopedIdentifier]:
        sid = self.current_scope.try_resolve(identifier)
        if sid is None:
            if self.ignore_non_declared:
                return None
            # variables declared outside the visited sub-AST become inputs
            # registered at the root scope (ref test:
            # dfg_simpleReadWriteAssignment_takeOutOfScopeDeclaredVarsAsInput)
            raise CompilerError(f"cannot resolve variable {identifier!r}")
        return sid

    # --- statement visits -------------------------------------------------------
    def visit_Assignment(self, node: Assignment) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        node.value.accept(self)
        target = node.target
        # collect written identifier; nested index targets read their indices
        indexed = False
        while isinstance(target, IndexAccess):
            indexed = True
            target.index.accept(self)
            target = target.target
        if isinstance(target, Variable):
            sid = self._resolve(target.identifier)
            if sid is not None:
                # an indexed store is a PARTIAL write (read-modify-write):
                # other slots survive, so prior writers stay live
                self._mark_access(sid, VariableAccessType.READ_AND_WRITE
                                  if indexed else VariableAccessType.WRITE)
        self._store_accesses(gn)

    def visit_Block(self, node: Block) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        super().visit_Block(node)
        self._store_accesses(gn)

    def visit_For(self, node: For) -> None:
        self._check_entrypoint(node)
        self._append_node(node)
        self.enter_scope(node)
        # initializer children directly (their Block is not a CFG node)
        for stmt in node.initializer.children():
            stmt.accept(self)
        last_in_initializer = list(self._last_created)
        # condition gets its own graph node (expression, but accesses matter)
        g_condition = self._append_node(node.condition)
        node.condition.accept(self)
        self._store_accesses(g_condition)
        last_condition = list(self._last_created)
        # body
        node.body.accept(self)
        last_in_body = list(self._last_created)
        # update statements
        for stmt in node.update.children():
            stmt.accept(self)
        last_in_update = list(self._last_created)
        self.exit_scope()
        # back edge: update (or body if no update) → condition
        if last_in_update and last_in_update != last_in_body:
            for upd in last_in_update:
                upd.add_cfg_child(g_condition)
        else:
            for b in last_in_body:
                b.add_cfg_child(g_condition)
        # condition → next statement
        self._last_created = last_condition

    def visit_Function(self, node: Function) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        self.enter_scope(node)
        for p in node.parameters:
            self.declare(p.identifier)
            sid = self._resolve(p.identifier)
            if sid is not None:
                self._mark_access(sid, VariableAccessType.WRITE)
        self._store_accesses(gn)
        node.body.accept(self)
        self.exit_scope()

    def visit_If(self, node: If) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        last_if = [gn]
        node.condition.accept(self)
        self._store_accesses(gn)
        self.enter_scope(node)
        node.then_branch.accept(self)
        self.exit_scope()
        last_then = list(self._last_created)
        if node.else_branch is not None:
            self._last_created = last_if
            self.enter_scope(node)
            node.else_branch.accept(self)
            self.exit_scope()
            self._last_created = list(self._last_created) + last_then
        else:
            self._last_created = last_if + last_then

    def visit_Return(self, node: Return) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        if node.value is not None:
            node.value.accept(self)
        self._store_accesses(gn)
        # Return terminates control flow: nothing flows from it to the next
        # statement (ref: cfg_ifProgram expects the trailing return's only
        # parent to be the If node, ControlFlowGraphVisitorTest.cpp:88-123)
        self._last_created = []

    def visit_VariableDeclaration(self, node: VariableDeclaration) -> None:
        self._check_entrypoint(node)
        gn = self._append_node(node)
        if node.value is not None:
            node.value.accept(self)
        sid = self.declare(node.target.identifier)
        self._mark_access(sid, VariableAccessType.WRITE)
        self._store_accesses(gn)

    # --- expression visits -------------------------------------------------------
    def visit_Variable(self, node: Variable) -> None:
        sid = self._resolve(node.identifier)
        if sid is not None:
            self._mark_access(sid, VariableAccessType.READ)

    def visit_FunctionParameter(self, node: FunctionParameter) -> None:
        sid = self._resolve(node.identifier)
        if sid is not None:
            self._mark_access(sid, VariableAccessType.WRITE)

    # --- data flow graph ----------------------------------------------------------
    def build_dataflow_graph(self) -> None:
        """Two-pass DFG construction (ref: buildDataflowGraph).

        Pass 1: BFS fixpoint over the CFG propagating, per node, the map
        {variable → set of possible last-writer nodes} at node ENTRY; a
        node's EXIT map replaces the entry sets for every variable it writes.
        Loop back edges make this iterate until stable.
        Pass 2: for each read, add a DFG edge from every possible last writer.
        """
        if not self.nodes:
            raise CompilerError("run the visitor before building the DFG")
        entry: Dict[int, Dict[ScopedIdentifier, frozenset]] = {}
        exit_: Dict[int, Dict[ScopedIdentifier, frozenset]] = {}

        root = self.get_root_node()
        queue = deque([root])
        while queue:
            gn = queue.popleft()
            key = id(gn)
            # entry = union over parents' exit maps
            incoming: Dict[ScopedIdentifier, Set[GraphNode]] = {}
            for p in gn.cfg_parents:
                for sid, writers in exit_.get(id(p), {}).items():
                    incoming.setdefault(sid, set()).update(writers)
            new_entry = {sid: frozenset(w) for sid, w in incoming.items()}
            new_exit = dict(new_entry)
            for sid in gn.writes():
                new_exit[sid] = frozenset({gn})
            if entry.get(key) == new_entry and exit_.get(key) == new_exit:
                continue  # no change → no need to repropagate
            entry[key] = new_entry
            exit_[key] = new_exit
            queue.extend(gn.cfg_children)

        for gn in self.nodes:
            node_entry = entry.get(id(gn), {})
            for sid in gn.reads():
                for writer in node_entry.get(sid, ()):
                    writer.add_dfg_child(gn)

        # possible last writers at program exit, per identifier — the
        # live-out roots for downstream consumers (dead-store elimination)
        self.final_writers: Dict[str, Set[GraphNode]] = {}
        terminals = [gn for gn in self.nodes if not gn.cfg_children]
        for gn in terminals:
            for sid, writers in exit_.get(id(gn), {}).items():
                self.final_writers.setdefault(sid.identifier,
                                              set()).update(writers)


def build_cfg(ast: AbstractNode, input_identifiers=(),
              ignore_non_declared: bool = False) -> ControlFlowGraphVisitor:
    """Build CFG + DFG over `ast`; program inputs (declared elsewhere) are
    pre-registered in the root scope."""
    v = ControlFlowGraphVisitor(ignore_non_declared)
    root = Scope(ast)
    for name in input_identifiers:
        root.add_identifier(name)
    v.set_root_scope(root)
    ast.accept(v)
    v.build_dataflow_graph()
    return v
