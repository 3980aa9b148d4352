"""Dead-store elimination over the data-flow graph — the DFG's consumer in
the compile pipeline (the reference builds its DFG as the batching
prerequisite, SURVEY.md §2 build-order step 6, but nothing in its tree ever
queries it; here the pipeline uses it to drop writes no one reads).

Liveness over the DFG (writer → reader edges, passes/cfg.py):
  * Return statements are live.
  * A possible LAST writer of a live-out variable (an output the client
    decrypts) is live — `live_out=None` keeps every variable's final
    writers, so the default only removes stores that are overwritten
    before any read.
  * Any writer with a live DFG reader is live (fixpoint; loop-carried
    self-edges converge).

Removed: non-live Assignments, and non-live VariableDeclarations whose
identifier no live node touches. A non-live declaration whose identifier IS
still live elsewhere keeps its declaration but its initializer computation
is replaced by a zero literal (the runtime requires initialized
declarations, runtime/executor.py; the dead work — e.g. a ct·ct multiply —
is what gets dropped). Structural statements (If/For/Block/Function)
always stay.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from abc_tpu_torch.ast_ir.nodes import (
    Assignment, Block, Literal, LiteralInt, Return, VariableDeclaration,
)
from abc_tpu_torch.passes.cfg import build_cfg


def run_dead_store_elimination(ast: Block,
                               input_identifiers: Iterable[str] = (),
                               live_out: Optional[Set[str]] = None) -> int:
    """Remove dead stores in place; returns the number removed."""
    v = build_cfg(ast, input_identifiers=tuple(input_identifiers),
                  ignore_non_declared=True)

    live = set()
    for gn in v.nodes:
        if isinstance(gn.ast_node, Return):
            live.add(gn)
    for identifier, writers in v.final_writers.items():
        if live_out is None or identifier in live_out:
            live.update(writers)

    changed = True
    while changed:
        changed = False
        for gn in v.nodes:
            if gn in live:
                continue
            if any(child in live for child in gn.dfg_children):
                live.add(gn)
                changed = True

    # identifiers any live node still touches (guards declarations)
    live_idents = set()
    for gn in live:
        for sid in gn.accesses:
            live_idents.add(sid.identifier)

    removed = 0
    for gn in v.nodes:
        node = gn.ast_node
        if gn in live:
            continue
        if isinstance(node, Assignment):
            pass
        elif isinstance(node, VariableDeclaration):
            if node.target.identifier in live_idents:
                # declaration must stay (later live writes need it); the
                # dead initializer computation is replaced by a zero
                if node.value is not None and not (
                        isinstance(node.value, Literal)
                        and node.value.value in (0, False)):
                    node.value = LiteralInt(0)
                    removed += 1
                continue
        else:
            continue   # structural nodes stay
        parent = node.parent
        if isinstance(parent, Block):
            try:
                idx = parent.statements.index(node)
            except ValueError:
                continue
            parent.statements[idx] = None
            removed += 1
    if removed:
        for n in ast.iter_preorder():
            if isinstance(n, Block):
                n.remove_null_statements()
    return removed
