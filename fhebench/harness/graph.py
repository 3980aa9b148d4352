"""A captured CUDA graph's kernel nodes, read from the graph's own node
list (cudaGraphDebugDotPrint through CUDAGraph.debug_dump; the program
captures with keep_graph=True): what every replay launches. A frozen copy
of chip_smoke.py's `dot_nodes` and `graph_nodes`; the profiler is no
census of a replay, since it loses kernel records."""

from __future__ import annotations

import os
import re
import tempfile
import warnings
from typing import Dict, Tuple

# one node of cudaGraphDebugDotPrint's text: its type, then (a kernel node)
# "{ID | <id> (topoId: <t>) | <mangled symbol>\<\<\<grid,block,smem\>\>\>}"
_DOT_NODE = re.compile(
    r'^"graph_\d+_node_\d+"\[[^\n]*?label="\{(\w+)(.*?)\}"\];$', re.M | re.S)
_DOT_KERNEL = re.compile(r"\{ID \|[^|]*\| ([^\s|}\\]+)")


def dot_nodes(text: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """({kernel name: nodes}, {other node type: nodes}) of a graph's
    cudaGraphDebugDotPrint text."""
    kernels, others = {}, {}
    for kind, body in _DOT_NODE.findall(text):
        if kind == "KERNEL":
            name = _DOT_KERNEL.search(body)
            if name is None:
                raise ValueError(f"a kernel node without a name: {body!r}")
            kernels[name.group(1)] = kernels.get(name.group(1), 0) + 1
        else:
            others[kind] = others.get(kind, 0) + 1
    return kernels, others


def graph_nodes(graph) -> Tuple[Dict[str, int], Dict[str, int]]:
    """dot_nodes of a captured torch.cuda.CUDAGraph, written to a file in
    TMPDIR and read back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="DEBUG: calling")
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("a graph's node list was not written "
                               "(captured without keep_graph=True?)")
        with open(path) as f:
            text = f.read()
    kernels, others = dot_nodes(text)
    if not kernels:
        raise RuntimeError(f"a graph's node list holds no kernel: "
                           f"{text[:300]!r}")
    return kernels, others
