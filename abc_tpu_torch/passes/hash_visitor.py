"""Structural AST hashing.

Reference: src/visitor/HashVisitor.cpp is a stub ("currently just
uniqueNodeId; real structural hash is TODO", HashVisitor.cpp:8-10) intended
for the Vectorizer's structure-compatibility check (Vectorizer.h:45). This is
the real implementation: a bottom-up Merkle-style hash over node type +
semantic attributes + child hashes, so structurally identical subtrees hash
equal regardless of node identity.

Two modes:
  * exact: variable names and literal values participate
  * shape: names/values are erased — detects "same computation shape",
    the batching-compatibility notion of Vectorizer.h:16-107
"""

from __future__ import annotations

import hashlib
from typing import Dict

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, BinaryExpression, Call, Function, FunctionParameter,
    Literal, OperatorExpression, UnaryExpression, Variable,
    VariableDeclaration,
)


def _attrs(node: AbstractNode, shape_only: bool) -> str:
    if isinstance(node, Literal):
        return "lit" if shape_only else f"lit:{node.literal_type.value}:{node.value!r}"
    if isinstance(node, Variable):
        return "var" if shape_only else f"var:{node.identifier}"
    if isinstance(node, (BinaryExpression, OperatorExpression, UnaryExpression)):
        return f"op:{node.operator}"
    if isinstance(node, Call):
        return f"call:{node.identifier}"
    if isinstance(node, FunctionParameter):
        return "param" if shape_only else f"param:{node.identifier}:{node.parameter_type}"
    if isinstance(node, VariableDeclaration):
        return "decl" if shape_only else f"decl:{node.datatype}"
    if isinstance(node, Function):
        return f"fn:{node.identifier}:{node.return_type}"
    return ""


class HashVisitor:
    """Computes a hash for every node (ref: HashVisitor.h API shape)."""

    def __init__(self, shape_only: bool = False):
        self.shape_only = shape_only
        self.hashes: Dict[str, str] = {}      # unique_node_id → hex digest

    def visit(self, node: AbstractNode) -> str:
        child_digests = [self.visit(c) for c in node.children()]
        h = hashlib.blake2b(digest_size=16)
        h.update(type(node).__name__.encode())
        h.update(_attrs(node, self.shape_only).encode())
        for d in child_digests:
            h.update(bytes.fromhex(d))
        digest = h.hexdigest()
        self.hashes[node.unique_node_id] = digest
        return digest


def structural_hash(node: AbstractNode, shape_only: bool = False) -> str:
    return HashVisitor(shape_only).visit(node)
