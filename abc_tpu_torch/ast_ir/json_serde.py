"""JSON (de)serialization of the AST — the interchange IR.

Reference: AbstractNode::toJson (AbstractNode.h:147); README.md:129-131 calls
the JSON form "our real IR". The reference has no deserializer; we provide a
full round-trip (from_json) so compiled circuits can be checkpointed.
"""

from __future__ import annotations

import json
from typing import Any

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, Assignment, BinaryExpression, Block, Call, ExpressionList,
    For, Function, FunctionParameter, If, IndexAccess, Literal,
    OperatorExpression, Return, TernaryOperator, UnaryExpression, Variable,
    VariableDeclaration,
)
from abc_tpu_torch.utils.datatype import Datatype, Type
from abc_tpu_torch.utils.operators import Operator

_LITERAL_TYPES = {f"Literal{t.value.capitalize()}": t for t in Type}


def _parse_datatype(s: str) -> Datatype:
    secret = s.startswith("secret ")
    return Datatype.from_string(s[len("secret "):] if secret else s, secret)


def from_json(d: dict) -> AbstractNode:
    """Reconstruct an AST from its to_json() dict."""
    t = d["type"]
    if t in _LITERAL_TYPES:
        lt = _LITERAL_TYPES[t]
        v: Any = d["value"]
        if lt == Type.BOOL:
            v = bool(v)
        elif lt == Type.INT:
            v = int(v)
        elif lt in (Type.FLOAT, Type.DOUBLE):
            v = float(v)
        return Literal(v, lt)
    if t == "Variable":
        return Variable(d["identifier"])
    if t == "BinaryExpression":
        return BinaryExpression(from_json(d["leftSide"]),
                                Operator.from_symbol(d["operator"]),
                                from_json(d["rightSide"]))
    if t == "OperatorExpression":
        return OperatorExpression(Operator.from_symbol(d["operator"]),
                                  [from_json(o) for o in d["operands"]])
    if t == "UnaryExpression":
        return UnaryExpression(from_json(d["operand"]), Operator.from_symbol(d["operator"]))
    if t == "ExpressionList":
        return ExpressionList([from_json(e) for e in d["expressions"]])
    if t == "IndexAccess":
        return IndexAccess(from_json(d["target"]), from_json(d["index"]))
    if t == "Call":
        return Call(d["identifier"], [from_json(a) for a in d["arguments"]])
    if t == "TernaryOperator":
        return TernaryOperator(from_json(d["condition"]), from_json(d["thenExpr"]),
                               from_json(d["elseExpr"]))
    if t == "FunctionParameter":
        return FunctionParameter(_parse_datatype(d["parameterType"]), d["identifier"])
    if t == "Block":
        return Block([from_json(s) for s in d["statements"]])
    if t == "Assignment":
        return Assignment(from_json(d["target"]), from_json(d["value"]))
    if t == "VariableDeclaration":
        return VariableDeclaration(_parse_datatype(d["datatype"]), from_json(d["target"]),
                                   from_json(d["value"]) if "value" in d else None)
    if t == "If":
        return If(from_json(d["condition"]), from_json(d["thenBranch"]),
                  from_json(d["elseBranch"]) if "elseBranch" in d else None)
    if t == "For":
        return For(from_json(d["initializer"]), from_json(d["condition"]),
                   from_json(d["update"]), from_json(d["body"]))
    if t == "Return":
        return Return(from_json(d["value"]) if "value" in d else None)
    if t == "Function":
        return Function(_parse_datatype(d["returnType"]), d["identifier"],
                        [from_json(p) for p in d["parameters"]], from_json(d["body"]))
    raise ValueError(f"unknown node type in JSON: {t!r}")


def dumps(node: AbstractNode, **kwargs) -> str:
    return json.dumps(node.to_json(), **kwargs)


def loads(s: str) -> AbstractNode:
    return from_json(json.loads(s))
