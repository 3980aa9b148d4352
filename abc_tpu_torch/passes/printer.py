"""AST printers.

Reference: PrintVisitor.h (indented node-type dump) and
ProgramPrintVisitor.h / src/visitor/ProgramPrintVisitor.cpp:203 (pretty-print
back to the surface language — the inverse of the parser, README.md:129-131).
"""

from __future__ import annotations

from abc_tpu_torch.ast_ir.nodes import (
    AbstractNode, Assignment, BinaryExpression, Block, Call, ExpressionList,
    For, Function, If, IndexAccess, Literal, OperatorExpression, Return,
    TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
    FunctionParameter,
)
from abc_tpu_torch.utils.datatype import Type


def _lit(node: Literal) -> str:
    if node.literal_type == Type.BOOL:
        return "true" if node.value else "false"
    if node.literal_type == Type.STRING:
        return f'"{node.value}"'
    if node.literal_type == Type.CHAR:
        return f"'{node.value}'"
    return str(node.value)


def expr_to_string(node: AbstractNode) -> str:
    """Render an expression to surface syntax (fully parenthesized, like the
    reference's ProgramPrintVisitor)."""
    if isinstance(node, Literal):
        return _lit(node)
    if isinstance(node, Variable):
        return node.identifier
    if isinstance(node, FunctionParameter):
        return node.identifier
    if isinstance(node, BinaryExpression):
        return f"({expr_to_string(node.left)} {node.operator} {expr_to_string(node.right)})"
    if isinstance(node, OperatorExpression):
        sep = f" {node.operator} "
        return "(" + sep.join(expr_to_string(o) for o in node.operands if o is not None) + ")"
    if isinstance(node, UnaryExpression):
        return f"({node.operator}{expr_to_string(node.operand)})"
    if isinstance(node, ExpressionList):
        return "{" + ", ".join(expr_to_string(e) for e in node.expressions if e is not None) + "}"
    if isinstance(node, IndexAccess):
        return f"{expr_to_string(node.target)}[{expr_to_string(node.index)}]"
    if isinstance(node, Call):
        return f"{node.identifier}(" + ", ".join(
            expr_to_string(a) for a in node.arguments if a is not None) + ")"
    if isinstance(node, TernaryOperator):
        return (f"({expr_to_string(node.condition)} ? {expr_to_string(node.then_expr)}"
                f" : {expr_to_string(node.else_expr)})")
    raise TypeError(f"not an expression: {node.node_type}")


def _inline_block(node: Block) -> str:
    """Render a Block's statements on one line without braces (for For headers)."""
    parts = []
    for s in node.statements:
        if s is None:
            continue
        parts.append(program_to_string(s, 0).strip())
    return " ".join(parts)


def program_to_string(node: AbstractNode, indent: int = 0) -> str:
    """Render a statement (or whole program) to surface syntax."""
    pad = "  " * indent
    if isinstance(node, Block):
        inner = "".join(program_to_string(s, indent + 1)
                        for s in node.statements if s is not None)
        return f"{pad}{{\n{inner}{pad}}}\n"
    if isinstance(node, VariableDeclaration):
        init = f" = {expr_to_string(node.value)}" if node.value is not None else ""
        return f"{pad}{node.datatype} {node.target.identifier}{init};\n"
    if isinstance(node, Assignment):
        return f"{pad}{expr_to_string(node.target)} = {expr_to_string(node.value)};\n"
    if isinstance(node, If):
        s = f"{pad}if ({expr_to_string(node.condition)})\n"
        s += program_to_string(node.then_branch, indent)
        if node.else_branch is not None:
            s += f"{pad}else\n" + program_to_string(node.else_branch, indent)
        return s
    if isinstance(node, For):
        head = (f"{pad}for ({_inline_block(node.initializer)} "
                f"{expr_to_string(node.condition)}; "
                f"{_inline_block(node.update).rstrip(';')})\n")
        return head + program_to_string(node.body, indent)
    if isinstance(node, Return):
        if node.value is not None:
            return f"{pad}return {expr_to_string(node.value)};\n"
        return f"{pad}return;\n"
    if isinstance(node, Function):
        params = ", ".join(f"{p.parameter_type} {p.identifier}" for p in node.parameters)
        return (f"{pad}public {node.return_type} {node.identifier}({params})\n"
                + program_to_string(node.body, indent))
    # expressions print inline
    return pad + expr_to_string(node)


class PrintVisitor:
    """Indented node-type dump (ref: PrintVisitor.h)."""

    def __init__(self) -> None:
        self.lines: list[str] = []
        self._indent = 0

    def visit(self, node: AbstractNode) -> str:
        self.lines.append("  " * self._indent + node.node_type)
        self._indent += 1
        for c in node.children():
            c.accept(self)
        self._indent -= 1
        return "\n".join(self.lines)
