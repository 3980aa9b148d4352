"""Error types with source positions.

Reference: include/ast_opt/parser/Errors.h:11-39 (stork::Error hierarchy with
line/char info and formatError pretty-printer).
"""

from __future__ import annotations


class AbcError(Exception):
    """Base for all abc_tpu errors."""


class PositionedError(AbcError):
    """Error carrying a source position (line, char index)."""

    def __init__(self, message: str, line: int = 0, char: int = 0):
        self.message = message
        self.line = line
        self.char = char
        super().__init__(self.format())

    KIND = "Error"

    def format(self) -> str:
        return f"{self.KIND} at line {self.line}, char {self.char}: {self.message}"


class ParsingError(PositionedError):
    KIND = "Parsing error"


class SyntaxError_(PositionedError):
    KIND = "Syntax error"


class UnexpectedError(PositionedError):
    KIND = "Unexpected error"


class UnexpectedSyntaxError(SyntaxError_):
    def __init__(self, unexpected: str, line: int = 0, char: int = 0):
        super().__init__(f"unexpected '{unexpected}'", line, char)


class ExpectedSyntaxError(SyntaxError_):
    def __init__(self, expected: str, line: int = 0, char: int = 0):
        super().__init__(f"expected '{expected}'", line, char)


class SemanticError(PositionedError):
    KIND = "Semantic error"


class CompilerError(AbcError):
    """Error in a compiler pass (type checking, lowering, batching...)."""


class RuntimeExecutionError(AbcError):
    """Error while executing a compiled program."""


def format_error(err: PositionedError, source: str) -> str:
    """Pretty-print an error with the offending source line underlined.

    Reference: Errors.h:39 formatError.
    """
    lines = source.splitlines()
    out = [err.format()]
    if 0 <= err.line < len(lines):
        out.append(lines[err.line])
        out.append(" " * max(err.char, 0) + "^")
    return "\n".join(out)
