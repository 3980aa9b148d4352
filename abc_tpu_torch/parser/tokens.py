"""Token definitions for the DSL.

Reference: include/ast_opt/parser/Tokens.h:10-113 (reservedTokens enum incl.
FHE operators +++/---/***, `secret`/`public`/`rotate` keywords) and
src/parser/Tokens.cpp (keyword/operator lookup tables).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class TokKind(enum.Enum):
    RESERVED = "reserved"     # keyword or operator/punctuation
    IDENTIFIER = "identifier"
    INT = "int"
    DOUBLE = "double"
    FLOAT = "float"
    STRING = "string"
    CHAR = "char"
    EOF = "eof"


# All reserved operator/punctuation spellings, longest-match-first at lexing.
OPERATORS = [
    "+++", "---", "***", "<<=", ">>=",
    "++", "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
    "<<", ">>", "<=", ">=", "==", "!=", "&&", "||",
    "+", "-", "*", "/", "%", "&", "|", "^", "!", "~", "<", ">", "=",
    "?", ":", ",", ";", "(", ")", "{", "}", "[", "]",
]

KEYWORDS = {
    "if", "else", "elif", "switch", "case", "default",
    "for", "while", "do", "break", "continue", "return",
    "function", "sizeof", "tostring",
    "bool", "char", "int", "float", "double", "string", "void",
    "secret", "public", "rotate", "true", "false",
}

TYPE_KEYWORDS = {"bool", "char", "int", "float", "double", "string", "void"}


@dataclass
class Token:
    kind: TokKind
    value: Any          # spelling for RESERVED/IDENTIFIER; parsed value for literals
    line: int
    char: int

    def is_reserved(self, spelling: str | None = None) -> bool:
        if self.kind != TokKind.RESERVED:
            return False
        return spelling is None or self.value == spelling

    def is_identifier(self) -> bool:
        return self.kind == TokKind.IDENTIFIER

    def is_eof(self) -> bool:
        return self.kind == TokKind.EOF

    def __repr__(self) -> str:
        return f"Token({self.kind.value}, {self.value!r}, L{self.line}:{self.char})"
