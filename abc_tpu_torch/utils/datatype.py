"""Datatype = base type × secret flag.

Reference: include/ast_opt/utilities/Datatype.h:8-53 (Type enum
{BOOL,CHAR,INT,FLOAT,DOUBLE,STRING,VOID} with isSecret flag; `secret` keyword
in the surface language marks ciphertext values).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Type(enum.Enum):
    BOOL = "bool"
    CHAR = "char"
    INT = "int"
    FLOAT = "float"
    DOUBLE = "double"
    STRING = "string"
    VOID = "void"

    def __str__(self) -> str:
        return self.value


_BY_NAME = {t.value: t for t in Type}


@dataclass(frozen=True)
class Datatype:
    type: Type
    secret: bool = False

    @staticmethod
    def from_string(name: str, secret: bool = False) -> "Datatype":
        if name not in _BY_NAME:
            raise ValueError(f"unknown type name: {name!r}")
        return Datatype(_BY_NAME[name], secret)

    def is_numeric(self) -> bool:
        return self.type in (Type.INT, Type.FLOAT, Type.DOUBLE, Type.CHAR, Type.BOOL)

    def with_secret(self, secret: bool) -> "Datatype":
        return Datatype(self.type, secret)

    def __str__(self) -> str:
        return f"secret {self.type}" if self.secret else str(self.type)
