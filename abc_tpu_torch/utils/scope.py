"""Lexical scopes and scoped identifiers.

Reference: include/ast_opt/utilities/Scope.h:11-177 (scope tree; identifier
resolution walks parent scopes :104-143; ScopedIdentifier with hash/equality
:163-177) and VariableMap.h:9 (ScopedIdentifier-keyed map with change flags).
"""

from __future__ import annotations

from typing import Dict, Generic, Iterator, List, Optional, Set, Tuple, TypeVar

from abc_tpu_torch.ast_ir.nodes import AbstractNode
from abc_tpu_torch.utils.errors import SemanticError


class Scope:
    """One lexical scope, linked to the AST node that opened it."""

    def __init__(self, ast_node: AbstractNode, parent: Optional["Scope"] = None):
        self.ast_node = ast_node
        self.parent = parent
        self.identifiers: Set[str] = set()
        self.children: List[Scope] = []
        if parent is not None:
            parent.children.append(self)

    def add_identifier(self, identifier: str) -> "ScopedIdentifier":
        self.identifiers.add(identifier)
        return ScopedIdentifier(self, identifier)

    def local_contains(self, identifier: str) -> bool:
        return identifier in self.identifiers

    def resolve_identifier(self, identifier: str) -> "ScopedIdentifier":
        """Find the declaring scope by walking up (ref: Scope.h:104-143)."""
        scope: Optional[Scope] = self
        while scope is not None:
            if identifier in scope.identifiers:
                return ScopedIdentifier(scope, identifier)
            scope = scope.parent
        raise SemanticError(f"identifier {identifier!r} not declared in any accessible scope")

    def try_resolve(self, identifier: str) -> Optional["ScopedIdentifier"]:
        try:
            return self.resolve_identifier(identifier)
        except SemanticError:
            return None

    def __repr__(self) -> str:
        return f"<Scope of {self.ast_node.node_type} ids={sorted(self.identifiers)}>"


class ScopedIdentifier:
    """(declaring scope, identifier) pair — hashable and comparable by
    (scope identity, name), matching the reference's semantic-equality
    workaround (VariableMap.h:30-44)."""

    __slots__ = ("scope", "identifier")

    def __init__(self, scope: Scope, identifier: str):
        self.scope = scope
        self.identifier = identifier

    def __eq__(self, other) -> bool:
        return (isinstance(other, ScopedIdentifier)
                and self.scope is other.scope
                and self.identifier == other.identifier)

    def __hash__(self) -> int:
        return hash((id(self.scope), self.identifier))

    def __repr__(self) -> str:
        return f"ScopedIdentifier({self.identifier!r} @ {self.scope.ast_node.node_type})"


T = TypeVar("T")


class VariableMap(Generic[T]):
    """Map keyed by ScopedIdentifier, tracking which entries changed since the
    last reset (ref: VariableMap.h — resetChangeFlags/changedEntries)."""

    def __init__(self, initial: Optional[Dict[ScopedIdentifier, T]] = None):
        self._map: Dict[ScopedIdentifier, T] = dict(initial or {})
        self._changed: Set[ScopedIdentifier] = set()

    def get(self, key: ScopedIdentifier) -> T:
        return self._map[key]

    def try_get(self, key: ScopedIdentifier) -> Optional[T]:
        return self._map.get(key)

    def contains(self, key: ScopedIdentifier) -> bool:
        return key in self._map

    def insert_or_assign(self, key: ScopedIdentifier, value: T) -> None:
        self._map[key] = value
        self._changed.add(key)

    def erase(self, key: ScopedIdentifier) -> None:
        self._map.pop(key, None)
        self._changed.discard(key)

    def reset_change_flags(self) -> None:
        self._changed.clear()

    def changed_entries(self) -> List[Tuple[ScopedIdentifier, T]]:
        return [(k, self._map[k]) for k in self._changed if k in self._map]

    def items(self) -> Iterator[Tuple[ScopedIdentifier, T]]:
        return iter(self._map.items())

    def copy(self) -> "VariableMap[T]":
        m: VariableMap[T] = VariableMap(self._map)
        m._changed = set(self._changed)
        return m

    def __len__(self) -> int:
        return len(self._map)
