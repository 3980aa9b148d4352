"""AST / IR core: AbstractNode and the ~20 concrete node classes.

Reference: include/ast_opt/ast/*.h (AbstractNode.h:43 base class with parent
pointer, clone :64, accept :82, toJson :147, uniqueNodeId :179-213; concrete
nodes per SURVEY.md §2.1). Node identity is object identity; uniqueNodeId is
"<NodeType>_<counter>" from a global counter (src/ast/AbstractNode.cpp:95-124).

Differences from the reference (deliberate, idiomatic-Python):
  - parent pointers are maintained automatically by the child setters, so no
    ParentSettingVisitor is needed after parsing (ref: Parser.cpp:51-53).
  - from_json() gives a full JSON round-trip; the reference only serializes
    (README.md:129-131 declares JSON the interchange IR but has no reader).
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator, List, Optional, Sequence

from abc_tpu_torch.utils.datatype import Datatype, Type
from abc_tpu_torch.utils.operators import Operator

_id_counter = itertools.count()


def reset_node_ids() -> None:
    """Reset the global node-id counter (test helper)."""
    global _id_counter
    _id_counter = itertools.count()


class AbstractNode:
    """Base class for all AST nodes (ref: AbstractNode.h:43)."""

    __slots__ = ("parent", "_unique_id")

    def __init__(self) -> None:
        self.parent: Optional[AbstractNode] = None
        self._unique_id: Optional[str] = None

    # --- identity -----------------------------------------------------------
    @property
    def unique_node_id(self) -> str:
        # lazily assigned, "<NodeType>_<n>" (ref: AbstractNode.cpp:95-124)
        if self._unique_id is None:
            self._unique_id = f"{type(self).__name__}_{next(_id_counter)}"
        return self._unique_id

    @property
    def node_type(self) -> str:
        return type(self).__name__

    # --- tree structure -----------------------------------------------------
    def children(self) -> List["AbstractNode"]:
        """Non-null children, in order (ref: NodeIterator, AbstractNode.h:222-292)."""
        return [c for c in self._child_slots() if c is not None]

    def _child_slots(self) -> List[Optional["AbstractNode"]]:
        """All child slots including null ones; override in subclasses."""
        return []

    def count_children(self) -> int:
        return len(self.children())

    def has_parent(self) -> bool:
        return self.parent is not None

    def _adopt(self, child: Optional["AbstractNode"]) -> Optional["AbstractNode"]:
        if child is not None:
            child.parent = self
        return child

    def iter_preorder(self) -> Iterator["AbstractNode"]:
        yield self
        for c in self.children():
            yield from c.iter_preorder()

    def replace_child(self, old: "AbstractNode", new: Optional["AbstractNode"]) -> None:
        """Replace a direct child (used by rewriting passes)."""
        for name in self._child_attrs():
            val = getattr(self, name)
            if val is old:
                setattr(self, name, self._adopt(new))
                return
            if isinstance(val, list):
                for i, item in enumerate(val):
                    if item is old:
                        val[i] = self._adopt(new)
                        return
        raise ValueError(f"{old.node_type} is not a child of {self.node_type}")

    def _child_attrs(self) -> Sequence[str]:
        return ()

    # --- cloning ------------------------------------------------------------
    def clone(self) -> "AbstractNode":
        """Deep copy with fresh node ids and no parent (ref: AbstractNode.h:64)."""
        raise NotImplementedError

    # --- visitor ------------------------------------------------------------
    def accept(self, visitor: Any) -> Any:
        return visitor.visit(self)

    # --- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        raise NotImplementedError

    def to_string(self, print_children: bool = True) -> str:
        from abc_tpu_torch.passes.printer import program_to_string  # local import: avoid cycle
        if print_children:
            return program_to_string(self)
        return self.node_type

    def __str__(self) -> str:
        return self.to_string()

    def __repr__(self) -> str:
        return f"<{self.node_type} {self.unique_node_id}>"


class AbstractExpression(AbstractNode):
    """Marker base for expressions (ref: AbstractExpression.h:6)."""
    __slots__ = ()


class AbstractStatement(AbstractNode):
    """Marker base for statements (ref: AbstractStatement.h:6)."""
    __slots__ = ()


class AbstractTarget(AbstractExpression):
    """Assignable expressions: Variable, IndexAccess, FunctionParameter
    (ref: AbstractTarget.h:7)."""
    __slots__ = ()


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class Literal(AbstractExpression):
    """Typed literal value (ref: Literal.h:37-174, one template for
    bool/char/int/float/double/string)."""

    __slots__ = ("value", "literal_type")

    def __init__(self, value: Any, literal_type: Optional[Type] = None):
        super().__init__()
        if literal_type is None:
            if isinstance(value, bool):
                literal_type = Type.BOOL
            elif isinstance(value, int):
                literal_type = Type.INT
            elif isinstance(value, float):
                literal_type = Type.DOUBLE
            elif isinstance(value, str):
                literal_type = Type.CHAR if len(value) == 1 else Type.STRING
            else:
                raise TypeError(f"unsupported literal value: {value!r}")
        self.value = value
        self.literal_type = literal_type

    def clone(self) -> "Literal":
        return Literal(self.value, self.literal_type)

    def to_json(self) -> dict:
        return {"type": f"Literal{self.literal_type.value.capitalize()}", "value": self.value}

    def __eq__(self, other):  # convenience for pass-level constant folding
        return isinstance(other, Literal) and self.value == other.value \
            and self.literal_type == other.literal_type

    def __hash__(self):
        return hash((self.literal_type, self.value))


# Convenience constructors matching the reference's LiteralBool/LiteralInt/...
def LiteralBool(v: bool) -> Literal: return Literal(bool(v), Type.BOOL)
def LiteralChar(v: str) -> Literal: return Literal(v, Type.CHAR)
def LiteralInt(v: int) -> Literal: return Literal(int(v), Type.INT)
def LiteralFloat(v: float) -> Literal: return Literal(float(v), Type.FLOAT)
def LiteralDouble(v: float) -> Literal: return Literal(float(v), Type.DOUBLE)
def LiteralString(v: str) -> Literal: return Literal(v, Type.STRING)


def is_literal(node: AbstractNode) -> bool:
    return isinstance(node, Literal)


class Variable(AbstractTarget):
    """Identifier reference (ref: Variable.h:9)."""

    __slots__ = ("identifier",)

    def __init__(self, identifier: str):
        super().__init__()
        self.identifier = identifier

    def clone(self) -> "Variable":
        return Variable(self.identifier)

    def to_json(self) -> dict:
        return {"type": "Variable", "identifier": self.identifier}


class BinaryExpression(AbstractExpression):
    """lhs ∘ rhs (ref: BinaryExpression.h:62-108)."""

    __slots__ = ("_left", "operator", "_right")

    def __init__(self, left: AbstractExpression, operator: Operator, right: AbstractExpression):
        super().__init__()
        self._left = self._adopt(left)
        self.operator = operator
        self._right = self._adopt(right)

    @property
    def left(self) -> AbstractExpression: return self._left
    @left.setter
    def left(self, v): self._left = self._adopt(v)
    @property
    def right(self) -> AbstractExpression: return self._right
    @right.setter
    def right(self, v): self._right = self._adopt(v)

    def _child_slots(self): return [self._left, self._right]
    def _child_attrs(self): return ("_left", "_right")

    def clone(self) -> "BinaryExpression":
        return BinaryExpression(self._left.clone(), self.operator, self._right.clone())

    def to_json(self) -> dict:
        return {"type": "BinaryExpression", "leftSide": self._left.to_json(),
                "operator": str(self.operator), "rightSide": self._right.to_json()}


class OperatorExpression(AbstractExpression):
    """n-ary operator node for flattened chains (ref: OperatorExpression.h:57-94)."""

    __slots__ = ("operator", "operands")

    def __init__(self, operator: Operator, operands: Sequence[AbstractExpression]):
        super().__init__()
        self.operator = operator
        self.operands: List[Optional[AbstractExpression]] = [self._adopt(o) for o in operands]

    def _child_slots(self): return list(self.operands)
    def _child_attrs(self): return ("operands",)

    def remove_null_operands(self) -> None:
        self.operands = [o for o in self.operands if o is not None]

    def append_operand(self, o: AbstractExpression) -> None:
        self.operands.append(self._adopt(o))

    def clone(self) -> "OperatorExpression":
        return OperatorExpression(self.operator, [o.clone() for o in self.operands if o is not None])

    def to_json(self) -> dict:
        return {"type": "OperatorExpression", "operator": str(self.operator),
                "operands": [o.to_json() for o in self.operands if o is not None]}


class UnaryExpression(AbstractExpression):
    """!x, ~x (ref: UnaryExpression.h:57-88)."""

    __slots__ = ("operator", "_operand")

    def __init__(self, operand: AbstractExpression, operator: Operator):
        super().__init__()
        self._operand = self._adopt(operand)
        self.operator = operator

    @property
    def operand(self) -> AbstractExpression: return self._operand
    @operand.setter
    def operand(self, v): self._operand = self._adopt(v)

    def _child_slots(self): return [self._operand]
    def _child_attrs(self): return ("_operand",)

    def clone(self) -> "UnaryExpression":
        return UnaryExpression(self._operand.clone(), self.operator)

    def to_json(self) -> dict:
        return {"type": "UnaryExpression", "operator": str(self.operator),
                "operand": self._operand.to_json()}


class ExpressionList(AbstractExpression):
    """{a, b, c} vector literal / SIMD operand (ref: ExpressionList.h:57-94)."""

    __slots__ = ("expressions",)

    def __init__(self, expressions: Sequence[AbstractExpression]):
        super().__init__()
        self.expressions: List[Optional[AbstractExpression]] = [self._adopt(e) for e in expressions]

    def _child_slots(self): return list(self.expressions)
    def _child_attrs(self): return ("expressions",)

    def remove_null_expressions(self) -> None:
        self.expressions = [e for e in self.expressions if e is not None]

    def clone(self) -> "ExpressionList":
        return ExpressionList([e.clone() for e in self.expressions if e is not None])

    def to_json(self) -> dict:
        return {"type": "ExpressionList",
                "expressions": [e.to_json() for e in self.expressions if e is not None]}


class IndexAccess(AbstractTarget):
    """target[index], nestable (ref: IndexAccess.h:57-95)."""

    __slots__ = ("_target", "_index")

    def __init__(self, target: AbstractTarget, index: AbstractExpression):
        super().__init__()
        self._target = self._adopt(target)
        self._index = self._adopt(index)

    @property
    def target(self) -> AbstractTarget: return self._target
    @target.setter
    def target(self, v): self._target = self._adopt(v)
    @property
    def index(self) -> AbstractExpression: return self._index
    @index.setter
    def index(self, v): self._index = self._adopt(v)

    def _child_slots(self): return [self._target, self._index]
    def _child_attrs(self): return ("_target", "_index")

    def clone(self) -> "IndexAccess":
        return IndexAccess(self._target.clone(), self._index.clone())

    def to_json(self) -> dict:
        return {"type": "IndexAccess", "target": self._target.to_json(),
                "index": self._index.to_json()}


class Call(AbstractExpression):
    """Builtin call; only rotate(ctxt, steps) is executable (ref: Call.h:7,
    Parser.cpp:236-249 hard-codes rotate)."""

    __slots__ = ("identifier", "arguments")

    def __init__(self, identifier: str, arguments: Sequence[AbstractExpression]):
        super().__init__()
        self.identifier = identifier
        self.arguments: List[Optional[AbstractExpression]] = [self._adopt(a) for a in arguments]

    def _child_slots(self): return list(self.arguments)
    def _child_attrs(self): return ("arguments",)

    def clone(self) -> "Call":
        return Call(self.identifier, [a.clone() for a in self.arguments if a is not None])

    def to_json(self) -> dict:
        return {"type": "Call", "identifier": self.identifier,
                "arguments": [a.to_json() for a in self.arguments if a is not None]}


class TernaryOperator(AbstractExpression):
    """c ? a : b (ref: TernaryOperator.h:66-116)."""

    __slots__ = ("_condition", "_then_expr", "_else_expr")

    def __init__(self, condition: AbstractExpression,
                 then_expr: AbstractExpression, else_expr: AbstractExpression):
        super().__init__()
        self._condition = self._adopt(condition)
        self._then_expr = self._adopt(then_expr)
        self._else_expr = self._adopt(else_expr)

    @property
    def condition(self): return self._condition
    @condition.setter
    def condition(self, v): self._condition = self._adopt(v)
    @property
    def then_expr(self): return self._then_expr
    @then_expr.setter
    def then_expr(self, v): self._then_expr = self._adopt(v)
    @property
    def else_expr(self): return self._else_expr
    @else_expr.setter
    def else_expr(self, v): self._else_expr = self._adopt(v)

    def _child_slots(self): return [self._condition, self._then_expr, self._else_expr]
    def _child_attrs(self): return ("_condition", "_then_expr", "_else_expr")

    def clone(self) -> "TernaryOperator":
        return TernaryOperator(self._condition.clone(), self._then_expr.clone(),
                               self._else_expr.clone())

    def to_json(self) -> dict:
        return {"type": "TernaryOperator", "condition": self._condition.to_json(),
                "thenExpr": self._then_expr.to_json(), "elseExpr": self._else_expr.to_json()}


class FunctionParameter(AbstractTarget):
    """Typed, named formal parameter (ref: FunctionParameter.h:56-58)."""

    __slots__ = ("parameter_type", "identifier")

    def __init__(self, parameter_type: Datatype, identifier: str):
        super().__init__()
        self.parameter_type = parameter_type
        self.identifier = identifier

    def clone(self) -> "FunctionParameter":
        return FunctionParameter(self.parameter_type, self.identifier)

    def to_json(self) -> dict:
        return {"type": "FunctionParameter", "parameterType": str(self.parameter_type),
                "identifier": self.identifier}


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

class Block(AbstractStatement):
    """{ stmts… }; supports null slots + remove_null_statements, used by
    rewriting passes (ref: Block.h:59-92)."""

    __slots__ = ("statements",)

    def __init__(self, statements: Optional[Sequence[Optional[AbstractStatement]]] = None):
        super().__init__()
        if statements is None:
            statements = []
        if isinstance(statements, AbstractStatement):
            statements = [statements]
        self.statements: List[Optional[AbstractStatement]] = [self._adopt(s) for s in statements]

    def _child_slots(self): return list(self.statements)
    def _child_attrs(self): return ("statements",)

    def append_statement(self, s: AbstractStatement) -> None:
        self.statements.append(self._adopt(s))

    def prepend_statement(self, s: AbstractStatement) -> None:
        self.statements.insert(0, self._adopt(s))

    def remove_null_statements(self) -> None:
        self.statements = [s for s in self.statements if s is not None]

    def has_null_statements(self) -> bool:
        return any(s is None for s in self.statements)

    def is_empty(self) -> bool:
        return len(self.children()) == 0

    def clone(self) -> "Block":
        return Block([s.clone() for s in self.statements if s is not None])

    def to_json(self) -> dict:
        return {"type": "Block",
                "statements": [s.to_json() for s in self.statements if s is not None]}


class Assignment(AbstractStatement):
    """target = value (ref: Assignment.h:58-100)."""

    __slots__ = ("_target", "_value")

    def __init__(self, target: AbstractTarget, value: AbstractExpression):
        super().__init__()
        self._target = self._adopt(target)
        self._value = self._adopt(value)

    @property
    def target(self) -> AbstractTarget: return self._target
    @target.setter
    def target(self, v): self._target = self._adopt(v)
    @property
    def value(self) -> AbstractExpression: return self._value
    @value.setter
    def value(self, v): self._value = self._adopt(v)

    def _child_slots(self): return [self._target, self._value]
    def _child_attrs(self): return ("_target", "_value")

    def clone(self) -> "Assignment":
        return Assignment(self._target.clone(), self._value.clone())

    def to_json(self) -> dict:
        return {"type": "Assignment", "target": self._target.to_json(),
                "value": self._value.to_json()}


class VariableDeclaration(AbstractStatement):
    """datatype var [= value] (ref: VariableDeclaration.h:66-122)."""

    __slots__ = ("datatype", "_target", "_value")

    def __init__(self, datatype: Datatype, target: Variable,
                 value: Optional[AbstractExpression] = None):
        super().__init__()
        self.datatype = datatype
        self._target = self._adopt(target)
        self._value = self._adopt(value)

    @property
    def target(self) -> Variable: return self._target
    @target.setter
    def target(self, v): self._target = self._adopt(v)
    @property
    def value(self) -> Optional[AbstractExpression]: return self._value
    @value.setter
    def value(self, v): self._value = self._adopt(v)

    def has_value(self) -> bool:
        return self._value is not None

    def _child_slots(self): return [self._target, self._value]
    def _child_attrs(self): return ("_target", "_value")

    def clone(self) -> "VariableDeclaration":
        return VariableDeclaration(self.datatype, self._target.clone(),
                                   self._value.clone() if self._value else None)

    def to_json(self) -> dict:
        d = {"type": "VariableDeclaration", "datatype": str(self.datatype),
             "target": self._target.to_json()}
        if self._value is not None:
            d["value"] = self._value.to_json()
        return d


class If(AbstractStatement):
    """if (cond) thenBlock [else elseBlock] (ref: If.h:64-114)."""

    __slots__ = ("_condition", "_then_branch", "_else_branch")

    def __init__(self, condition: AbstractExpression, then_branch: Block,
                 else_branch: Optional[Block] = None):
        super().__init__()
        self._condition = self._adopt(condition)
        self._then_branch = self._adopt(then_branch)
        self._else_branch = self._adopt(else_branch)

    @property
    def condition(self): return self._condition
    @condition.setter
    def condition(self, v): self._condition = self._adopt(v)
    @property
    def then_branch(self) -> Block: return self._then_branch
    @then_branch.setter
    def then_branch(self, v): self._then_branch = self._adopt(v)
    @property
    def else_branch(self) -> Optional[Block]: return self._else_branch
    @else_branch.setter
    def else_branch(self, v): self._else_branch = self._adopt(v)

    def has_else_branch(self) -> bool:
        return self._else_branch is not None

    def _child_slots(self): return [self._condition, self._then_branch, self._else_branch]
    def _child_attrs(self): return ("_condition", "_then_branch", "_else_branch")

    def clone(self) -> "If":
        return If(self._condition.clone(), self._then_branch.clone(),
                  self._else_branch.clone() if self._else_branch else None)

    def to_json(self) -> dict:
        d = {"type": "If", "condition": self._condition.to_json(),
             "thenBranch": self._then_branch.to_json()}
        if self._else_branch is not None:
            d["elseBranch"] = self._else_branch.to_json()
        return d


class For(AbstractStatement):
    """for (initBlock; condition; updateBlock) body (ref: For.h:65-133;
    initializer and update are Blocks holding multiple statements,
    Parser.cpp:597-645)."""

    __slots__ = ("_initializer", "_condition", "_update", "_body")

    def __init__(self, initializer: Block, condition: AbstractExpression,
                 update: Block, body: Block):
        super().__init__()
        self._initializer = self._adopt(initializer)
        self._condition = self._adopt(condition)
        self._update = self._adopt(update)
        self._body = self._adopt(body)

    @property
    def initializer(self) -> Block: return self._initializer
    @initializer.setter
    def initializer(self, v): self._initializer = self._adopt(v)
    @property
    def condition(self): return self._condition
    @condition.setter
    def condition(self, v): self._condition = self._adopt(v)
    @property
    def update(self) -> Block: return self._update
    @update.setter
    def update(self, v): self._update = self._adopt(v)
    @property
    def body(self) -> Block: return self._body
    @body.setter
    def body(self, v): self._body = self._adopt(v)

    def _child_slots(self): return [self._initializer, self._condition, self._update, self._body]
    def _child_attrs(self): return ("_initializer", "_condition", "_update", "_body")

    def clone(self) -> "For":
        return For(self._initializer.clone(), self._condition.clone(),
                   self._update.clone(), self._body.clone())

    def to_json(self) -> dict:
        return {"type": "For", "initializer": self._initializer.to_json(),
                "condition": self._condition.to_json(), "update": self._update.to_json(),
                "body": self._body.to_json()}


class Return(AbstractStatement):
    """return [value] (ref: Return.h:54-69)."""

    __slots__ = ("_value",)

    def __init__(self, value: Optional[AbstractExpression] = None):
        super().__init__()
        self._value = self._adopt(value)

    @property
    def value(self) -> Optional[AbstractExpression]: return self._value
    @value.setter
    def value(self, v): self._value = self._adopt(v)

    def has_value(self) -> bool:
        return self._value is not None

    def _child_slots(self): return [self._value]
    def _child_attrs(self): return ("_value",)

    def clone(self) -> "Return":
        return Return(self._value.clone() if self._value else None)

    def to_json(self) -> dict:
        d: dict = {"type": "Return"}
        if self._value is not None:
            d["value"] = self._value.to_json()
        return d


class Function(AbstractStatement):
    """public <returnType> name(params) { body } (ref: Function.h:91-101)."""

    __slots__ = ("return_type", "identifier", "parameters", "_body")

    def __init__(self, return_type: Datatype, identifier: str,
                 parameters: Sequence[FunctionParameter], body: Block):
        super().__init__()
        self.return_type = return_type
        self.identifier = identifier
        self.parameters: List[FunctionParameter] = [self._adopt(p) for p in parameters]
        self._body = self._adopt(body)

    @property
    def body(self) -> Block: return self._body
    @body.setter
    def body(self, v): self._body = self._adopt(v)

    def _child_slots(self): return list(self.parameters) + [self._body]
    def _child_attrs(self): return ("parameters", "_body")

    def clone(self) -> "Function":
        return Function(self.return_type, self.identifier,
                        [p.clone() for p in self.parameters], self._body.clone())

    def to_json(self) -> dict:
        return {"type": "Function", "returnType": str(self.return_type),
                "identifier": self.identifier,
                "parameters": [p.to_json() for p in self.parameters],
                "body": self._body.to_json()}


ALL_NODE_TYPES = [
    Literal, Variable, BinaryExpression, OperatorExpression, UnaryExpression,
    ExpressionList, IndexAccess, Call, TernaryOperator, FunctionParameter,
    Block, Assignment, VariableDeclaration, If, For, Return, Function,
]
