from abc_tpu_torch.ast_ir.nodes import (  # noqa: F401
    AbstractExpression, AbstractNode, AbstractStatement, AbstractTarget,
    Assignment, BinaryExpression, Block, Call, ExpressionList, For, Function,
    FunctionParameter, If, IndexAccess, Literal, LiteralBool, LiteralChar,
    LiteralDouble, LiteralFloat, LiteralInt, LiteralString, OperatorExpression,
    Return, TernaryOperator, UnaryExpression, Variable, VariableDeclaration,
    is_literal, reset_node_ids,
)
from abc_tpu_torch.ast_ir.compare import assert_ast_equal, compare_ast  # noqa: F401
from abc_tpu_torch.ast_ir.json_serde import dumps, from_json, loads  # noqa: F401
