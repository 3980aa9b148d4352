from abc_tpu_torch.utils.datatype import Datatype, Type  # noqa: F401
from abc_tpu_torch.utils.operators import Op, Operator  # noqa: F401
from abc_tpu_torch.utils.errors import (  # noqa: F401
    AbcError, CompilerError, ParsingError, RuntimeExecutionError, SemanticError,
)
