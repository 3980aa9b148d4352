from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory  # noqa: F401
from abc_tpu_torch.runtime.dummy import DummyCiphertext, DummyCiphertextFactory  # noqa: F401
from abc_tpu_torch.runtime.executor import (  # noqa: F401
    OutputIdentifierValuePairs, ReturnStatementReached, RuntimeVisitor,
)
from abc_tpu_torch.runtime.values import AbstractCiphertext, AbstractValue, Cleartext  # noqa: F401
