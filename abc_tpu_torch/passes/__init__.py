from abc_tpu_torch.passes.visitor import PlainVisitor, ScopedVisitor  # noqa: F401
from abc_tpu_torch.passes.printer import PrintVisitor, expr_to_string, program_to_string  # noqa: F401
