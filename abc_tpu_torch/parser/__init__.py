from abc_tpu_torch.parser.parser import Parser, parse, parse_with_nodes  # noqa: F401
from abc_tpu_torch.parser.tokenizer import TokenStream, tokenize  # noqa: F401
