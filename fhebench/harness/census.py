"""The FHE operations of one replay, counted by the program's own counters
in one eager walk of the captured program (JittedProgram.run_eager, the
walk the capture recorded), and the plaintext products of the compiled
circuit, counted on the program's dummy (plaintext) backend, which the BFV
context does not count. A product by a plaintext whose slots all hold one
value is a product by a scalar (its polynomial is that constant) and is
counted apart: it needs no transform. Keys are rooflines/fhe_ops.py's
operations."""

from __future__ import annotations

from typing import Dict

import torch


def is_scalar(cleartext) -> bool:
    """Do the plaintext's slots all hold one value? The factory pads a
    vector with its last element, so its own values decide."""
    return len({int(v) for v in cleartext.values}) <= 1


def plain_products(jp) -> Dict[str, int]:
    """Ciphertext-plaintext products of the compiled circuit, by a scalar
    (`plain_scalar`) and by a vector (`plain_product`): its walk on the
    dummy backend at the input AST's values."""
    from abc_tpu_torch.runtime.dummy import (DummyCiphertext,
                                             DummyCiphertextFactory)
    from abc_tpu_torch.runtime.executor import RuntimeVisitor
    seen = {"plain_product": 0, "plain_scalar": 0}

    class Counting(DummyCiphertext):
        def multiply_plain(self, other):
            kind = "plain_scalar" if is_scalar(other) else "plain_product"
            seen[kind] += 1
            return super().multiply_plain(other)

    class Factory(DummyCiphertextFactory):
        handle_cls = Counting

    rv = RuntimeVisitor(Factory(slots=min(jp.factory.slot_count, 2048)),
                        jp.input_ast, jp.compiled.secret_tainted)
    rv.execute_ast(jp.compiled.ast)
    rv.get_output(jp.output_ast)
    return seen


def op_census(jp, inputs: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{FHE operation: count} of one walk of jp on `inputs`. A
    relinearization decomposes its operand itself; the `decomp` counter
    counts the rotations' decompositions (rotations of one ciphertext share
    one)."""
    counters = jp.factory.context.counters
    before = dict(counters)
    jp.run_eager(inputs)
    if jp.device.type == "cuda":
        torch.cuda.synchronize(jp.device)
    moved = {k: counters[k] - before.get(k, 0) for k in counters}
    return {"operand": moved["op_ntt"], "multiply": moved["mult"],
            "decompose": moved["decomp"] + moved["relin"],
            "key_switch": moved["relin"] + moved["galois"],
            **plain_products(jp)}
