"""The FHE operations of one replay, counted in one eager walk of the
captured program (JittedProgram.run_eager, the walk the capture recorded).
Keys are rooflines/fhe_ops.py's operations.

BFV: the program's own counters, and the plaintext products of the
compiled circuit counted on the program's dummy (plaintext) backend. A
product by a plaintext whose slots all hold one value is a product by a
scalar (its polynomial is that constant) and is counted apart: it needs no
transform.

CKKS: operations run at falling levels, so each is counted by its level
(`<operation>@<level>`), by wrapping the context's and the ciphertext
handle's methods for the walk: ct x ct products, products by a scalar or
by a vector plaintext, relinearizations (a decomposition and a key
switch), rotations (their key switches and the decompositions they do not
share) and rescales."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import torch


def is_scalar(cleartext) -> bool:
    """Do the plaintext's slots all hold one value? The factory pads a
    vector with its last element, so its own values decide; values are
    compared exactly (CKKS's 0.3 and 0.7 are two)."""
    return len(set(cleartext.values)) <= 1


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
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    if isinstance(jp.factory, CkksCiphertextFactory):
        return ckks_census(jp, inputs)
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


@contextmanager
def _wrapped(cls, name, wrap):
    """cls.name replaced by wrap(the original) for the block."""
    real = cls.__dict__[name]
    setattr(cls, name, wrap(real))
    try:
        yield
    finally:
        setattr(cls, name, real)


def ckks_census(jp, inputs: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{`<operation>@<level>`: count} of one walk of a CKKS program: a
    product's level is its operands' after alignment, the others' their
    operand's."""
    from abc_tpu_torch.crypto.ckks import CkksContext
    from abc_tpu_torch.runtime.ckks_backend import TorchCkksCiphertext
    seen: Dict[str, int] = {}
    plain = []          # the kind of the plaintext product being walked

    def count(op, level, times=1):
        if times:
            key = f"{op}@{level}"
            seen[key] = seen.get(key, 0) + times

    def multiply(real):
        def wrapper(self, a, b, *args, **kwargs):
            count(plain[-1] if plain else "ckks_multiply",
                  min(a.level, b.level))
            return real(self, a, b, *args, **kwargs)
        return wrapper

    def multiply_plain(real):
        def wrapper(self, other):
            plain.append("ckks_plain_scalar" if is_scalar(other)
                         else "ckks_plain_product")
            try:
                return real(self, other)
            finally:
                plain.pop()
        return wrapper

    def relinearize(real):
        def wrapper(self, ct):
            if ct.size > 2:
                count("ckks_decompose", ct.level)
                count("ckks_key_switch", ct.level)
            return real(self, ct)
        return wrapper

    def rescale(real):
        def wrapper(self, ct):
            count("ckks_rescale", ct.level)
            return real(self, ct)
        return wrapper

    def rotation(real):
        def wrapper(self, ct, *args, **kwargs):
            before = dict(self.counters)
            out = real(self, ct, *args, **kwargs)
            count("ckks_decompose", ct.level,
                  self.counters["decomp"] - before["decomp"])
            count("ckks_key_switch", ct.level,
                  self.counters["galois"] - before["galois"])
            return out
        return wrapper

    with _wrapped(CkksContext, "multiply", multiply), \
            _wrapped(TorchCkksCiphertext, "multiply_plain", multiply_plain), \
            _wrapped(CkksContext, "relinearize", relinearize), \
            _wrapped(CkksContext, "rescale", rescale), \
            _wrapped(CkksContext, "rotate", rotation), \
            _wrapped(CkksContext, "hoisted_rotations", rotation):
        jp.run_eager(inputs)
        if jp.device.type == "cuda":
            torch.cuda.synchronize(jp.device)
    return dict(sorted(seen.items()))
