"""The ciphertext-factory op matrix of tests/test_factory_matrix.py on the
port's factories (BFV at n=1024 on the CPU, and the dummy backend): each
reference test runs as written, with the reference's value classes swapped
for the port's. Then every op of the matrix once more on the port's BFV
factory and abc_tpu's np64 factory of the same seed: the words are identical
(no tolerance).
"""

import numpy as np
import pytest

import test_factory_matrix as reference
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu.runtime.values import Cleartext as RefCleartext
from abc_tpu.utils.datatype import Type as RefType
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.values import Cleartext
from abc_tpu_torch.utils.datatype import Type
from test_torch_slice import _ref_counters, _words

REFERENCE_TESTS = sorted(name for name in vars(reference)
                         if name.startswith("test_"))


def test_the_reference_file_still_has_its_five_tests():
    assert len(REFERENCE_TESTS) == 5


@pytest.fixture(params=["bfv", "dummy"])
def port_factory(request, monkeypatch):
    monkeypatch.setattr(reference, "Cleartext", Cleartext)
    monkeypatch.setattr(reference, "Type", Type)
    if request.param == "bfv":
        return BfvCiphertextFactory(slots=1024, seed=7, device="cpu")
    return DummyCiphertextFactory(1024)


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_case_on_the_port(name, port_factory):
    getattr(reference, name)(port_factory)


# op name: the call on handles a, b and the plain operand p (DATA2)
OPS = {
    "add": lambda a, b, p: a.add(b),
    "subtract": lambda a, b, p: a.subtract(b),
    "multiply": lambda a, b, p: a.multiply(b),
    "add_plain": lambda a, b, p: a.add_plain(p),
    "subtract_plain": lambda a, b, p: a.subtract_plain(p),
    "multiply_plain": lambda a, b, p: a.multiply_plain(p),
    "rotate_lhs": lambda a, b, p: a.rotate_rows(4),
    "rotate_rhs": lambda a, b, p: a.rotate_rows(-24),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_words_equal_reference(op):
    port = BfvCiphertextFactory(slots=1024, seed=7, device="cpu")
    ref = RefFactory(slots=1024, engine="np64", seed=7)
    got = []
    for factory, clear, ty in ((port, Cleartext, Type),
                               (ref, RefCleartext, RefType)):
        a = factory.create_ciphertext(clear(list(reference.DATA1), ty.INT))
        b = factory.create_ciphertext(clear(list(reference.DATA2), ty.INT))
        out = OPS[op](a, b, clear(list(reference.DATA2), ty.INT))
        got.append((_words(a), _words(out), factory.decrypt(out)))
    (pa, po, pd), (ra, ro, rd) = got
    np.testing.assert_array_equal(pa, ra)
    np.testing.assert_array_equal(po, ro)
    assert pd == rd
    assert _ref_counters(port.context.counters) == ref.context.counters
