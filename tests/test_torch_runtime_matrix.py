"""The RuntimeVisitor op and error matrix of tests/test_runtime_matrix.py on
the port (BFV at n=1024 on the CPU): each reference test runs as written,
with `run_program`, `assert_result` and the value and error classes swapped
for the port's. Every program also runs through abc_tpu with its np64
factory of the same seed beside it (`twin_run_program`): the output words
and op counters are identical (no tolerance), cleartext outputs equal, and a
program the port refuses the reference refuses too.
"""

import numpy as np
import pytest

import helpers
import test_runtime_matrix as reference
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu.runtime.dummy import DummyCiphertextFactory as RefDummy
from abc_tpu.utils.errors import RuntimeExecutionError as RefError
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.datatype import Type
from abc_tpu_torch.utils.errors import RuntimeExecutionError
from test_torch_slice import _ref_counters, _run_program_port, _words

REFERENCE_TESTS = sorted(name for name in vars(reference)
                         if name.startswith("test_"))


def twin_bfv(slots=1024, seed=1):
    """The port's BFV factory on the CPU, with abc_tpu's np64 factory of the
    same seed as its `twin`."""
    factory = BfvCiphertextFactory(slots=slots, seed=seed, device="cpu")
    factory.twin = RefFactory(slots=slots, engine="np64", seed=seed)
    return factory


def twin_dummy(slots=8192):
    factory = DummyCiphertextFactory(slots)
    factory.twin = RefDummy(slots)
    return factory


def twin_run_program(inputs_src, program_src, output_src, factory=None):
    """helpers.run_program through the port, and through abc_tpu on the
    factory's twin: the two must agree word for word."""
    if factory is None:
        factory = twin_dummy()
    try:
        rv, pairs = _run_program_port(inputs_src, program_src, output_src,
                                      factory)
    except RuntimeExecutionError:
        with pytest.raises(RefError):
            helpers.run_program(inputs_src, program_src, output_src,
                                factory.twin)
        raise
    _, ref_pairs = helpers.run_program(inputs_src, program_src, output_src,
                                       factory.twin)
    assert [k for k, _ in pairs] == [k for k, _ in ref_pairs]
    for (name, value), (_, ref_value) in zip(pairs, ref_pairs):
        if isinstance(value, AbstractCiphertext):
            if isinstance(factory, BfvCiphertextFactory):
                np.testing.assert_array_equal(_words(value),
                                              _words(ref_value), name)
            assert factory.decrypt(value) == factory.twin.decrypt(ref_value)
        else:
            assert list(value.values) == list(ref_value.values), name
    if isinstance(factory, BfvCiphertextFactory):
        assert _ref_counters(factory.context.counters) == \
            factory.twin.context.counters
    return rv, pairs


def port_assert_result(factory, output_pairs, expected):
    """helpers.assert_result for the port's value classes."""
    assert len(output_pairs) == len(expected)
    for identifier, value in output_pairs:
        assert identifier in expected, f"unexpected output {identifier!r}"
        exp = expected[identifier]
        if isinstance(value, AbstractCiphertext):
            plain = factory.decrypt(value)
            assert plain[:len(exp)] == list(exp), \
                f"{identifier}: {plain[:len(exp)]} != {exp}"
        else:
            assert isinstance(value, Cleartext)
            assert [int(v) for v in value.values] == list(exp)


def swap_in_the_port(monkeypatch, module):
    """The reference test module's names for the harness, values and errors
    bound to the port's."""
    for name, port in (("run_program", twin_run_program),
                       ("assert_result", port_assert_result),
                       ("Cleartext", Cleartext), ("Type", Type),
                       ("RuntimeExecutionError", RuntimeExecutionError)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, port)


def test_the_reference_file_still_has_its_seventeen_tests():
    assert len(REFERENCE_TESTS) == 17


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_case_on_the_port(name, monkeypatch):
    swap_in_the_port(monkeypatch, reference)
    test = getattr(reference, name)
    if "factory" in test.__code__.co_varnames[:test.__code__.co_argcount]:
        test(twin_bfv(seed=1))
    else:
        test()
