"""The reference's end-to-end workloads through the port (the port of
tests/test_e2e_workloads.py).

Cleartext tier: every workload test of tests/test_e2e_workloads.py runs
again with its `run` and `assert_result` swapped for the port's parser,
type checker, executor and dummy factory, so the programs, inputs and
plain-language oracles are the reference test's own.

Encrypted tier: the twelve families in their secret-input form
(tests/test_auto_params.py WORKLOADS) compiled by each package's pipeline
and run on its BFV factory at n=1024 with the same seed: output words and op
counters identical (no tolerance), decryption equal to the dummy backend's.
"""

import numpy as np
import pytest

import abc_tpu
import abc_tpu_torch
import test_e2e_workloads as reference_tests
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from test_auto_params import WORKLOADS
from test_torch_slice import _ref_counters, _run_program_port, _words

CLEARTEXT_TESTS = sorted(name for name in vars(reference_tests)
                         if name.startswith("test_"))


def _run_on_port(inputs, program, outputs):
    factory = DummyCiphertextFactory()
    _, pairs = _run_program_port(inputs, program, outputs, factory)
    return factory, pairs


def _assert_result_port(factory, output_pairs, expected):
    """helpers.assert_result for the port's value classes."""
    assert [k for k, _ in output_pairs] == list(expected)
    for identifier, value in output_pairs:
        exp = list(expected[identifier])
        if isinstance(value, AbstractCiphertext):
            got = factory.decrypt(value)[:len(exp)]
        else:
            assert isinstance(value, Cleartext)
            got = [int(v) for v in value.values]
        assert got == exp, f"{identifier}: {got} != {exp}"


def test_the_reference_file_still_has_its_twelve_workloads():
    assert len(CLEARTEXT_TESTS) == 12


@pytest.mark.parametrize("name", CLEARTEXT_TESTS)
def test_cleartext_workload_through_the_port(name, monkeypatch):
    calls = []

    def run(inputs, program, outputs):
        calls.append(program)
        return _run_on_port(inputs, program, outputs)

    monkeypatch.setattr(reference_tests, "run", run)
    monkeypatch.setattr(reference_tests, "assert_result", _assert_result_port)
    getattr(reference_tests, name)()
    assert len(calls) == 1          # the workload did go through the port


def _run_encrypted(pkg, factory, inputs_src, program_src, output_src):
    ia, oa = pkg.Parser.parse(inputs_src), pkg.Parser.parse(output_src)
    compiled = pkg.compile_program(program_src, pkg.input_types_from_ast(ia),
                                   pkg.CompileOptions(vectorize=True))
    _, pairs = pkg.run_compiled(compiled, ia, oa, factory)
    return pairs


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_encrypted_workload_equals_reference_words(name):
    src = WORKLOADS[name]
    port = BfvCiphertextFactory(slots=1024, seed=31, device="cpu")
    ref = RefFactory(slots=1024, seed=31, engine="np64")
    pairs = _run_encrypted(abc_tpu_torch, port, *src)
    ref_pairs = _run_encrypted(abc_tpu, ref, *src)
    dummy_factory = DummyCiphertextFactory(slots=64)
    plain = _run_encrypted(abc_tpu_torch, dummy_factory, *src)
    (ident, value), (_, ref_value), (_, dummy) = pairs[0], ref_pairs[0], \
        plain[0]
    np.testing.assert_array_equal(_words(value), _words(ref_value))
    assert _ref_counters(port.context.counters) == ref.context.counters
    want = dummy_factory.decrypt(dummy)[:16]
    assert port.decrypt(value)[:16] == ref.decrypt(ref_value)[:16] == want
