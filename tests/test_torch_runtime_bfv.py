"""Program-level runtime tests on the port's BFV backend (the port of
tests/test_runtime_bfv.py): each program runs through the port's executor
and factory on the CPU at n=1024 and through abc_tpu's with its np64 factory
of the same seed; decrypted vectors are the reference test's, and the output
words and op counters are identical (no tolerance).
"""

import numpy as np
import pytest

from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext
from helpers import run_program
from test_torch_slice import _ref_counters, _run_program_port, _words

INPUT_XY = """
  secret int __input0__ = {43, 1, 1, 1, 22, 11, 425, 0, 1, 7};
  int __input1__ = {43, 1, 1, 1, 22, 11, 425, 0, 1, 0};
"""
PROD = [1849, 1, 1, 1, 484, 121, 180625, 0, 1, 0]
# name: (inputs, program, outputs, {output: leading decrypted slots})
PROGRAMS = {
    # the exact expected vector from RuntimeVisitorTest.cpp:100-103
    "rotate_negative": (
        INPUT_XY, "__input0__ = rotate(__input0__, -4);", "y = __input0__;",
        {"y": [7, 7, 7, 7, 43, 1, 1, 1, 22, 11, 425, 0, 1, 7]}),
    "ctxt_ctxt_multiplication": (
        INPUT_XY, "secret int prod = __input0__ *** __input0__;", "y = prod;",
        {"y": [43 * 43, 1, 1, 1, 484, 121, 180625, 0, 1, 49]}),
    "ctxt_plain_both_orders": (
        INPUT_XY,
        "secret int a = __input0__ *** __input1__;"
        "secret int b = __input1__ *** __input0__;"
        "secret int d = __input1__ --- __input0__;",
        "ya = a; yb = b; yd = d;",
        {"ya": PROD, "yb": PROD, "yd": [0, 0, 0, 0, 0, 0, 0, 0, 0, -7]}),
    "hamming_distance_batched": (
        "secret int x = {1, 1, 0, 1}; secret int y = {1, 0, 1, 1};",
        """
          secret int diff = (x --- y) *** (x --- y);
          diff = diff +++ rotate(diff, 2);
          diff = diff +++ rotate(diff, 1);
          return diff;
        """, "hd = diff;", {"hd": [2]}),
    "for_loop_with_ciphertext_accumulator": (
        "secret int acc = {1, 2, 3};",
        """
          for (int i = 0; i < 3; i = i + 1) {
            acc = acc +++ acc;
          }
          return acc;
        """, "y = acc;", {"y": [8, 16, 24]}),
    "plain_add_sub_and_negative_rotation": (
        "secret int x = {5, 6, 7, 8}; int w = {1, 2, 3, 4};",
        "secret int s = x +++ w; s = s --- 2; s = 20 --- s;"
        "s = rotate(s, -1);",
        "out = s;", {"out": [10, 16, 14, 12, 10]}),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_equals_reference_vector_and_words(name):
    inputs, program, outputs, expected = PROGRAMS[name]
    port = BfvCiphertextFactory(slots=1024, seed=42, device="cpu")
    ref = RefFactory(slots=1024, seed=42, engine="np64")
    _, pairs = _run_program_port(inputs, program, outputs, port)
    _, ref_pairs = run_program(inputs, program, outputs, ref)
    assert [k for k, _ in pairs] == [k for k, _ in ref_pairs] == \
        list(expected)
    for (ident, value), (_, ref_value) in zip(pairs, ref_pairs):
        assert isinstance(value, AbstractCiphertext)
        want = expected[ident]
        assert port.decrypt(value)[:len(want)] == want
        np.testing.assert_array_equal(_words(value), _words(ref_value))
    assert _ref_counters(port.context.counters) == ref.context.counters


def test_noise_bits_observable_and_equal_to_the_reference():
    port = BfvCiphertextFactory(slots=1024, seed=42, device="cpu")
    ref = RefFactory(slots=1024, seed=42, engine="np64")
    _, pairs = _run_program_port("secret int x = {5};", "x = x *** x;",
                                 "y = x;", port)
    _, ref_pairs = run_program("secret int x = {5};", "x = x *** x;",
                               "y = x;", ref)
    assert pairs[0][1].noise_bits() == ref_pairs[0][1].noise_bits() > 0
