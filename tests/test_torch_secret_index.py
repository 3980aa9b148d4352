"""Secret IndexAccess (reads on ciphertexts, masked slot writes) of
tests/test_secret_index.py on the port: each reference test runs as written,
with its harness, factories and value classes swapped for the port's (BFV at
n=1024 and the dummy backend, on the CPU). Every program also runs through
abc_tpu beside it on a factory of the same seed (np64 for BFV), and the
output words, op counters and decrypted values are identical
(test_torch_runtime_matrix.twin_run_program).
"""

import pytest

import test_secret_index as reference
from test_torch_runtime_matrix import (swap_in_the_port, twin_bfv,
                                       twin_dummy)

REFERENCE_TESTS = sorted(name for name in vars(reference)
                         if name.startswith("test_"))


def test_the_reference_file_still_has_its_eleven_tests():
    assert len(REFERENCE_TESTS) == 11


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_case_on_the_port(name, monkeypatch):
    swap_in_the_port(monkeypatch, reference)
    monkeypatch.setattr(reference, "DummyCiphertextFactory", twin_dummy)
    monkeypatch.setattr(reference, "_bfv_factory",
                        lambda slots=1024, seed=11: twin_bfv(slots, seed))
    getattr(reference, name)()
