"""The reference-scale workloads of tests/test_e2e_reference_scale.py
through the port: chip_smoke.py phase 12's table (REFERENCE_SCALE) and its
runner.

On the CPU: every reference test that runs its program through `_jit_run`
runs as written with `_jit_run` swapped for a recorder that compiles the
program with the port and runs it on the port's dummy backend at the
test's slot count, so the reference test's own oracle holds the port's
compiled circuit; the recorded program, inputs, outputs, ring size and
options are phase 12's entry of the same name, whose oracle the dummy
outputs also meet. Cardio (the reference runs it through run_compiled) is
held to its entry the same way.

On a CUDA device (`gpu`-marked, skipped without one): each workload at the
reference's own parameters and seeds as one CUDA graph, decrypted to the
oracle, the replay's words equal to an eager walk on the same ciphertexts,
no counter moving across replays.
"""

import pytest
import torch

import chip_smoke
from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                           input_types_from_ast, run_compiled)
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext

# reference test -> the phase-12 entries its _jit_run calls are, in order
JIT_TESTS = {
    "test_hamming_encrypted_jit_n8192": ["hamming16_n8192"],
    "test_boxblur_encrypted_jit_n8192": ["boxblur_n8192"],
    "test_matvec_bsgs_encrypted_jit_n8192": ["matvec_bsgs_n8192"],
    "test_roberts_cross_encrypted_jit_n8192": ["roberts_cross_n8192"],
    "test_linear_and_polynomial_kernel_encrypted_jit_n8192": [
        "linear_kernel_n8192", "polynomial_kernel_n8192"],
    "test_gx_kernel_encrypted_jit_n8192": ["gx_n8192"],
    "test_gy_kernel_encrypted_jit_n8192": ["gy_n8192"],
    "test_l2_distance_encrypted_jit_n8192": ["l2_distance_n8192"],
    "test_dot_product_encrypted_jit_n8192": ["dot_product_n8192"],
    "test_smoke_encrypted_jit_n4096": ["smoke_n4096"],
}


def reference():
    """tests/test_e2e_reference_scale.py, imported when a CPU test runs: it
    imports `tests.test_secret_index`, which does not resolve where another
    top-level `tests` package is installed (as on the GPU host, where the
    `gpu`-marked run collects this file)."""
    import test_e2e_reference_scale
    return test_e2e_reference_scale


def _dummy_run(n, inputs_src, program_src, output_src, vectorize):
    """{output: decrypted slots} of the program compiled by the port and run
    on the port's dummy backend with n slots."""
    ia = Parser.parse(inputs_src)
    compiled = compile_program(program_src, input_types_from_ast(ia),
                               CompileOptions(vectorize=vectorize))
    factory = DummyCiphertextFactory(n)
    _, pairs = run_compiled(compiled, ia, Parser.parse(output_src), factory)
    return {name: factory.decrypt(v) if isinstance(v, AbstractCiphertext)
            else list(v.values) for name, v in pairs}


def _same_entry(call, name):
    entry = chip_smoke.REFERENCE_SCALE[name]()
    assert call["n"] == entry["n"]
    assert call["inputs"] == entry["inputs"]
    assert "".join(call["program"].split()) == \
        "".join(entry["program"].split())
    assert call["output"] == entry["output"]
    assert call["vectorize"] == entry["vectorize"]
    assert entry.get("seed", chip_smoke.REFERENCE_SEED) == 31
    for out, want in entry["want"].items():
        assert call["result"][out][:len(want)] == want


def test_the_table_holds_every_workload():
    named = {name for names in JIT_TESTS.values() for name in names}
    assert set(chip_smoke.REFERENCE_SCALE) == named | {"cardio_n16384"}
    assert set(JIT_TESTS) | {
        "test_laplace_sharpening_encrypted_bfv_n16384",
        "test_cardio_batched_encrypted_bfv_n16384"} == {
        name for name in vars(reference()) if name.startswith("test_")}


@pytest.mark.parametrize("test", sorted(JIT_TESTS))
def test_reference_program_is_phase_12_s(test, monkeypatch):
    calls = []

    def recorder(inputs_src, program_src, out_src, slots=8192, options=None):
        vectorize = bool(options is not None and options.vectorize)
        result = _dummy_run(slots, inputs_src, program_src, out_src,
                            vectorize)
        calls.append(dict(n=slots, inputs=inputs_src, program=program_src,
                          output=out_src, vectorize=vectorize, result=result))
        return None, result

    monkeypatch.setattr(reference(), "_jit_run", recorder)
    getattr(reference(), test)()
    assert len(calls) == len(JIT_TESTS[test])
    for call, name in zip(calls, JIT_TESTS[test]):
        _same_entry(call, name)


def test_cardio_entry_meets_its_oracle_on_the_dummy_backend():
    w = chip_smoke.REFERENCE_SCALE["cardio_n16384"]()
    assert (w["n"], w["seed"]) == (16384, 23)      # the reference's _bfv16384
    got = _dummy_run(w["n"], w["inputs"], w["program"], w["output"],
                     w["vectorize"])
    assert got["out"][:1] == w["want"]["out"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(chip_smoke.REFERENCE_SCALE))
def test_workload_as_a_graph_on_the_card(name, cuda):
    ms, _, _, counters, _ = chip_smoke.reference_scale_run(name, cuda)
    assert ms > 0
    if name.startswith("cardio"):
        assert counters["galois"] >= 4 and counters["mult"] == 0
