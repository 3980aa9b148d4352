"""tests/test_auto_params_fuzz.py through the port, on the CPU: random
circuits of varying multiplicative depth, the parameter set chosen from the
noise model, the program run encrypted on it. The chosen set and report
equal abc_tpu's for every seed, the decryption equals the dummy backend's
oracle (CKKS: numpy within the reference's 5e-2), the measured noise budget
stays within 8 bits of the prediction, and on the first WORD_SEEDS seeds the
output words equal abc_tpu's np64 run of the same parameters and seed.
"""

import random
import warnings

import numpy as np
import pytest
import torch

import abc_tpu
from abc_tpu.crypto.bfv import BfvContext as RefBfv
from abc_tpu.crypto.noise import auto_params_report as ref_auto_params
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu_torch import (Compiler, Parser, input_types_from_ast,
                           jit_compile_program)
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.noise import auto_params_report
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.runtime.values import AbstractCiphertext
from test_torch_fuzz_extended import (ALL_ON, assert_same_words, port_words,
                                     reference, reference_words)

WORD_SEEDS = 3


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch thread per test. The suite runs in several worker
    processes at once, and with torch's default of a thread per core each,
    the n=16384 circuits here (depth 3 and 4) ran 60 times slower than
    alone: 130-170 s a case instead of 2-10 s single-threaded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def gen_depth_program(rng, max_mults):
    from tests.test_auto_params_fuzz import gen_depth_program as gen
    return gen(rng, max_mults)


def gen_ckks_program(rng, slots):
    return reference()[0].gen_ckks_program(rng, slots)


def run_with(*args):
    return reference()[1].run_with(*args)


def ref_all_on():
    return reference()[1].ALL_ON


def _compile_both(inputs_src, program_src):
    port = Compiler(ALL_ON).compile_source(
        program_src, input_types_from_ast(Parser.parse(inputs_src)))
    ref = abc_tpu.Compiler(ref_all_on()).compile_source(
        program_src,
        abc_tpu.input_types_from_ast(abc_tpu.Parser.parse(inputs_src)))
    return port, ref


def _chosen(inputs_src, program_src):
    """(port compiled program, port params, port report): the report and
    the parameter set equal abc_tpu's for the same circuit."""
    port, ref = _compile_both(inputs_src, program_src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # dev sizes warn on security
        params, report = auto_params_report(port, seed=7)
        ref_params, ref_report = ref_auto_params(ref, engine="np64", seed=7)
    assert report == ref_report
    assert (params.n, params.coeff_modulus, params.plain_modulus) == \
        (ref_params.n, ref_params.coeff_modulus, ref_params.plain_modulus)
    return port, params, ref_params, report


def _run_auto(inputs_src, program_src, output_src, words=False):
    """tests/test_auto_params_fuzz.py::_run_auto on the port: (report,
    decrypted first 8 slots per output, the output handle)."""
    compiled, params, ref_params, report = _chosen(inputs_src, program_src)
    factory = BfvCiphertextFactory(context=BfvContext(params, "cpu"))
    input_ast = Parser.parse(inputs_src)
    rv = RuntimeVisitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    pairs = rv.get_output(Parser.parse(output_src))
    if words:
        ref = reference_words(inputs_src, program_src, output_src,
                              RefFactory(context=RefBfv(ref_params)))
        for name, value in pairs:
            np.testing.assert_array_equal(to_host(value.ct.data), ref[name])
    out = [(name, factory.decrypt(v)[:8]) for name, v in pairs]
    return report, out, pairs


@pytest.mark.parametrize("seed", range(24))
def test_auto_params_bfv_fuzz(seed):
    rng = random.Random(20_000 + seed)
    inputs_src, program_src, output_src = gen_depth_program(
        rng, max_mults=2 + seed % 2)
    dummy = [(n, v[:8]) for n, v in
             run_with(inputs_src, program_src, output_src, ref_all_on())]
    report, got, _ = _run_auto(inputs_src, program_src, output_src,
                               words=seed < WORD_SEEDS)
    assert report["predicted_margin_bits"] > 0
    assert got == dummy, (
        f"seed {seed}: auto-chosen n={report['n']} failed to decrypt\n"
        f"inputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got}\nwant={dummy}")


def test_auto_params_scales_chain_with_fuzzed_depth():
    """Deeper circuits never get a smaller ring (depth 4 escalates past
    n=1024, to the n=16384 preset)."""
    inputs = "secret int v0 = {1,2,3,4,5,6,7,8};"
    prev_n = 0
    for depth in range(0, 5):
        prog = "secret int acc = v0;" + "acc = acc * v0;" * depth \
            + "return acc;"
        report, got, _ = _run_auto(inputs, prog, "out = acc;")
        assert report["n"] >= prev_n
        prev_n = report["n"]
        oracle = (np.arange(1, 9, dtype=object) ** (depth + 1)).tolist()
        assert got[0][1] == oracle, f"depth {depth} on n={report['n']}"
    assert prev_n > 1024


@pytest.mark.parametrize("seed", range(12))
def test_noise_model_stays_conservative(seed):
    rng = random.Random(20_000 + seed)
    inputs_src, program_src, output_src = gen_depth_program(
        rng, max_mults=2 + seed % 2)
    report, _, pairs = _run_auto(inputs_src, program_src, output_src)
    ((_, v),) = pairs
    assert isinstance(v, AbstractCiphertext)
    measured = v.noise_bits()
    assert measured > 0
    assert measured >= report["predicted_margin_bits"] - 8, (
        f"seed {seed}: predicted margin {report['predicted_margin_bits']} "
        f"bits, measured budget {measured} on n={report['n']}\n"
        f"program: {program_src}")


def _auto_jit(program_src, inputs_src, output_src):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jit_compile_program(program_src, inputs_src, output_src,
                                   options=ALL_ON, auto_params=True,
                                   device="cpu", seed=7)


@pytest.mark.parametrize("seed", range(6))
def test_auto_params_jit_fuzz(seed):
    rng = random.Random(21_000 + seed)
    inputs_src, program_src, output_src = gen_depth_program(rng, max_mults=2)
    dummy = [(n, v[:8]) for n, v in
             run_with(inputs_src, program_src, output_src, ref_all_on())]
    jp = _auto_jit(program_src, inputs_src, output_src)
    assert jp.auto_params["predicted_margin_bits"] > 0
    raw = jp.run_raw(jp.secret_inputs)
    got = {k: list(v)[:8] for k, v in jp.decrypt_outputs(raw).items()}
    assert got == dict(dummy), (
        f"seed {seed}: n={jp.auto_params['n']} diverged\n"
        f"program: {program_src}\ngot={got}\nwant={dict(dummy)}")
    if seed < WORD_SEEDS:
        _, ref = _compile_both(inputs_src, program_src)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref_params, _ = ref_auto_params(ref, engine="np64", seed=7)
        assert_same_words(port_words(raw), reference_words(
            inputs_src, program_src, output_src,
            RefFactory(context=RefBfv(ref_params))))


@pytest.mark.parametrize("seed", range(6))
def test_auto_params_ckks_fuzz(seed):
    """Float circuits route to CKKS with per-circuit levels and
    scale_bits, equal to abc_tpu's choice."""
    from abc_tpu.crypto.noise import choose_ckks_parameters as ref_choose
    seed_val = 22_000 + seed
    inputs_src, program_src, _ = gen_ckks_program(random.Random(seed_val),
                                                  slots=8)
    jp = _auto_jit(program_src, inputs_src, "out = acc;")
    assert jp.auto_params["scheme"] == "ckks"
    _, ref = _compile_both(inputs_src, program_src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, ref_report = ref_choose(ref, engine="np64", seed=7)
    assert jp.auto_params == ref_report
    slots = jp.factory.slot_count
    inputs2, program2, oracle = gen_ckks_program(random.Random(seed_val),
                                                 slots=slots)
    assert (inputs2, program2) == (inputs_src, program_src)
    got = np.asarray(jp.run()["out"])
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}: CKKS auto-params n={jp.auto_params['n']} "
        f"levels={jp.auto_params['levels']} diverged\n"
        f"program: {program_src}\ngot={got[:8]}\nwant={oracle[:8]}")
