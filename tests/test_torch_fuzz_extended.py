"""The whole-program and CKKS fuzz families of tests/test_fuzz_extended.py
through the port, on the CPU: the same seeded program generators, held
against the same oracles (the dummy tree-walker for the BFV families, numpy
float64 for the CKKS ones, at the reference's tolerance), and on the first
WORD_SEEDS seeds of every family against abc_tpu's words: the reference's
compile pipeline and eager executor on its np64 factory of the same seed
give the port's output words exactly (no tolerance).
"""

import random

import numpy as np
import pytest

import abc_tpu
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu.runtime.ckks_backend import (
    CkksCiphertextFactory as RefCkksFactory)
from abc_tpu_torch import (CompileOptions, Compiler, Parser,
                           input_types_from_ast, jit_compile_program)
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.runtime.values import AbstractCiphertext

ALL_ON = CompileOptions(ctes=True, loop_unrolling=True, vectorize=True,
                        cone_rewriting=True, dead_store_elimination=True)
WORD_SEEDS = 3
CKKS = dict(n=512, levels=4, seed=3, scale_bits=30)
CKKS_TIGHT = dict(n=512, levels=3, seed=3, scale_bits=28)


def reference():
    """The reference's fuzz modules, imported when a test runs: they import
    each other as `tests.<module>`, which does not resolve where another
    top-level `tests` package is installed (as on the GPU host, where the
    `gpu`-marked run collects every port test file)."""
    from tests import test_fuzz_extended, test_pipeline_fuzz
    return test_fuzz_extended, test_pipeline_fuzz


def reference_words(inputs_src, program_src, output_src, factory):
    """{output: words} of the program through abc_tpu's compile pipeline and
    eager executor on `factory` (cleartext outputs as their values)."""
    ast_in = abc_tpu.Parser.parse(inputs_src)
    compiled = abc_tpu.Compiler(reference()[1].ALL_ON).compile_source(
        program_src, abc_tpu.input_types_from_ast(ast_in))
    _, pairs = abc_tpu.run_compiled(compiled, ast_in,
                                    abc_tpu.Parser.parse(output_src), factory)
    return {name: np.asarray(v.ct.data) if hasattr(v, "ct") else
            list(v.values) for name, v in pairs}


def port_words(raw):
    return {name: to_host(v) if not isinstance(v, list) else v
            for name, v in raw.items()}


def assert_same_words(got, want):
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), name)


# --------------------------------------------------- whole-program (BFV)

def _jit_against_dummy(seed, inputs_src, program_src, output_src,
                       compare_spec):
    """tests/test_fuzz_extended.py::_assert_jit_matches_dummy with the
    port's jit_compile_program on the CPU; on the first seeds also the
    words of abc_tpu's np64 run."""
    pf = reference()[1]
    base = pf.run_with(inputs_src, program_src, output_src, pf.ALL_ON)
    jp = jit_compile_program(
        program_src, inputs_src, output_src, options=ALL_ON,
        factory=BfvCiphertextFactory(slots=1024, seed=11, device="cpu"))
    raw = jp.run_raw(jp.secret_inputs)
    jit_out = jp.decrypt_outputs(raw)
    if compare_spec is None:
        compare_spec = [(name, 8) for name, _ in base]
    for (bn, bv), (_, ncmp) in zip(base, compare_spec):
        jv = [int(v) for v in jit_out[bn]]
        assert bv[:ncmp] == jv[:ncmp], (
            f"seed {seed}: the port's program diverged from the tree-walker "
            f"on {bn}\ninputs: {inputs_src}\nprogram: {program_src}\n"
            f"walker={bv[:ncmp]} port={jv[:ncmp]}")
    if seed < WORD_SEEDS:
        assert_same_words(port_words(raw), reference_words(
            inputs_src, program_src, output_src,
            RefFactory(slots=1024, engine="np64", seed=11)))


@pytest.mark.parametrize("seed", range(25))
def test_jit_fuzz_read_programs(seed):
    pf = reference()[1]
    rng = random.Random(8000 + seed)
    while True:
        inputs_src, program_src, output_src, scalar_mixed = \
            pf.gen_program(rng)
        if program_src.count("acc * ") + program_src.count("* v") <= 2:
            break
    n_cmp = 1 if scalar_mixed else 8
    base = pf.run_with(inputs_src, program_src, output_src, pf.ALL_ON)
    spec = [(name, n_cmp) for name, _ in base]
    _jit_against_dummy(seed, inputs_src, program_src, output_src, spec)


@pytest.mark.parametrize("seed", range(25))
def test_jit_fuzz_write_programs(seed):
    rng = random.Random(9000 + seed)
    while True:
        inputs_src, program_src, output_src, outs = \
            reference()[0].gen_vector_program(rng)
        if program_src.count("*") <= 2:
            break
    _jit_against_dummy(seed, inputs_src, program_src, output_src, outs)


# ------------------------------------------------------------------ CKKS

def _ckks_eager(seed, base_seed, params):
    """One gen_ckks_program through the port's executor and CKKS factory:
    decrypted slots against numpy; words against abc_tpu's np64 factory on
    the first seeds."""
    factory = CkksCiphertextFactory(device="cpu", **params)
    rng = random.Random(base_seed + seed)
    inputs_src, program_src, oracle = reference()[0].gen_ckks_program(
        rng, factory.slot_count)
    input_ast = Parser.parse(inputs_src)
    compiled = Compiler(ALL_ON).compile_source(
        program_src, input_types_from_ast(input_ast))
    rv = RuntimeVisitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    ((_, value),) = rv.get_output(Parser.parse("out = acc;"))
    assert isinstance(value, AbstractCiphertext)
    got = np.asarray(factory.decrypt(value))
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}\ninputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got[:8]}\nwant={oracle[:8]}")
    if seed < WORD_SEEDS:
        ref = reference_words(inputs_src, program_src, "out = acc;",
                              RefCkksFactory(engine="np64", **params))
        np.testing.assert_array_equal(to_host(value.ct.data), ref["out"])


@pytest.mark.parametrize("seed", range(50))
def test_ckks_fuzz_vs_numpy_oracle(seed):
    _ckks_eager(seed, 10_000, CKKS)


@pytest.mark.parametrize("seed", range(25))
def test_ckks_fuzz_tight_params(seed):
    """levels=3, scale_bits=28: every depth-2 chain ends on one 30-bit
    limb, so an add that lifts scales upward instead of bridging the fresh
    side down would wrap the last limb."""
    _ckks_eager(seed, 12_000, CKKS_TIGHT)


@pytest.mark.parametrize("seed", range(15))
def test_ckks_jit_fuzz_vs_numpy_oracle(seed):
    factory = CkksCiphertextFactory(device="cpu", **CKKS)
    rng = random.Random(11_000 + seed)
    inputs_src, program_src, oracle = reference()[0].gen_ckks_program(
        rng, factory.slot_count)
    jp = jit_compile_program(program_src, inputs_src, "out = acc;",
                             factory=factory, options=ALL_ON)
    raw = jp.run_raw(jp.secret_inputs)
    got = np.asarray(jp.decrypt_outputs(raw)["out"])
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}\ninputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got[:8]}\nwant={oracle[:8]}")
    if seed < WORD_SEEDS:
        assert_same_words(port_words(raw), reference_words(
            inputs_src, program_src, "out = acc;",
            RefCkksFactory(engine="np64", **CKKS)))
