"""abc_tpu_torch's own compiler against abc_tpu's, program by program.

The port keeps its own copy of the host-only layers (utils, ast_ir, parser,
passes, the runtime executor and the dummy backend). These cases run the
same sources through both packages: the parsers must give the same IR
(`dumps(ast)`), `compile_program` the same printed program under each
`CompileOptions` combination the reference's tests use, and the dummy
backend the same outputs. Text and integers: the tolerance is equality.
"""

import glob
import os
import random

import pytest

import abc_tpu
import abc_tpu_torch
from abc_tpu.ast_ir import dumps as ref_dumps
from abc_tpu.ast_ir import reset_node_ids as ref_reset_ids
from abc_tpu.runtime.dummy import DummyCiphertextFactory as RefDummyFactory
from abc_tpu.runtime.executor import RuntimeVisitor as RefRuntimeVisitor
from abc_tpu.runtime.values import AbstractCiphertext as RefAbstractCiphertext
from abc_tpu.utils.datatype import Datatype as RefDatatype
from abc_tpu.utils.datatype import Type as RefType
from abc_tpu_torch.ast_ir import compare_ast, dumps, loads, reset_node_ids
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.runtime.values import AbstractCiphertext
from abc_tpu_torch.utils.datatype import Datatype, Type
from test_e2e_workloads import (CARDIO_PROGRAM, HAMMING_PROGRAM,
                                KERNEL_PROGRAM_TEMPLATE)
from test_pipeline_fuzz import gen_program
from test_secret_index import LAPLACE_SECRET_PROGRAM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    with open(os.path.join(REPO, "examples", name + ".fhe")) as f:
        return f.read()


_INT, _SECRET, _DOUBLE = ("INT", False), ("INT", True), ("DOUBLE", True)
# program → (source, free variables as (type name, secret))
PROGRAMS = {
    "hamming_distance": ("x y", _SECRET),
    "cardio": ("sex age antecedents smoker diabetes high_blood_pressure "
               "hdl_cholesterol weight height phy_activity drinking_habits",
               _INT),
    "box_blur": ("img imgSize", _INT),
    "secret_branching": ("c", _SECRET),
    "sum_vector_elements": ("v", _SECRET),
    "rotation": ("ctxt", _SECRET),
    "sum_n_times_2": ("n", _INT),
    "cross_product": ("", _INT),
    "discount_on_server": ("qualifies", _DOUBLE),
    "permute_matrix_elements": ("", _INT),
    "laplacian_sharpening": ("img imgSize", _INT),
}
PROGRAMS = {name: (_example(name), {v: kind for v in names.split()})
            for name, (names, kind) in PROGRAMS.items()}
PROGRAMS["polynomial_kernel"] = (
    _example("polynomial_kernel"), {"x": _SECRET, "y": _SECRET, "c": _INT})
# the sources of the end-to-end tests
PROGRAMS["e2e_hamming"] = (HAMMING_PROGRAM,
                           {"x": _SECRET, "y": _SECRET, "n": _INT})
PROGRAMS["e2e_cardio_secret"] = (CARDIO_PROGRAM, {
    v: _SECRET for v in PROGRAMS["cardio"][1]})
PROGRAMS["e2e_kernel"] = (
    KERNEL_PROGRAM_TEMPLATE % "{1, 1, 1, 1, -8, 1, 1, 1, 1}",
    {"img": _SECRET, "imgSize": _INT})
PROGRAMS["e2e_laplace_secret_index"] = (LAPLACE_SECRET_PROGRAM,
                                        {"img": _SECRET, "imgSize": _INT})

ALL = dict(ctes=True, loop_unrolling=True, vectorize=True,
           cone_rewriting=True, dead_store_elimination=True)
OPTIONS = {
    "default": {},
    "vectorize": {"vectorize": True},
    "no_unroll": {"loop_unrolling": False},
    "all_on": ALL,
    "all_off": {k: False for k in ALL},
    "live_out": {"live_out": {"out"}},
}


def test_the_corpus_is_covered():
    on_disk = {os.path.splitext(os.path.basename(p))[0]
               for p in glob.glob(os.path.join(REPO, "examples", "*.fhe"))}
    assert on_disk <= set(PROGRAMS) and len(on_disk) >= 12


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_parser_gives_the_reference_ir(name):
    src = PROGRAMS[name][0]
    reset_node_ids()
    ref_reset_ids()
    ast, ref_ast = abc_tpu_torch.Parser.parse(src), abc_tpu.Parser.parse(src)
    assert dumps(ast) == ref_dumps(ref_ast)
    assert str(ast) == str(ref_ast)                  # the pretty-printer
    assert compare_ast(ast, loads(dumps(ast)))       # JSON round trip


def _compiled_text(pkg, datatype, type_enum, src, inputs, options):
    """The compiled program as printed, or the error's type and text."""
    types = {v: datatype(type_enum[t], secret)
             for v, (t, secret) in inputs.items()}
    opts = dict(options)
    if "live_out" in opts:
        opts["live_out"] = set(opts["live_out"])
    try:
        compiled = pkg.compile_program(src, types, pkg.CompileOptions(**opts))
    except Exception as err:            # both sides must refuse alike
        return f"{type(err).__name__}: {err}"
    return str(compiled.ast)


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compile_program_prints_the_reference_program(name, option):
    src, inputs = PROGRAMS[name]
    got = _compiled_text(abc_tpu_torch, Datatype, Type, src, inputs,
                         OPTIONS[option])
    want = _compiled_text(abc_tpu, RefDatatype, RefType, src, inputs,
                          OPTIONS[option])
    assert got == want
    assert got                                       # nonempty either way


def _run_dummy(pkg, visitor, factory_cls, ct_type, inputs_src, program_src,
               output_src, options):
    input_ast = pkg.Parser.parse(inputs_src)
    compiled = pkg.Compiler(pkg.CompileOptions(**options)).compile_source(
        program_src, pkg.input_types_from_ast(input_ast))
    factory = factory_cls(slots=32)
    rv = visitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    out = []
    for name, value in rv.get_output(pkg.Parser.parse(output_src)):
        out.append((name, factory.decrypt(value)
                    if isinstance(value, ct_type) else list(value.values)))
    return str(compiled.ast), out


@pytest.mark.parametrize("option", ["all_on", "all_off"])
@pytest.mark.parametrize("seed", range(20))
def test_dummy_backend_outputs_match(seed, option):
    """The random programs of tests/test_pipeline_fuzz.py: compiled and
    executed on the dummy backend by both packages."""
    inputs_src, program_src, output_src, _ = gen_program(
        random.Random(1000 + seed))
    got = _run_dummy(abc_tpu_torch, RuntimeVisitor, DummyCiphertextFactory,
                     AbstractCiphertext, inputs_src, program_src, output_src,
                     OPTIONS[option])
    want = _run_dummy(abc_tpu, RefRuntimeVisitor, RefDummyFactory,
                      RefAbstractCiphertext, inputs_src, program_src,
                      output_src, OPTIONS[option])
    assert got == want


@pytest.mark.parametrize("name,inputs_src,output_src,expected", [
    ("cross_product", "", "out = result;",
     [27 * 38 - 32 * 21, 32 * 19 - 14 * 38, 14 * 21 - 27 * 19]),
    ("permute_matrix_elements", "", "out = m;", [11, 27, 32, 59]),
    ("sum_n_times_2", "int n = 5;", "out = sum;", [30]),
])
def test_examples_execute_on_the_dummy_backend(name, inputs_src, output_src,
                                               expected):
    """The executing cases of tests/test_examples.py through the port."""
    inputs = abc_tpu_torch.Parser.parse(inputs_src)
    compiled = abc_tpu_torch.compile_program(
        PROGRAMS[name][0], abc_tpu_torch.input_types_from_ast(inputs))
    _, pairs = abc_tpu_torch.run_compiled(
        compiled, inputs, abc_tpu_torch.Parser.parse(output_src),
        DummyCiphertextFactory(8))
    assert [int(v) for v in pairs[0][1].values[:len(expected)]] == expected


def _discount(pkg, factory, datatype):
    """tests/test_examples.py::test_discount_on_server_executes_ckks's run
    in package `pkg` on `factory`: the decrypted rate and the output
    ciphertext."""
    compiled = pkg.compile_program(
        PROGRAMS["discount_on_server"][0],
        {"qualifies": datatype.Datatype(datatype.Type.DOUBLE, True)})
    inputs = pkg.Parser.parse("secret double qualifies = 1.0;")
    _, pairs = pkg.run_compiled(compiled, inputs,
                                pkg.Parser.parse("out = discountRate;"),
                                factory)
    return factory.decrypt(pairs[0][1])[0], pairs[0][1].ct


def test_discount_on_server_executes_ckks():
    """The float mux over a secret flag, encrypted on the port's CKKS
    factory (seed 7: two products with plaintext constants, added at their
    common scale), decrypts to 0.90, and its output words, level and scale
    are abc_tpu's np64 factory's."""
    import numpy as np
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory as RefCkks
    from abc_tpu.utils import datatype as ref_datatype
    from abc_tpu_torch.ops.modarith import to_host
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu_torch.utils import datatype
    got, ct = _discount(abc_tpu_torch,
                        CkksCiphertextFactory(seed=7, device="cpu"), datatype)
    assert abs(got - 0.90) < 1e-2
    _, ref_ct = _discount(abc_tpu, RefCkks(seed=7, engine="np64"),
                          ref_datatype)
    assert (ct.level, ct.scale) == (ref_ct.level, ref_ct.scale)
    np.testing.assert_array_equal(to_host(ct.data), np.asarray(ref_ct.data))


@pytest.mark.gpu
def test_discount_on_server_executes_ckks_on_cuda():
    """The same on the card: 0.90, and the words of the port's CPU run of
    the same seed."""
    import torch
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu_torch.utils import datatype
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, ct = _discount(abc_tpu_torch,
                        CkksCiphertextFactory(seed=7, device="cuda"),
                        datatype)
    _, cpu_ct = _discount(abc_tpu_torch,
                          CkksCiphertextFactory(seed=7, device="cpu"),
                          datatype)
    assert abs(got - 0.90) < 1e-2
    assert torch.equal(ct.data.cpu(), cpu_ct.data)
