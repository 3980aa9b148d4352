"""The plain references compute each program's cleartext function: the
program compiled by the port and run on its plaintext (dummy) backend
gives the reference's answers, and the controls differ from them."""

import json
import os

import numpy as np
import pytest

from _tiny import REPO
from fhebench.harness import spec, traffic as gen

CELLS = ("laplace.single", "hamming.batch64")


def dummy_answers(cell, row):
    from abc_tpu_torch import Parser, compile_program, input_types_from_ast
    from abc_tpu_torch.passes.pipeline import CompileOptions
    from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
    from abc_tpu_torch.runtime.executor import RuntimeVisitor
    config = cell.config
    inputs = Parser.parse(gen.inputs_source(config, row))
    compiled = compile_program(cell.program_source(),
                               input_types_from_ast(inputs),
                               CompileOptions(**config["compile"]))
    factory = DummyCiphertextFactory(slots=64)
    rv = RuntimeVisitor(factory, inputs, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    out = {}
    for name, value in rv.get_output(Parser.parse(gen.output_source(config))):
        out[name] = [int(v) for v in factory.decrypt(value)]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_programs_function(name):
    cell = spec.load_cell(name)
    ref = cell.reference()
    pool = gen.draw_pool(cell.config, dict(cell.traffic, pool=1, batch=6),
                         seed=2 ** 33 + 5)
    t = 1 << 20
    for r in range(6):
        row = {k: v[r] for k, v in pool[0].items()}
        got = dummy_answers(cell, row)
        want = ref.answers({k: [v] for k, v in row.items()})[0]
        for out, spec_ in cell.config["outputs"].items():
            n = spec_["length"]
            assert [v % t for v in got[out][:n]] == \
                [v % t for v in want[out][:n]]


def test_laplace_reference_by_hand():
    ref = spec.load_cell("laplace.single").reference()
    img = list(range(16))
    out = ref.answers({"img": [img]})[0]["out"]
    # inner pixel (1, 1) = 5: 2*5 - (0+1+2+4-8*5+6+8+9+10) = 10 - 0
    assert out[5] == 2 * 5 - (0 + 1 + 2 + 4 + 6 + 8 + 9 + 10 - 8 * 5)
    assert out[0] == 0 and out[15] == 15


def test_controls_differ_from_the_reference():
    lap = spec.load_cell("laplace.single").reference()
    img = [40000 + i for i in range(16)]
    assert lap.control({"img": [img]}) != lap.answers({"img": [img]})
    ham = spec.load_cell("hamming.batch64").reference()
    q = {"x": [[1, 1, 0, 0], [0, 0, 0, 0]], "y": [[0, 0, 0, 0]] * 2}
    assert [r["out"] for r in ham.answers(q)] == [[2], [0]]
    assert [r["out"] for r in ham.control(q)] == [[0], [2]]


def test_pool_is_distinct_and_seeded():
    cell = spec.load_cell("hamming.batch64")
    a = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 9)
    b = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 9)
    c = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 10)
    assert a == b and a != c
    rows = {(tuple(x), tuple(y)) for p in a for x, y in zip(p["x"], p["y"])}
    assert len(rows) == cell.traffic["pool"] * cell.traffic["batch"]
    lap = spec.load_cell("laplace.single")
    imgs = gen.draw_pool(lap.config, lap.traffic, seed=7)
    assert len({tuple(p["img"][0]) for p in imgs}) == lap.traffic["pool"]
    assert max(max(p["img"][0]) for p in imgs) < 65536
