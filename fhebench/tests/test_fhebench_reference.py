"""The plain references compute each program's cleartext function: the
program compiled by the port and run on its plaintext (dummy) backend
gives the reference's answers, and the controls differ from them. The
generator draws a BFV pool as it always has, and a CKKS configuration's
real inputs and model from the seed."""

import numpy as np
import pytest

from _tiny import full_cell
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


def small_logreg(tmp_path, length=8):
    cell = full_cell(tmp_path, "logreg.single")
    config = dict(cell.config)
    config["inputs"] = {k: dict(v, length=length)
                        for k, v in config["inputs"].items()}
    config["outputs"] = {k: dict(v, length=length)
                         for k, v in config["outputs"].items()}
    cell.config = config
    return cell


def test_logreg_reference_is_the_programs_function(tmp_path):
    """The dummy backend holds integers only, so the program runs under
    CKKS at n=1024 (its noise there ~4e-5 a slot) and is held to 1e-3."""
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program
    from fhebench.run import make_factory
    cell = small_logreg(tmp_path)
    ref = cell.reference()
    config = dict(cell.config, n=1024)
    for seed in (2 ** 31 + 5, 2 ** 33 + 1):
        entry = gen.draw_pool(config, dict(cell.traffic, pool=1), seed)[0]
        model = gen.draw_plain(config, seed)
        jp = jit_compile_program(
            cell.program_source(),
            gen.inputs_source(config, {k: v[0] for k, v in entry.items()},
                              model),
            gen.output_source(config), factory=make_factory(config, seed,
                                                            "cpu"))
        got = jp.run()["out"][:8]
        want = ref.answers(dict(entry, **model))[0]["out"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_logreg_coefficients_are_the_fit(tmp_path):
    cell = full_cell(tmp_path, "logreg.single")
    ref = cell.reference()
    assert ref.fit_g3() == (ref.C1, ref.C3)
    # Kim et al.'s g3 in x = 8u: 0.5 + 0.15012 x - 0.001593 x^3
    assert ref.C1 / 8 == pytest.approx(0.15012, abs=1e-5)
    assert ref.C3 / 512 == pytest.approx(0.001593, abs=1e-6)
    program = cell.program_source()
    assert repr(ref.C1) in program and repr(ref.C3) in program


def test_logreg_control_fails_its_tolerance(tmp_path):
    cell = full_cell(tmp_path, "logreg.single")
    ref = cell.reference()
    pool = gen.draw_pool(cell.config, dict(cell.traffic, pool=2), 2 ** 31 + 7)
    query = dict(pool[0], **gen.draw_plain(cell.config, 2 ** 31 + 7))
    want = np.array(ref.answers(query)[0]["out"])
    gap = np.abs(np.array(ref.control(query)[0]["out"]) - want)
    assert gap.max() > cell.config["tolerance"]
    assert -0.1 < want.min() and want.max() < 1.1


def test_bf16_rounding(tmp_path):
    import torch
    ref = full_cell(tmp_path, "logreg.single").reference()
    assert ref._bf16([1.0, 1.00390625, 1.01171875, 0.3, -3.0,
                      0.0]).tolist() == [1.0, 1.0, 1.015625, 0.30078125,
                                         -3.0, 0.0]
    x = np.random.default_rng(3).uniform(-9.0, 9.0, 4096)
    assert np.array_equal(ref._bf16(x), torch.tensor(x).to(
        torch.bfloat16).double().numpy())


def parent_draw_pool(config, traffic, seed):
    """draw_pool as it was before real inputs: integer inputs only."""
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    inputs = config["inputs"]
    names = sorted(inputs)
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < batch * pool:
        row = {name: [int(v) for v in rng.integers(
            inputs[name]["low"], inputs[name]["high"],
            int(inputs[name]["length"]))] for name in names}
        key = tuple(tuple(row[name]) for name in names)
        if key in seen:
            continue
        seen.add(key)
        rows.append(row)
    return [{name: [rows[p * batch + r][name] for r in range(batch)]
             for name in names} for p in range(pool)]


@pytest.mark.parametrize("name", ["laplace.single", "hamming.batch64",
                                  "hamming.stream"])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 9, 2 ** 33 + 5])
def test_bfv_pool_is_the_parents_draw(name, seed):
    cell = spec.load_cell(name)
    assert gen.draw_pool(cell.config, cell.traffic, seed) == \
        parent_draw_pool(cell.config, cell.traffic, seed)
    assert gen.draw_plain(cell.config, seed) == {}
    first = {k: v[0] for k, v in
             gen.draw_pool(cell.config, cell.traffic, seed)[0].items()}
    assert "double" not in gen.inputs_source(cell.config, first, {})


def test_real_inputs_and_model_from_the_seed(tmp_path):
    cell = small_logreg(tmp_path, length=64)
    a = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 9)
    b = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 9)
    c = gen.draw_pool(cell.config, cell.traffic, seed=2 ** 31 + 10)
    assert a == b and a != c and len(a) == cell.traffic["pool"]
    values = np.array([p[k][0] for p in a for k in sorted(p)])
    assert values.shape == (cell.traffic["pool"] * 18, 64)
    assert -1.0 <= values.min() and values.max() < 1.0
    assert len({tuple(v) for v in values}) == len(values)
    w = gen.draw_plain(cell.config, 2 ** 31 + 9)["w"]
    assert len(w) == 19 and sum(abs(v) for v in w) == pytest.approx(8.0)
    assert w == gen.draw_plain(cell.config, 2 ** 31 + 9)["w"] != \
        gen.draw_plain(cell.config, 2 ** 31 + 10)["w"]
    src = gen.inputs_source(cell.config, {k: v[0] for k, v in a[0].items()},
                            {"w": w})
    assert src.startswith("secret double x00 = {") and \
        src.endswith(f"double w = {{{','.join(map(repr, w))}}};")
