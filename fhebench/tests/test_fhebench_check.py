"""The check of outputs at work, on the CPU at n=1024 (the chip's look
skipped): a sound run is correct; the control put in the program's place
is not; and a run whose timed path is broken underneath is not, once for
each fault the cell can have (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced; one
chip, so no exchange between chips to leave out). The op census of one
walk is the programs' known one."""

import pytest
import torch

from _tiny import tiny_cell
from fhebench.harness import check
from fhebench.run import run_cell

SEED = 2 ** 31 + 11
SMALL = {"laplace.single": dict(pool=3, keep=3),
         "hamming.batch64": dict(pool=2, batch=4, keep=2)}


def one_run(tmp_path, name, control=False):
    cell = tiny_cell(tmp_path, name, **SMALL[name])
    result, table = run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                             control=control)
    return result, table


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(tmp_path, name):
    result, table = one_run(tmp_path, name)
    assert result["correct"], table
    assert table["checked_slots"]["value"] > 0
    assert list(result)[-1] == "checks"
    suffix = {"laplace.single": "single", "hamming.batch64": "batch"}[name]
    assert set(result["metrics"]) == {f"programs_per_s.{suffix}",
                                      f"latency_p95_ms.{suffix}", "setup_s"}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(tmp_path, name):
    result, table = one_run(tmp_path, name, control=True)
    assert not result["correct"]
    assert table["wrong_slots"]["value"] > 0


def unchanged(jp, inputs, out):
    first = next(iter(inputs.values()))
    return {name: first.clone() for name in out}


def half_left_out(jp, inputs, out):
    broken = {}
    for name, t in out.items():
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        broken[name] = t
    return broken


def altered(jp, inputs, out):
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    ctx = jp.factory.context
    return {name: ctx.negate(BfvCiphertext(t)).data
            for name, t in out.items()}


FAULTS = [("laplace.single", unchanged), ("laplace.single", altered),
          ("hamming.batch64", unchanged), ("hamming.batch64", half_left_out),
          ("hamming.batch64", altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    from abc_tpu_torch.runtime.jit_executor import JittedProgram
    real = JittedProgram.run_raw

    def broken(self, inputs):
        return fault(self, inputs, real(self, inputs))

    monkeypatch.setattr(JittedProgram, "run_raw", broken)
    result, table = one_run(tmp_path, name)
    assert not result["correct"], table


def test_verdict_limits():
    table, ok = check.verdict({"wrong_slots": 0, "unanswered": 0,
                               "checked_slots": 5})
    assert ok and [r["limit"] for r in table.values()] == [0, 0, 1]
    assert not check.verdict({"wrong_slots": 1, "unanswered": 0,
                              "checked_slots": 5})[1]
    assert not check.verdict({"wrong_slots": 0, "unanswered": 0,
                              "checked_slots": 0})[1]
    assert check.lines(table)[0] == "check wrong_slots 0 limit at most 0"


@pytest.mark.parametrize("name,want", [
    ("laplace.single", {"operand": 0, "multiply": 0, "decompose": 5,
                        "key_switch": 43, "plain_product": 5,
                        "plain_scalar": 40}),
    ("hamming.batch64", {"operand": 2, "multiply": 1, "decompose": 4,
                         "key_switch": 4, "plain_product": 0,
                         "plain_scalar": 0})])
def test_op_census(tmp_path, name, want):
    from abc_tpu_torch.parallel.sharding import make_mesh
    from abc_tpu_torch.passes.pipeline import CompileOptions
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program
    from fhebench.harness import census, traffic as gen
    cell = tiny_cell(tmp_path, name, **SMALL[name])
    c, mix = cell.config, cell.traffic
    values = gen.draw_pool(c, mix, SEED)
    mesh = make_mesh(**mix["mesh"], device="cpu") if "mesh" in mix \
        else None
    jp = jit_compile_program(
        cell.program_source(),
        gen.inputs_source(c, {k: v[0] for k, v in values[0].items()}),
        gen.output_source(c),
        factory=BfvCiphertextFactory(slots=c["n"], seed=SEED, device="cpu"),
        options=CompileOptions(**c["compile"]), mesh=mesh,
        batch_values=values[0] if mesh else None)
    assert census.op_census(jp, jp.secret_inputs) == want


def test_only_bfv_configurations(tmp_path):
    from fhebench.harness import spec
    cell = tiny_cell(tmp_path, "hamming.batch64", **SMALL["hamming.batch64"])
    cell.config = dict(cell.config, scheme="ckks")
    with pytest.raises(spec.SpecError):
        run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
