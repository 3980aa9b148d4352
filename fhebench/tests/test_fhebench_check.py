"""The check of outputs at work, on the CPU at n=1024 (the chip's look
skipped), in the committed cells and the CKKS cell that the tests keep
(_tiny.py): a sound run is correct; the control put in the program's place
is not, nor a CKKS program at a scale 2^10 lower; and a run whose timed
path is broken underneath is not, once for each fault the cell can have (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced, an answer from another request; one
chip, so no exchange between chips to leave out). The op census of one
walk is the programs' known one, a CKKS program's by level."""

import pytest
import torch

from _tiny import tiny_cell
from fhebench.harness import check
from fhebench.run import run_cell

SEED = 2 ** 31 + 11
SMALL = {"laplace.single": dict(pool=3, keep=3),
         "hamming.batch64": dict(pool=2, batch=4, keep=2),
         "hamming.stream": dict(pool=4, keep=4),
         "logreg.single": dict(pool=2, keep=2)}
CKKS_CENSUS = {"ckks_decompose@6": 1, "ckks_decompose@7": 1,
               "ckks_decompose@8": 3, "ckks_key_switch@6": 1,
               "ckks_key_switch@7": 1, "ckks_key_switch@8": 3,
               "ckks_multiply@6": 1, "ckks_multiply@7": 1,
               "ckks_plain_scalar@5": 1, "ckks_plain_scalar@7": 1,
               "ckks_plain_scalar@8": 18, "ckks_rescale@6": 1,
               "ckks_rescale@7": 1, "ckks_rescale@8": 3}
SUFFIX = {"laplace.single": "single", "hamming.batch64": "batch",
          "hamming.stream": "stream", "logreg.single": "logreg"}


def one_run(tmp_path, name, control=False, **config):
    cell = tiny_cell(tmp_path, name, **SMALL[name])
    cell.config = dict(cell.config, **config)
    result, table = run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                             control=control)
    return result, table


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(tmp_path, name):
    result, table = one_run(tmp_path, name)
    assert result["correct"], table
    assert table["checked_slots"]["value"] > 0
    assert list(result)[-1] == "checks"
    suffix = SUFFIX[name]
    assert set(result["metrics"]) == {f"programs_per_s.{suffix}",
                                      f"latency_p95_ms.{suffix}", "setup_s"}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(tmp_path, name):
    result, table = one_run(tmp_path, name, control=True)
    assert not result["correct"]
    assert table["wrong_slots"]["value"] > 0


def test_control_reaches_across_requests_of_one_row(tmp_path):
    """hamming's control (rows shifted by one) runs over the kept requests
    as one batch, so that in hamming.stream, one row a request, a row is
    answered from another request's query."""
    result, table = one_run(tmp_path, "hamming.stream", control=True)
    assert not result["correct"], table
    assert table["wrong_slots"]["value"] > 0


def test_ckks_program_at_a_lower_scale_is_not_correct(tmp_path):
    cell = tiny_cell(tmp_path, "logreg.single", **SMALL["logreg.single"])
    result, table = one_run(tmp_path, "logreg.single",
                            scale_bits=cell.config["scale_bits"] - 10)
    assert not result["correct"]
    assert "max_abs_error" not in table
    assert result["run"]["max_abs_error"] > 10 * cell.config["tolerance"]


def unchanged(jp, inputs, out):
    """The first input in each output's place, cut or padded with zeros to
    the output's components and primes (a CKKS answer has fewer)."""
    first = next(iter(inputs.values()))

    def like(t):
        same = torch.zeros_like(t)
        c, lv = min(t.shape[-3], first.shape[-3]), min(t.shape[-2],
                                                        first.shape[-2])
        same[..., :c, :lv, :] = first[..., :c, :lv, :]
        return same

    return {name: like(t) for name, t in out.items()}


def half_left_out(jp, inputs, out):
    broken = {}
    for name, t in out.items():
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        broken[name] = t
    return broken


def altered(jp, inputs, out):
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    ctx = jp.factory.context
    if isinstance(jp.factory, CkksCiphertextFactory):
        # every residue negated: each slot's value negated
        return {name: ((q - t) % q).to(t.dtype) for name, t in out.items()
                for q in [ctx.q_q[:t.shape[-2]].to(torch.int64)]}
    return {name: ctx.negate(BfvCiphertext(t)).data
            for name, t in out.items()}


class FromAnotherRequest:
    """Each request answered with the previous request's answer."""

    def __init__(self):
        self.last = None

    def __call__(self, jp, inputs, out):
        previous, self.last = self.last or out, out
        return previous


FAULTS = [("laplace.single", unchanged), ("laplace.single", altered),
          ("laplace.single", FromAnotherRequest),
          ("hamming.batch64", unchanged), ("hamming.batch64", half_left_out),
          ("hamming.batch64", altered),
          ("hamming.stream", unchanged), ("hamming.stream", altered),
          ("hamming.stream", FromAnotherRequest),
          ("logreg.single", unchanged), ("logreg.single", half_left_out),
          ("logreg.single", altered), ("logreg.single", FromAnotherRequest)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    from abc_tpu_torch.runtime.jit_executor import JittedProgram
    real = JittedProgram.run_raw
    if isinstance(fault, type):
        fault = fault()

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
                         "plain_scalar": 0}),
    ("hamming.stream", {"operand": 2, "multiply": 1, "decompose": 4,
                        "key_switch": 4, "plain_product": 0,
                        "plain_scalar": 0}),
    # 18 weights and c1, c3 by scalars; u relinearized and rescaled at
    # each of its three uses, u^2 and u^3 once each
    ("logreg.single", CKKS_CENSUS)])
def test_op_census(tmp_path, name, want):
    from abc_tpu_torch.parallel.sharding import make_mesh
    from abc_tpu_torch.passes.pipeline import CompileOptions
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program
    from fhebench.harness import census, traffic as gen
    from fhebench.run import make_factory
    cell = tiny_cell(tmp_path, name, **SMALL[name])
    c, mix = cell.config, cell.traffic
    values = gen.draw_pool(c, mix, SEED)
    mesh = make_mesh(**mix["mesh"], device="cpu") if "mesh" in mix \
        else None
    jp = jit_compile_program(
        cell.program_source(),
        gen.inputs_source(c, {k: v[0] for k, v in values[0].items()},
                          gen.draw_plain(c, SEED)),
        gen.output_source(c), factory=make_factory(c, SEED, "cpu"),
        options=CompileOptions(**c["compile"]), mesh=mesh,
        batch_values=values[0] if mesh else None)
    assert census.op_census(jp, jp.secret_inputs) == want


@pytest.mark.parametrize("scheme", ["bgv", None])
def test_only_bfv_configurations(tmp_path, scheme):
    """Only the schemes the harness drives (BFV, CKKS) are taken: any other
    is refused before a key is made."""
    from fhebench.harness import spec
    cell = tiny_cell(tmp_path, "hamming.batch64", **SMALL["hamming.batch64"])
    cell.config = dict(cell.config, scheme=scheme)
    with pytest.raises(spec.SpecError):
        run_cell(cell, SEED, 0.5, False, torch.device("cpu"))


def test_ckks_takes_one_request_a_replay(tmp_path):
    from fhebench.harness import spec
    cell = tiny_cell(tmp_path, "logreg.single", batch=2, pool=1, keep=1)
    with pytest.raises(spec.SpecError):
        run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
