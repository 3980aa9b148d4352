"""The port's CLI, profiling helpers and circuit generators against
abc_tpu's: `run_benchmark` of all six workloads on the dummy backend and of
hamming on the BFV backend (slots=1024, CPU) must decrypt to the reference
CLI's outputs with the same CSV schema; ProfilingFactory/OpRecorder count
the reference's ops (tests/test_profiling.py's programs); circuits.py emits
the reference's sources.
"""

import os
import subprocess
import sys
import warnings

import pytest

import abc_tpu.circuits as ref_circuits
import abc_tpu.cli as ref_cli
import abc_tpu_torch.circuits as circuits
from abc_tpu.runtime.dummy import DummyCiphertextFactory as RefDummy
from abc_tpu.utils.profiling import ProfilingFactory as RefProfilingFactory
from abc_tpu_torch import cli
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.utils.profiling import (OpRecorder, PhaseTimer,
                                           ProfilingFactory, device_trace)
from helpers import run_program
from test_torch_slice import _run_program_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = ["cardio", "hamming", "boxblur", "dotproduct", "l2distance",
             "matvec"]
HEADER = "t_keygen,t_input_encryption,t_computation,t_decryption"
TIMINGS = set(HEADER.split(","))


def _outputs(result):
    return {k: [int(v) for v in vals]
            for k, vals in result["_outputs"].items()}


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_sources_equal_the_reference(name):
    ours, theirs = cli._workload(name), ref_cli._workload(name)
    assert ours[:3] == theirs[:3]
    assert vars(ours[3]) == vars(theirs[3])


def test_unknown_workload_exits():
    with pytest.raises(SystemExit, match="unknown benchmark"):
        cli._workload("nope")


@pytest.mark.parametrize("name", WORKLOADS)
def test_run_benchmark_dummy_equals_the_reference_cli(name):
    ours = cli.run_benchmark(name, "dummy", slots=64, runs=2)
    theirs = ref_cli.run_benchmark(name, "dummy", slots=64, runs=2)
    assert set(ours) == set(theirs) == TIMINGS | {"_outputs"}
    assert all(ours[k] >= 0 for k in TIMINGS)
    assert _outputs(ours) == _outputs(theirs)


def test_run_benchmark_bfv_equals_the_reference_cli():
    ours = cli.run_benchmark("hamming", "bfv", slots=1024, device="cpu")
    theirs = ref_cli.run_benchmark("hamming", "bfv", slots=1024,
                                   engine="np64")
    assert _outputs(ours) == _outputs(theirs)
    assert _outputs(ours)["sum"][0] == 2
    assert all(ours[k] > 0 for k in TIMINGS)


def test_auto_params_needs_the_bfv_backend():
    with pytest.raises(SystemExit, match="--backend bfv"):
        cli.run_benchmark("hamming", "dummy", auto_params=True)


def test_main_writes_the_reference_csv_schema(tmp_path, capsys):
    out_csv = tmp_path / "r.csv"
    assert cli.main(["matvec", str(out_csv), "--backend", "dummy", "--slots",
                     "64"]) == 0
    lines = out_csv.read_text().splitlines()
    assert lines[0] == HEADER and len(lines) == 2
    assert all(float(v) >= 0 for v in lines[1].split(","))
    ref_csv = tmp_path / "ref.csv"
    assert ref_cli.main(["matvec", str(ref_csv), "--slots", "64"]) == 0
    assert ref_csv.read_text().splitlines()[0] == lines[0]
    assert capsys.readouterr().err.count("y: [") == 2    # one per CLI


def test_main_prints_the_reference_outputs(capsys):
    assert cli.main(["hamming", "-", "--backend", "bfv", "--device", "cpu"]) \
        == 0
    ours = capsys.readouterr()
    assert ref_cli.main(["hamming", "-", "--backend", "bfv"]) == 0
    theirs = capsys.readouterr()
    assert ours.err == theirs.err and "sum: [2" in ours.err
    assert ours.out.splitlines()[0] == theirs.out.splitlines()[0] == HEADER


def test_cli_auto_params_flag(tmp_path, capsys):
    out_csv = tmp_path / "r.csv"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = cli.main(["hamming", str(out_csv), "--backend", "bfv",
                       "--auto-params", "--device", "cpu"])
        captured = capsys.readouterr()
        assert ref_cli.main(["hamming", str(tmp_path / "ref.csv"),
                             "--backend", "bfv", "--auto-params"]) == 0
    assert rc == 0
    assert captured.err == capsys.readouterr().err   # the same set chosen
    assert "auto-params: n=" in captured.err
    assert "sum: [2" in captured.err
    assert out_csv.read_text().startswith("t_keygen,")


def test_cli_profile_writes_a_chrome_trace(tmp_path):
    assert cli.main(["hamming", str(tmp_path / "r.csv"), "--backend", "bfv",
                     "--device", "cpu", "--profile",
                     str(tmp_path / "trace")]) == 0
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and "traceEvents" in trace.read_text()[:4096]


def test_cuda_is_the_default_device_and_needs_a_gpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["hamming", "-"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_benchmark("hamming")


def test_module_entry_point_runs_in_a_process_of_its_own():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "abc_tpu_torch", "hamming", "-", "--backend",
         "bfv", "--slots", "1024", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == HEADER and len(lines[1].split(",")) == 4
    assert "sum: [2" in proc.stderr


# ------------------------------------------------------------------ profiling

PROFILED = [
    ("secret int x = {1,2,3}; secret int y = {4,5,6};",
     "secret int s = x +++ y; s = s *** x; s = rotate(s, 1);", "out = s;"),
    ("secret int x = {1};", "x = x *** x;", "y = x;"),
    ("secret int x = {1,2,3}; int w = {2,2,2};",
     "secret int s = x *** w; s = s --- x; s = s +++ 1; s = 9 --- s;",
     "out = s;"),
]


@pytest.mark.parametrize("inputs,program,output", PROFILED)
def test_profiling_factory_counts_equal_the_reference(inputs, program,
                                                      output):
    ours = ProfilingFactory(DummyCiphertextFactory(64))
    theirs = RefProfilingFactory(RefDummy(64))
    _, pairs = _run_program_port(inputs, program, output, ours)
    _, ref_pairs = run_program(inputs, program, output, theirs)
    assert ours.decrypt(pairs[0][1]) == theirs.decrypt(ref_pairs[0][1])
    counts = {r["op"]: r["count"] for r in ours.report()}
    assert counts == {r["op"]: r["count"] for r in theirs.report()}
    assert counts["encrypt"] >= 1 and counts["decrypt"] == 1
    rows = ours.report()
    assert all("total_ms" in r for r in rows)
    assert rows == sorted(rows, key=lambda r: -r["total_ms"])


def test_profiling_factory_counts_ops():
    factory = ProfilingFactory(DummyCiphertextFactory(64))
    _, pairs = _run_program_port(*PROFILED[0], factory)
    report = {r["op"]: r["count"] for r in factory.report()}
    assert (report["encrypt"], report["add"], report["multiply"],
            report["rotate_rows"]) == (2, 1, 1, 1)
    # s = (x+y)*x = [5,14,27], then rotated left by 1
    assert factory.decrypt(pairs[0][1])[:2] == [14, 27]


def test_phase_timer_and_op_recorder():
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("compute"):
            sum(range(1000))
    assert t.as_millis()["compute"] >= 0 and len(t.phases) == 1
    rec = OpRecorder()
    rec.record("add", 0.001)
    rec.record("add", 0.002)
    rec.record("multiply", 0.010)
    assert rec.report() == [
        {"op": "multiply", "count": 1, "total_ms": 10.0},
        {"op": "add", "count": 2, "total_ms": 3.0}]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with device_trace(str(tmp_path / "t")):
        torch.arange(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


# ------------------------------------------------------------------- circuits

@pytest.mark.parametrize("call", [
    "chi_squared()", "sorting_comparator()", "sorting_comparator(4, 'p', 'q')",
    "sorting_comparator_inputs()", "sorting_comparator_inputs(4, 'p', 'q')",
    "cardio_netlist()", "cardio_netlist(4, 3)", "cardio_netlist_inputs()",
    "cardio_netlist_inputs(4, 3)", "sorting_network()",
    "sorting_network(3, 2)"])
def test_circuit_generators_emit_the_reference_sources(call):
    ours = eval(call, vars(circuits))
    assert ours == eval(call, vars(ref_circuits)) and len(ours) > 0
