"""The program's spans (abc_tpu_torch.utils.profiling.SpanRecorder, owned by
a JittedProgram as `jp.tracer`): how spans nest and share a request, the
set-up phases that phase_ms views, request spans off by default, the
warm-up's host-made constants, the encryption's draws, the profiler's view
of a span, the CLI's phases, and the device stages' raw records
(DeviceStages on stand-in events here, on CUDA events on the card).
"""

import json
import time

import pytest
import torch

from abc_tpu_torch import jit_compile_program
from abc_tpu_torch.ops.modarith import CHAIN_PREFIX, chain_range
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.utils import profiling
from abc_tpu_torch.utils.profiling import (DeviceStages, SpanRecorder,
                                           nbytes, span)

PHASES = {"eval_ready", "encrypt", "key_census", "key_build", "setup_other",
          "parse_compile"}
# an in-program encryption (7), a plaintext operand (3) and a rotation
PROGRAM = dict(
    program_src="secret int v = 7; v = v +++ x; v = v *** 3; "
                "v = rotate(v, 1); return v;",
    inputs_src="secret int x = {5, 1, 2};", output_src="out = v;")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _program(seed=3, device="cpu"):
    return jit_compile_program(factory=BfvCiphertextFactory(
        slots=1024, seed=seed, device=device), **PROGRAM)


class _Clock:
    """Device time, ms, of the stand-in events."""
    now = 0.0


class _Event:
    """A CUDA event on the host: recorded at _Clock.now."""
    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = _Clock.now

    def query(self):
        return self.t is not None and self.t <= _Clock.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def events(monkeypatch):
    """DeviceStages on the CPU: torch.cuda's events and synchronize stood
    in for by _Event and a no-op."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    _Clock.now, _Event.made = 0.0, 0
    return _Clock


def _serve(stages, gaps, copy=0.1, replay=3.0, clone=0.05, prelude_ns=0):
    """Requests on stand-in events, as run_raw records them: the device
    idle `gap` ms before each one, the host in run_raw `prelude_ns` before
    it records the first event."""
    for rid, gap in enumerate(gaps, start=1):
        _Clock.now += gap
        ev, stream = stages.start(rid, time.perf_counter_ns() - prelude_ns)
        for ms, e in zip((copy, replay), ev[1:3]):
            _Clock.now += ms
            e.record(stream)
        _Clock.now += clone
        stages.end(ev, stream)
    stages.finish()


# ------------------------------------------------------------ the recorder

def test_spans_nest_and_share_their_request():
    rec = SpanRecorder()
    with rec.span("a") as a:
        with rec.span("b"):
            pass
        a.set(bytes=8)
    with rec.span("req", request=True):
        with rec.span("child"):
            with rec.span("grandchild"):
                pass
    with rec.span("req", request=True):
        pass
    rows = rec.read()["spans"]
    assert [s["name"] for s in rows] == ["a", "b", "req", "child",
                                         "grandchild", "req"]
    assert [s["parent"] for s in rows] == [None, 0, None, 2, 3, None]
    assert [s["request"] for s in rows] == [0, 0, 1, 1, 1, 2]
    assert rows[0]["attrs"] == {"bytes": 8}
    assert all(s["start_ns"] <= s["end_ns"] for s in rows)
    assert rows[1]["start_ns"] >= rows[0]["start_ns"] and \
        rows[1]["end_ns"] <= rows[0]["end_ns"]


def test_library_spans_record_only_into_an_activated_recorder():
    rec = SpanRecorder()
    with span("nowhere") as s:
        s.set(bytes=1)
    assert rec.spans == []
    with rec.activated():
        with rec.span("outer"):
            with span("inner", kind="encode"):
                pass
    with span("after"):
        pass
    assert [(r[0], r[3], r[5]) for r in rec.spans] == [
        ("outer", None, None), ("inner", 0, {"kind": "encode"})]


def test_setup_spans_drain_the_device_and_request_spans_do_not():
    """Each set-up phase drains the device at both ends; a span inside a
    phase and a request span do not."""
    drains = []
    rec = SpanRecorder(sync=lambda: drains.append(1))
    rec.phase("one")
    with rec.span("child"):
        with rec.span("grandchild"):
            pass
    assert len(drains) == 1
    rec.phase("two")
    rec.phase(None)
    assert len(drains) == 4
    with rec.span("req", request=True):
        with rec.span("copy_in"):
            pass
    assert len(drains) == 4
    assert set(rec.phase_ms()) == {"one", "two"}


def test_phase_ms_is_the_view_of_the_setup_spans():
    jp = _program()
    assert set(jp.phase_ms) == PHASES
    rows = jp.tracer.read()["spans"]
    top = [s for s in rows if s["parent"] is None]
    assert {s["name"] for s in top} == PHASES
    for name, ms in jp.phase_ms.items():
        assert ms == pytest.approx(sum(
            (s["end_ns"] - s["start_ns"]) / 1e6 for s in top
            if s["name"] == name))
    # the set-up's encryption records its draws below the `encrypt` phase
    enc = next(s for s in top if s["name"] == "encrypt")
    assert [s["name"] for s in rows if s["parent"] == enc["id"]] == \
        ["draws", "device_pass"]


def test_requests_record_nothing_until_traced_and_equal_traced_words():
    jp = _program()
    first = jp.run_raw(jp.secret_inputs)      # the CPU's first run: the tape
    n = len(jp.tracer.spans)
    fresh = jp.encrypt_inputs({"x": [4, 4, 4]})
    off = jp.run_raw(fresh)
    assert len(jp.tracer.spans) == n and jp.tracer.stages is None
    jp.trace_requests(True)
    on = jp.run_raw(fresh)
    assert torch.equal(off["out"], on["out"])
    assert not torch.equal(first["out"], on["out"])
    rows = jp.tracer.read()["spans"][n:]
    assert [s["name"] for s in rows] == ["run_raw", "checks", "run_eager"]
    assert [s["parent"] for s in rows] == [None, n, n]
    assert {s["request"] for s in rows} == {1}
    jp.trace_requests(False)
    jp.run_raw(fresh)
    assert len(jp.tracer.spans) == n + 3


def test_a_request_that_raises_closes_its_spans():
    """run_raw refusing its inputs leaves its spans closed and nothing
    open, so that the next request records as the first would have."""
    from abc_tpu_torch.utils.errors import RuntimeExecutionError
    jp = _program()
    jp.trace_requests(True)
    n = len(jp.tracer.spans)
    with pytest.raises(RuntimeExecutionError):
        jp.run_raw({})
    rows = jp.tracer.read()["spans"][n:]
    assert [s["name"] for s in rows] == ["run_raw", "checks"]
    assert all(s["end_ns"] is not None for s in rows)
    assert jp.tracer._open == []
    jp.run_raw(jp.secret_inputs)
    again = jp.tracer.read()["spans"][n + 2:]
    assert again[0]["name"] == "run_raw" and again[0]["parent"] is None
    assert {s["request"] for s in again} == {2}


def test_encrypt_inputs_has_a_draws_child():
    jp = _program()
    jp.trace_requests(True)
    jp.encrypt_inputs({"x": [1, 2, 3]})
    jp.encrypt_inputs({"x": [3, 2, 1]})
    rows = jp.tracer.read()["spans"]
    calls = [s for s in rows if s["name"] == "encrypt_inputs"]
    assert [s["request"] for s in calls] == [1, 2]
    for call in calls:
        kids = [s for s in rows if s["parent"] == call["id"]]
        assert [s["name"] for s in kids] == ["draws", "device_pass"]
        assert kids[0]["attrs"] == {"rows": 1}
        assert {s["request"] for s in kids} == {call["request"]}
        assert call["start_ns"] <= kids[0]["start_ns"] <= \
            kids[0]["end_ns"] <= kids[1]["start_ns"] <= \
            kids[1]["end_ns"] <= call["end_ns"]


def test_host_made_constants_are_spans_of_the_recording_run():
    """What the warm-up records on the card (one span a tape entry, its
    kind and bytes), here from the first eager walk on the CPU."""
    jp = _program()
    assert jp._tape.items == []
    with jp.tracer.activated():
        with jp.tracer.span("warmup"):
            jp.run_eager(jp.secret_inputs)
    rows = jp.tracer.read()["spans"]
    made = [s for s in rows if s["name"] == "host_constant"]
    assert len(made) == len(jp._tape.items) >= 2
    assert [s["attrs"]["kind"] for s in made] == \
        [key[0] for key, _ in jp._tape.items]
    assert {"encode", "encrypt"} <= {s["attrs"]["kind"] for s in made}
    assert sum(s["attrs"]["bytes"] for s in made) == \
        sum(nbytes(v) for _, v in jp._tape.items) > 0
    warmup = next(s for s in rows if s["name"] == "warmup")
    assert all(s["parent"] == warmup["id"] for s in made)
    # a served run makes nothing
    with jp.tracer.activated():
        jp.run_eager(jp.secret_inputs)
    assert len(jp.tracer.spans) == len(rows)


def test_lazily_built_tables_and_keys_are_spans():
    factory = BfvCiphertextFactory(slots=1024, seed=5, device="cpu")
    ctx = factory.context
    rec = SpanRecorder()
    with rec.activated():
        ctx.get_galois_key(3)
        ctx.get_galois_key(3)
        ctx._galois_inv(3)
        ctx._galois_inv(3)
    assert [r[0] for r in rec.spans] == ["build_keys", "galois_perm",
                                         "galois_inv"]
    assert rec.spans[1][3] == 0 and rec.spans[0][5] == {"keys": 1}


def test_a_span_is_a_profiler_range_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile
    rec = SpanRecorder()
    assert chain_range("x") is profiling._NOTHING
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_active()
        with rec.span("run_raw", request=True):
            with chain_range("tensor"):
                torch.arange(4).sum()
    names = [e.name for e in prof.events()]
    assert "run_raw" in names and CHAIN_PREFIX + "tensor" in names
    assert not profiling.profiler_active()


# ---------------------------------------------------------- device stages

def test_device_stages_resolve_durations_and_gaps(events):
    stages = DeviceStages("cuda")
    _serve(stages, [5.0, 0.2, 0.4])
    got = [(r["request"], r["gap_ms"]) for r in stages.requests]
    assert got == [(1, None), (2, pytest.approx(0.2)),
                   (3, pytest.approx(0.4))]
    for r in stages.requests:
        assert (r["copy_in_ms"], r["replay_ms"], r["clone_out_ms"]) == \
            pytest.approx((0.1, 3.0, 0.05))
        assert r["mark_ns"] >= r["enter_ns"] and not r["profiled"]
    assert len(stages.anchors) == 2


def test_the_event_pool_does_not_grow(events):
    stages = DeviceStages("cuda")
    anchors = _Event.made
    _serve(stages, [0.01] * 200)
    assert len(stages.requests) == 200
    # four for the first request, one more for the gap's kept event; the
    # other 199 reuse them (and finish's anchor makes its own)
    assert _Event.made - 2 * anchors == 5
    assert len(stages._free) == 4 and not stages._pending


def test_requests_under_a_profiler_are_tagged_and_left_out(events):
    """A request made while a profiler records is tagged `profiled` in the
    raw record, so that a reader can leave it and the gaps beside it out;
    the requests around it read as they would without it."""
    from torch.profiler import ProfilerActivity, profile
    stages = DeviceStages("cuda")
    _serve(stages, [1.0, 0.2])
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(stages, [2.0])
    _serve(stages, [1.5, 0.4])
    assert [r["profiled"] for r in stages.requests] == \
        [False, False, True, False, False]
    kept = [r for r in stages.requests if not r["profiled"]]
    assert [r["gap_ms"] for r in kept] == \
        [None, pytest.approx(0.2), pytest.approx(1.5), pytest.approx(0.4)]
    assert all(r["replay_ms"] == pytest.approx(3.0) for r in kept)


def test_gap_arithmetic_on_synthetic_event_times(events):
    """The gap before a request runs from the previous request's last event
    to its first; `at_ms` places each request's first event on the device
    clock after the reference event; `mark_ns` − `enter_ns` is the host's
    time in run_raw before that first event, the part of the gap a reader
    gives to run_raw."""
    stages = DeviceStages("cuda")
    start = _Clock.now
    _serve(stages, [5.0, 0.2, 0.05], copy=0.1, replay=2.8, clone=0.1,
           prelude_ns=40_000)
    rs = stages.requests
    assert [r["gap_ms"] for r in rs] == \
        [None, pytest.approx(0.2), pytest.approx(0.05)]
    assert [r["at_ms"] for r in rs] == \
        [pytest.approx(start + x) for x in (5.0, 8.2, 11.25)]
    assert all(r["at_ms"] + r["copy_in_ms"] + r["replay_ms"] +
               r["clone_out_ms"] + nxt["gap_ms"] == pytest.approx(nxt["at_ms"])
               for r, nxt in zip(rs, rs[1:]))
    assert all(r["mark_ns"] - r["enter_ns"] >= 40_000 for r in rs)
    # what a request that raised had recorded is forgotten, its events
    # pooled again
    ev, stream = stages.start(9, time.perf_counter_ns())
    stages.drop(ev)
    stages.finish()
    assert len(stages.requests) == 3 and not stages._pending


def test_the_cli_times_its_phases_from_its_spans():
    """run_benchmark's four timings are its phases' spans in the recorder
    it is given, which --profile writes out: one recorder, one timing."""
    from abc_tpu_torch import cli
    rec = SpanRecorder()
    best = cli.run_benchmark("hamming", "dummy", slots=64, runs=3,
                             tracer=rec)
    phases = ["keygen", "input_encryption", "computation", "decryption"]
    top = [s for s in rec.read()["spans"] if s["parent"] is None]
    assert [s["name"] for s in top] == phases * 3
    runs = [{s["name"]: (s["end_ns"] - s["start_ns"]) / 1e6
             for s in top[i:i + 4]} for i in range(0, 12, 4)]
    chosen = min(runs, key=lambda r: r["computation"])
    assert {k: best["t_" + k] for k in phases} == \
        pytest.approx(chosen, abs=0)


def test_chrome_trace_is_one_timeline_of_spans_and_stages(events, tmp_path):
    rec = SpanRecorder()
    rec.stages = DeviceStages("cuda")
    with rec.span("run_raw", request=True):
        pass
    _serve(rec.stages, [0.0, 0.5])
    got = rec.chrome_trace(str(tmp_path / "spans.json"))
    trace = json.loads((tmp_path / "spans.json").read_text())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs if e["pid"] == 0] == ["run_raw"]
    stages = [e for e in xs if e["pid"] == 1]
    assert [e["name"] for e in stages] == ["copy_in", "replay",
                                           "clone_out"] * 2
    ts = [e["ts"] for e in stages]
    assert ts == sorted(ts) and min(e["ts"] for e in xs) == 0
    # the anchors map device time onto the host's linearly: the second
    # request starts its gap (0.5 ms) after the first one's 3.15 ms end
    first = stages[2]["ts"] + stages[2]["dur"] - stages[0]["ts"]
    assert (stages[3]["ts"] - stages[0]["ts"]) / first == \
        pytest.approx(3.65 / 3.15, rel=1e-3)
    # one at the start, one when _serve finished, one when read
    assert trace["anchors"] == got["anchors"] and len(got["anchors"]) == 3


def test_profiling_factory_times_completed_work_on_a_card(monkeypatch):
    from types import SimpleNamespace

    from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
    from abc_tpu_torch.utils.profiling import ProfilingFactory
    drains = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: drains.append(device))
    inner = DummyCiphertextFactory(16)
    inner.context = SimpleNamespace(device=torch.device("cuda", 0))
    factory = ProfilingFactory(inner)
    a = factory.create_ciphertext([1, 2])
    a.add(a)
    factory.decrypt(a)
    assert len(drains) == 6 and set(drains) == {torch.device("cuda", 0)}
    assert ProfilingFactory(DummyCiphertextFactory(16))._device is None


# ---------------------------------------------------------------- the card

@pytest.mark.gpu
def test_device_stages_of_a_replay_on_the_card(cuda, tmp_path):
    jp = _program(device=cuda)
    rows = jp.tracer.read()["spans"]
    warmup = next(s for s in rows if s["name"] == "warmup")
    made = [s for s in rows if s["name"] == "host_constant"]
    assert len(made) == len(jp._tape.items) >= 2
    assert all(s["parent"] == warmup["id"] for s in made)
    jp.trace_requests(True)
    stages = jp.tracer.stages
    fresh = jp.encrypt_inputs({"x": [2, 2, 2]})
    want = jp.run_eager(fresh)["out"]
    for _ in range(200):
        out = jp.run_raw(fresh)
    assert torch.equal(out["out"], want)
    pooled = len(stages._free) + 4 * len(stages._pending) + 1
    assert pooled <= 12
    got = jp.tracer.chrome_trace(str(tmp_path / "spans.json"))
    assert len(got["requests"]) == 200
    for r in got["requests"]:
        assert r["copy_in_ms"] > 0 and r["replay_ms"] > 0 and \
            r["clone_out_ms"] > 0
        assert r["gap_ms"] is None or r["gap_ms"] >= 0
    assert not any(r["profiled"] for r in got["requests"])
    at = [r["at_ms"] for r in got["requests"]]
    assert at == sorted(at)
    assert len(got["anchors"]) == 2
    assert all(a["uncertainty_ns"] < 1e6 for a in got["anchors"])
