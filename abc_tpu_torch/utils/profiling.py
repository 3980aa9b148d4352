"""Profiling & observability.

Reference status (SURVEY.md §5): no in-library tracing — timing exists only
as the benchmark CSV schema, and pass decisions are opaque. Here:

  * SpanRecorder — the program's spans. A span is a name, a start and an end
    on time.perf_counter_ns(), the id of its parent span, the id of its
    request (the spans of one request share it; 0 is the set-up) and a few
    attributes. Spans stay in memory until read. A JittedProgram owns one
    (`jp.tracer`): its set-up phases always (`phase_ms` is their view), its
    requests once `jp.trace_requests(True)`. Code below the program (key
    builds, Galois tables, the encryption's draws, host-made constants)
    records into the recorder activated in its thread through `span()`,
    and records nothing where none is. The recorder keeps and exports raw
    records (`read`, `chrome_trace`); what a metric makes of them is its
    reader's.
  * DeviceStages — four timing CUDA events around each replay of a request
    (copy in, replay, clone out), resolved into device durations and the
    stream's idle time before each request, and anchored to the host clock,
    so that `SpanRecorder.chrome_trace` writes host spans and device stages
    on one timeline.
  * ProfilingFactory — wraps any AbstractCiphertextFactory and records every
    homomorphic op (count + time), the FHE analogue of a per-op profiler;
    report() gives the breakdown the reference's getAuxiliaryInformation
    stub gestured at.
  * device_trace — torch.profiler's trace of a block, with the spans
    recorded in it beside it.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext

SETUP = 0          # the request id of spans outside any request
FIELDS = ("name", "start_ns", "end_ns", "parent", "request", "attrs")


def profiler_active() -> bool:
    """Whether a torch.profiler (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


class _Nothing:
    """The span of no recorder and the range of no profiler."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOTHING = _Nothing()


def profiler_range(name: str):
    """A torch.profiler record_function range of `name` while a profiler
    records, else nothing: the one way the program's spans and its chain
    ranges (ops/modarith.chain_range) reach a profile, on its clock."""
    if profiler_active():
        return torch.profiler.record_function(name)
    return _NOTHING


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "abc_tpu_torch_span_recorder", default=None)


def span(name: str, **attrs):
    """A span of `name` in the recorder activated in this thread
    (SpanRecorder.activated), else nothing."""
    rec = _ACTIVE.get()
    return _NOTHING if rec is None else rec.span(name, **attrs)


def nbytes(value) -> int:
    """Bytes of the tensors and arrays a value holds (a tensor, an array, a
    dataclass such as a plaintext or a ciphertext, or a list of them)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (list, tuple)):
        return sum(nbytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(nbytes(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return 0


class _Span:
    """One span while it is open: `with rec.span(name) as s: ...;
    s.set(bytes=n)`."""

    __slots__ = ("rec", "row", "new_request", "range", "drains")

    def __init__(self, rec: "SpanRecorder", name: str, request: bool,
                 attrs: dict):
        self.rec = rec
        self.row = [name, 0, None, None, SETUP, attrs or None]
        self.new_request = request

    @property
    def request_id(self) -> int:
        return self.row[4]

    @property
    def start_ns(self) -> int:
        return self.row[1]

    @property
    def ms(self) -> float:
        """Its length, once closed."""
        return (self.row[2] - self.row[1]) / 1e6

    def set(self, **attrs) -> None:
        self.row[5] = {**(self.row[5] or {}), **attrs}

    def __enter__(self):
        rec, row = self.rec, self.row
        stack = rec._open
        if stack:
            row[3] = stack[-1]
            row[4] = rec.spans[stack[-1]][4]
        if self.new_request:
            rec._requests += 1
            row[4] = rec._requests
        self.drains = rec.sync is not None and row[3] is None and \
            row[4] == SETUP
        if self.drains:
            rec.sync()
        self.range = profiler_range(row[0])
        self.range.__enter__()
        stack.append(len(rec.spans))
        rec.spans.append(row)
        row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if self.drains:
            rec.sync()
        self.row[2] = time.perf_counter_ns()
        rec._open.pop()
        self.range.__exit__(*exc)
        return False


class SpanRecorder:
    """The spans of one program (module note). Each is kept as a row
    [name, start_ns, end_ns, parent, request, attrs]; its id is its index
    in `spans`. sync: drains the device; called at both ends of every
    set-up phase (a top-level span of request 0), so that a phase times
    completed work, as phase_ms always has. A span inside a phase and a
    request span time the host (what it did and enqueued) and never
    wait."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.spans: List[list] = []
        self.stages: Optional[DeviceStages] = None
        self._open: List[int] = []
        self._requests = SETUP
        self._phase: Optional[_Span] = None

    def span(self, name: str, request: bool = False, **attrs) -> _Span:
        """A span, child of the innermost open one; `request`: the first
        span of a new request, which its children share."""
        return _Span(self, name, request, attrs)

    def phase(self, name: Optional[str]) -> None:
        """Close the open set-up phase, if any, and open `name` (None:
        none) in its place: the set-up's phases follow one another as
        phase_ms has them."""
        if self._phase is not None:
            self._phase.__exit__(None, None, None)
            self._phase = None
        if name is not None:
            self._phase = self.span(name)
            self._phase.__enter__()

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        """A set-up span timed by its caller."""
        self.spans.append([name, start_ns, end_ns, None, SETUP, None])

    @contextmanager
    def activated(self):
        """Within it, `span()` records here (in this thread)."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def phase_ms(self) -> Dict[str, float]:
        """{phase: ms} summed over the closed top-level set-up spans."""
        out: Dict[str, float] = {}
        for name, start, end, parent, request, _ in self.spans:
            if parent is None and request == SETUP and end is not None:
                out[name] = out.get(name, 0.0) + (end - start) / 1e6
        return out

    def read(self) -> Dict:
        """Everything recorded: `spans` as dicts with their `id`, and, where
        device stages were recorded, `requests` (DeviceStages.requests)
        and `anchors` (DeviceStages.anchors), resolved and anchored anew."""
        out = {"spans": [dict(zip(FIELDS, row), id=i)
                         for i, row in enumerate(self.spans)],
               "requests": [], "anchors": []}
        if self.stages is not None:
            self.stages.finish()
            out["requests"] = list(self.stages.requests)
            out["anchors"] = list(self.stages.anchors)
        return out

    def chrome_trace(self, path: str) -> Dict:
        """Write the host spans and the device stages on one timeline (the
        host's perf_counter, µs from the first record) in Chrome trace
        format (Perfetto, chrome://tracing); returns what was read."""
        rec = self.read()
        to_host = anchored(rec["anchors"])
        stages = []
        for r in rec["requests"]:
            at = r["at_ms"]
            for stage in STAGES:
                end = at + r[stage + "_ms"]
                stages.append((stage, to_host(at), to_host(end), r))
                at = end
        starts = [s["start_ns"] for s in rec["spans"]] + \
            [start for _, start, _, _ in stages]
        origin = min(starts) if starts else 0
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": name}}
                  for pid, name in ((0, "host spans"),
                                    (1, "device stages"))]
        for s in rec["spans"]:
            if s["end_ns"] is None:
                continue
            events.append({
                "ph": "X", "name": s["name"], "pid": 0,
                "tid": 0 if s["request"] == SETUP else 1,
                "ts": (s["start_ns"] - origin) / 1e3,
                "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                "args": {"id": s["id"], "parent": s["parent"],
                         "request": s["request"], **(s["attrs"] or {})}})
        for stage, start, end, r in stages:
            events.append({
                "ph": "X", "name": stage, "pid": 1, "tid": 0,
                "ts": (start - origin) / 1e3, "dur": (end - start) / 1e3,
                "args": {"request": r["request"], "profiled": r["profiled"],
                         "gap_ms": r["gap_ms"]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "anchors": rec["anchors"]}, f)
        return rec


# ------------------------------------------------------------ device stages

STAGES = ("copy_in", "replay", "clone_out")


class DeviceStages:
    """Timing CUDA events on the program's stream, four a request: before
    the copies in, before the replay, after it, after the clones out.
    `start` takes them from a pool and records the first one, `end` the
    last. A request's events are resolved once its last one is reached
    (queried at each `end`, after the request's own last record, so that
    the host resolves while the device works, and at `finish`) into the
    three durations and the stream's idle time since the previous
    request's last event (`gap_ms`), then go back to the pool: the
    recorder keeps numbers, not live events.

    requests: per resolved request, its `request` id, `profiled` (a
    torch.profiler was recording: CUPTI's stall on a launch is not the
    program's), `enter_ns` (the host entered run_raw), `mark_ns` (the host
    recorded its first event), `at_ms` (that event's device time after the
    anchors' reference event), `copy_in_ms`, `replay_ms`, `clone_out_ms` and
    `gap_ms` (None for the first). anchors: `anchor()`'s readings."""

    def __init__(self, device):
        self.device = device
        self.requests: List[Dict] = []
        self.anchors: List[Dict] = []
        self._free: list = []
        self._pending: deque = deque()
        self._last = None
        self._ref = None
        self.anchor()

    def _event(self):
        return self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)

    def start(self, request: int, enter_ns: int):
        """(four events for one request, the stream they go on), the first
        recorded now on the current stream."""
        events = [self._event() for _ in range(4)]
        stream = torch.cuda.current_stream(self.device)
        profiled = profiler_active()
        mark = time.perf_counter_ns()
        events[0].record(stream)
        self._pending.append((request, profiled, enter_ns, mark, events))
        return events, stream

    def end(self, events: list, stream) -> None:
        """Record a request's last event, then resolve what was reached."""
        events[3].record(stream)
        self.resolve()

    def drop(self, events: list) -> None:
        """Forget the request whose events these are (its run raised)."""
        self._pending = deque(p for p in self._pending if p[4] is not events)
        self._free.extend(events)

    def resolve(self) -> None:
        """Resolve the pending requests whose last event was reached."""
        pending = self._pending
        while pending and pending[0][4][3].query():
            request, profiled, enter, mark, ev = pending.popleft()
            last = self._last
            self.requests.append({
                "request": request, "profiled": profiled, "enter_ns": enter,
                "mark_ns": mark, "at_ms": self._ref.elapsed_time(ev[0]),
                "copy_in_ms": ev[0].elapsed_time(ev[1]),
                "replay_ms": ev[1].elapsed_time(ev[2]),
                "clone_out_ms": ev[2].elapsed_time(ev[3]),
                "gap_ms": None if last is None else last.elapsed_time(ev[0])})
            if last is not None:
                self._free.append(last)
            self._free.extend(ev[:3])
            self._last = ev[3]

    def finish(self) -> None:
        """Wait for the device, resolve every request, anchor again."""
        torch.cuda.synchronize(self.device)
        self.resolve()
        self.anchor()

    def anchor(self, tries: int = 16) -> Dict:
        """Pin the events' clock to perf_counter_ns: on the idle stream an
        event is recorded right after a host stamp and waited for, `tries`
        times, and the pair with the shortest host window is kept. The
        first event ever recorded here is the reference the device times
        count from. `host_ns`: the host time at which the reference was
        reached; `uncertainty_ns`: half the kept pair's host window (the
        record's own latency, a few µs, is a bias common to every
        reading, so it leaves the drift between two anchors)."""
        torch.cuda.synchronize(self.device)
        stream = torch.cuda.current_stream(self.device)
        best = None
        for _ in range(tries):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            t1 = time.perf_counter_ns()
            ev.synchronize()
            if self._ref is None:
                self._ref = ev
            dev_ms = self._ref.elapsed_time(ev)
            pair = (t1 - t0, (t0 + t1) / 2 - dev_ms * 1e6, dev_ms)
            best = pair if best is None or pair[0] < best[0] else best
        reading = {"host_ns": best[1], "uncertainty_ns": best[0] / 2,
                   "dev_ms": best[2]}
        self.anchors.append(reading)
        return reading


def anchored(anchors: List[Dict]) -> Callable[[float], float]:
    """at_ms (device ms after the reference event) → host perf_counter ns,
    drawn straight between the first anchor and the last (the drift
    spread over the device time between them)."""
    if not anchors:
        return lambda at_ms: at_ms * 1e6
    a, b = anchors[0], anchors[-1]
    span_ms = b["dev_ms"] - a["dev_ms"]
    slope = (b["host_ns"] - a["host_ns"]) / span_ms if span_ms > 0 else 0.0
    return lambda at_ms: a["host_ns"] + at_ms * 1e6 + \
        slope * (at_ms - a["dev_ms"])


# ---------------------------------------------------------- per-op profiles

class OpRecorder:
    def __init__(self) -> None:
        self.counts: Dict[str, int] = defaultdict(int)
        self.times: Dict[str, float] = defaultdict(float)

    def record(self, op: str, seconds: float) -> None:
        self.counts[op] += 1
        self.times[op] += seconds

    def report(self) -> List[dict]:
        return sorted(
            ({"op": op, "count": self.counts[op],
              "total_ms": round(self.times[op] * 1e3, 3)}
             for op in self.counts),
            key=lambda r: -r["total_ms"])


_PROFILED_OPS = ("add", "subtract", "multiply", "add_plain", "subtract_plain",
                 "subtract_from_plain", "multiply_plain", "rotate_rows")


class _ProfiledCiphertext(AbstractCiphertext):
    """Delegating ciphertext recording each op's time."""

    __slots__ = ("inner", "rec", "factory")

    def __init__(self, inner: AbstractCiphertext, rec: OpRecorder, factory):
        self.inner = inner
        self.rec = rec
        self.factory = factory

    def _wrap(self, ct):
        return _ProfiledCiphertext(ct, self.rec, self.factory)

    def clone(self):
        return self._wrap(self.inner.clone())

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _make_op(name):
    def op(self, *args):
        args = tuple(a.inner if isinstance(a, _ProfiledCiphertext) else a
                     for a in args)
        t0 = self.factory.clock()
        out = getattr(self.inner, name)(*args)
        self.rec.record(name, self.factory.clock() - t0)
        return self._wrap(out)
    return op


for _op in _PROFILED_OPS:
    setattr(_ProfiledCiphertext, _op, _make_op(_op))


class ProfilingFactory(AbstractCiphertextFactory):
    """Wrap a factory so every homomorphic op is timed and counted. An op's
    milliseconds are completed work: on a factory whose context evaluates
    on a CUDA device, the device is drained at both stamps of each op (so
    the ops run one at a time, as the wrapper times them); elsewhere they
    are host time."""

    def __init__(self, inner: AbstractCiphertextFactory):
        self.inner = inner
        self.recorder = OpRecorder()
        device = getattr(getattr(inner, "context", None), "device", None)
        self._device = device if device is not None and \
            torch.device(device).type == "cuda" else None

    def clock(self) -> float:
        """perf_counter seconds, the device drained first (class note)."""
        if self._device is not None:
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    @property
    def slot_count(self) -> int:
        return self.inner.slot_count

    def create_ciphertext(self, value):
        t0 = self.clock()
        ct = self.inner.create_ciphertext(value)
        self.recorder.record("encrypt", self.clock() - t0)
        return _ProfiledCiphertext(ct, self.recorder, self)

    def decrypt(self, ciphertext):
        inner_ct = ciphertext.inner if isinstance(ciphertext,
                                                  _ProfiledCiphertext) \
            else ciphertext
        t0 = self.clock()
        out = self.inner.decrypt(inner_ct)
        self.recorder.record("decrypt", self.clock() - t0)
        return out

    def report(self) -> List[dict]:
        return self.recorder.report()


# ------------------------------------------------------------- device traces

@contextmanager
def device_trace(logdir: str, tracer: Optional[SpanRecorder] = None):
    """torch.profiler trace around a block: the host and CUDA timeline, written
    to `logdir`/trace.json in Chrome trace format (view with Perfetto or
    chrome://tracing). With `tracer`, the block runs with it activated and
    its spans are written beside, to `logdir`/spans.json
    (SpanRecorder.chrome_trace; inside trace.json they are record_function
    ranges on the profiler's clock).

    Usage:
        with device_trace("fhe-trace"):
            program.run_raw(inputs)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        if tracer is None:
            yield
        else:
            with tracer.activated():
                yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if tracer is not None:
        tracer.chrome_trace(os.path.join(logdir, "spans.json"))
