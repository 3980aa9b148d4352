"""Profiling & observability.

Reference status (SURVEY.md §5): no in-library tracing — timing exists only
as the benchmark CSV schema, and pass decisions are opaque. Here:

  * PhaseTimer — named wall-clock phases (keygen/encrypt/compute/decrypt)
  * ProfilingFactory — wraps any AbstractCiphertextFactory and records every
    homomorphic op (count + wall time), the FHE analogue of a per-op
    profiler; report() gives the breakdown the reference's
    getAuxiliaryInformation stub gestured at
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext


class PhaseTimer:
    """Accumulates named wall-clock phases."""

    def __init__(self) -> None:
        self.phases: Dict[str, float] = defaultdict(float)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] += time.perf_counter() - t0

    def as_millis(self) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in self.phases.items()}


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
    """Delegating ciphertext recording each op's wall time."""

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
        t0 = time.perf_counter()
        out = getattr(self.inner, name)(*args)
        self.rec.record(name, time.perf_counter() - t0)
        return self._wrap(out)
    return op


for _op in _PROFILED_OPS:
    setattr(_ProfiledCiphertext, _op, _make_op(_op))


class ProfilingFactory(AbstractCiphertextFactory):
    """Wrap a factory so every homomorphic op is timed and counted."""

    def __init__(self, inner: AbstractCiphertextFactory):
        self.inner = inner
        self.recorder = OpRecorder()

    @property
    def slot_count(self) -> int:
        return self.inner.slot_count

    def create_ciphertext(self, value):
        t0 = time.perf_counter()
        ct = self.inner.create_ciphertext(value)
        self.recorder.record("encrypt", time.perf_counter() - t0)
        return _ProfiledCiphertext(ct, self.recorder, self)

    def decrypt(self, ciphertext):
        inner_ct = ciphertext.inner if isinstance(ciphertext,
                                                  _ProfiledCiphertext) \
            else ciphertext
        t0 = time.perf_counter()
        out = self.inner.decrypt(inner_ct)
        self.recorder.record("decrypt", time.perf_counter() - t0)
        return out

    def report(self) -> List[dict]:
        return self.recorder.report()


# ------------------------------------------------------------- device traces

@contextmanager
def device_trace(logdir: str):
    """torch.profiler trace around a block: the host and CUDA timeline, written
    to `logdir`/trace.json in Chrome trace format (view with Perfetto or
    chrome://tracing). Complements the host-side PhaseTimer.

    Usage:
        with device_trace("fhe-trace"):
            program.run_raw(inputs)
            torch.cuda.synchronize()
    """
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
