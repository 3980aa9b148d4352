"""The closed loop of clients: each request is one `run_raw` of the
captured program (copies into the graph's inputs, one replay, clones of
its outputs), up to `in_flight` dispatched ahead on the device's stream;
each completion is stamped on the host clock when its CUDA event is
reached. A client encrypts, sends and waits for the encrypted reply, so the
next request of a client leaves when a reply arrives."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


@dataclass
class Window:
    """What one window served: per request its pool entry, submission and
    completion times (host clock, s); the outputs kept for the check by
    request index."""
    start: float
    end: float
    pool_of: List[int] = field(default_factory=list)
    submitted: List[float] = field(default_factory=list)
    done: List[Optional[float]] = field(default_factory=list)
    kept: Dict[int, object] = field(default_factory=dict)
    failed: int = 0
    error: str = ""

    def completed_in_window(self) -> List[int]:
        return [i for i, t in enumerate(self.done)
                if t is not None and t <= self.end]

    def latencies_s(self) -> List[float]:
        return [self.done[i] - self.submitted[i]
                for i in self.completed_in_window()]


def serve(run_raw: Callable, pool: List[Dict], seconds: float,
          in_flight: int, device: torch.device, keep=frozenset(),
          on_request: Optional[Callable[[int], None]] = None,
          max_requests: Optional[int] = None) -> Window:
    """Serve the pool round and round for `seconds`: request i sends pool
    entry i mod len(pool). Requests whose index is in `keep` keep their
    outputs. on_request(i) runs before request i is sent (the traced
    slice's start and stop). A request that raises counts as failed and
    ends the window. max_requests: stop sending after that many (the
    warm-up pass)."""
    on_card = device.type == "cuda"
    pending = deque()
    clock = time.perf_counter
    w = Window(start=clock(), end=0.0)
    w.end = w.start + seconds
    i = 0
    while True:
        while (len(pending) < in_flight and clock() < w.end
               and not w.failed and (max_requests is None
                                     or i < max_requests)):
            if on_request is not None:
                on_request(i)
            p = i % len(pool)
            t_sub = clock()
            try:
                out = run_raw(pool[p])
            except Exception as exc:   # recorded and reported, never hidden
                w.failed += 1
                w.error = f"{type(exc).__name__}: {exc}"
                break
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            w.pool_of.append(p)
            w.submitted.append(t_sub)
            w.done.append(None)
            pending.append((i, event, out if i in keep else None))
            i += 1
        if not pending:
            return w
        j, event, out = pending.popleft()
        if event is not None:
            event.synchronize()
        w.done[j] = clock()
        if out is not None:
            w.kept[j] = out
