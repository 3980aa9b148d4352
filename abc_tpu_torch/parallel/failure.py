"""Failure detection for multi-process runs: barrier + watchdog + clean abort
(port of abc_tpu/parallel/failure.py).

  * deadline(seconds): SIGALRM-based watchdog around a host-side block — a
    wedged collective raises DeadlineExceeded in the main thread instead of
    hanging the job forever.
  * barrier(timeout, mesh): a rendezvous of every shard (one sum of ones
    over the mesh, or over the torch.distributed world), guarded by
    deadline(): a dead or partitioned rank shows as a timeout rather than an
    indefinite stall. Returns how many answered.
  * abort(reason): structured clean shutdown (flush + exit code 42) so a
    fleet supervisor can tell FHE-runtime aborts from crashes.
"""

from __future__ import annotations

import os
import signal
import sys
from contextlib import contextmanager


class DeadlineExceeded(RuntimeError):
    pass


@contextmanager
def deadline(seconds: float):
    """Raise DeadlineExceeded in the main thread if the block runs longer
    than `seconds` (POSIX SIGALRM; no-op where unavailable)."""
    if not hasattr(signal, "SIGALRM"):  # pragma: no cover (non-POSIX)
        yield
        return

    def _handler(signum, frame):
        raise DeadlineExceeded(f"deadline of {seconds}s exceeded")

    old = signal.signal(signal.SIGALRM, _handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def barrier(timeout: float = 60.0, mesh=None) -> int:
    """All-shards rendezvous: returns the number of shards of `mesh` that
    answered, or without a mesh the number of ranks of the initialised
    torch.distributed world. Every shard must contribute, so a missing rank
    turns into DeadlineExceeded instead of a silent hang."""
    import torch.distributed as dist

    with deadline(timeout):
        if mesh is not None:
            want, got = mesh.size, mesh.world_count()
        else:
            if not dist.is_initialized():
                raise RuntimeError("barrier() without a mesh needs "
                                   "torch.distributed initialised")
            import torch
            from abc_tpu_torch.parallel.mesh import rank_device
            one = torch.ones(1, dtype=torch.int64, device=rank_device())
            dist.all_reduce(one)
            want, got = dist.get_world_size(), int(one.item())
        if got != want:  # pragma: no cover (defensive)
            abort(f"barrier saw {got} of {want} shards")
        return got


def abort(reason: str, code: int = 42) -> None:
    """Clean structured abort: flush, report, exit with a recognizable
    code (the fleet supervisor's signal that this was a deliberate FHE
    runtime abort, not a crash)."""
    print(f"[abc_tpu_torch] ABORT: {reason}", file=sys.stderr, flush=True)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)
