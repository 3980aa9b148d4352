"""The package's one timer: two-point chain differencing.

A chain of c dependent steps is run at two lengths, c and c // 2, and the
per-step time is the difference of the two over c // 2. What does not grow
with the chain cancels: on a CUDA device the launch of the graph and the
events around it, on the host the call itself (`fixed` is what cancelled).

On a CUDA tensor a chain is captured once in a CUDA graph and its replays
are timed between CUDA events; a replay runs no Python, so the host cannot
hold the device back. On a CPU tensor the chain runs eagerly under the host
clock (`timer_of` says which of the two a tensor gets; results carry it as
"timer"). That is the caller's choice of device, never a fallback: nothing
here moves a tensor.

`estimates` is the protocol of the measurement entry points (bench.py,
benchsuite.py, scripts/hybrid_ks_ab.py, scripts/ntt_ablation.py --batched):
the median of k_est independent two-point estimates with their least and
largest. One time is the least of REPEATS runs inside one estimate; the
spread is over the estimates. A pair that comes out inverted or empty
(t(c) <= t(c // 2)) is discarded and measured again, up to 3 * k_est pairs;
where none is valid the result is nan, never a clamped value.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Callable, Tuple

import torch

REPEATS = 3
NAN4 = (float("nan"),) * 4


def chain_of(step: Callable, c: int) -> Callable:
    """x -> step(step(... step(x))), c times."""
    def run(x):
        v = x
        for _ in range(c):
            v = step(v)
        return v
    return run


def timer_of(x: torch.Tensor) -> str:
    """"cuda_graph" for a CUDA tensor, "host" for a CPU tensor."""
    return "cuda_graph" if x.is_cuda else "host"


@contextlib.contextmanager
def capture_graph(graph: "torch.cuda.CUDAGraph", **kwargs):
    """torch.cuda.graph(graph, **kwargs) with Python's cyclic collector held
    off until the capture ends. A CUDA graph that only a reference cycle
    still holds (a program of an earlier run) is destroyed when the
    collector finds it, and what its destructor (CUDAGraph::reset) calls
    is not permitted while a stream captures: the capture in progress is
    invalidated ("operation not permitted when stream is capturing", then
    "operation failed due to a previous error during capture" at the next
    launch). Such garbage is freed at the next collection after the
    capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield graph
    finally:
        if enabled:
            gc.enable()


def graph_of(run: Callable, x0: torch.Tensor) -> "torch.cuda.CUDAGraph":
    """run(x0) captured in a CUDA graph (default error mode: a host
    synchronisation or a host-to-device copy inside `run` raises), with
    `output` the tensor a replay writes.

    A replay reads whatever device memory the capture read: x0, and the
    tensors `run` reaches (a context's keys and tables, a second operand).
    So the graph holds x0 and `run` for as long as it lives. A graph whose
    input was freed replays into memory that the next capture frees with
    cudaFree (`torch.cuda.graph` empties the allocator's cache as it
    starts): a segmentation fault in cudaGraphLaunch, an illegal address or
    wrong words.

    The graph keeps its cudaGraph_t (keep_graph) beside the instantiated
    one, so that its nodes can be read back (CUDAGraph.debug_dump)."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with capture_graph(g):
        g.output = run(x0)
    g.instantiate()
    g.held = (run, x0)
    return g


def replay_s(g) -> float:
    """Least time of one replay of g in seconds, between CUDA events."""
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def host_s(run: Callable, x0) -> float:
    """Least time of one run(x0) in seconds on the host clock."""
    run(x0)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run(x0)
        best = min(best, time.perf_counter() - t0)
    return best


def chain_timers(make_chain: Callable, x0: torch.Tensor, chain: int):
    """(time of the full chain, time of the half chain) as two callables
    that each measure once more when called: what `estimates` calls in
    pairs, and what an A/B of two variants calls in turns."""
    full, half = make_chain(chain), make_chain(chain // 2)
    if timer_of(x0) == "host":
        return (lambda: host_s(full, x0)), (lambda: host_s(half, x0))
    # the warm-up builds the kernels, opts into large shared memory and
    # fills lazily built tables outside the capture
    make_chain(1)(x0)
    torch.cuda.synchronize()
    g_full, g_half = graph_of(full, x0), graph_of(half, x0)
    return (lambda: replay_s(g_full)), (lambda: replay_s(g_half))


def timed_per_iter(step: Callable, x0: torch.Tensor, chain: int
                   ) -> Tuple[float, float]:
    """One two-point estimate of x -> step(x): (seconds per step, fixed
    seconds per run), unchecked (an inverted pair gives a negative time)."""
    t_full, t_half = (m() for m in chain_timers(
        lambda c: chain_of(step, c), x0, chain))
    return (t_full - t_half) / (chain // 2), 2 * t_half - t_full


def estimates(make_chain: Callable, x0: torch.Tensor, chain: int,
              k_est: int = 5) -> Tuple[float, float, float, float]:
    """(median, least, largest, fixed) seconds per step over k_est valid
    two-point estimates of the chains make_chain(chain) and make_chain(chain
    // 2), each a callable of x0 (`chain_of(step, c)` for a plain step).
    `fixed` is the median of what cancelled in the pairs. All four are nan
    where 3 * k_est pairs gave no valid estimate."""
    if chain < 2:
        raise ValueError(f"a two-point estimate needs chain >= 2, got {chain}")
    return summary(valid_pairs(chain_timers(make_chain, x0, chain), chain,
                               k_est))


def valid_pairs(timers, chain: int, k_est: int, attempts: int = 0):
    """Up to k_est valid two-point pairs from (t_full, t_half) timers, as
    [(seconds per step, fixed seconds)], in at most `attempts` (3 * k_est)
    measurements: an inverted or empty pair is left out."""
    t_full, t_half = timers
    pairs = []
    for _ in range(attempts or 3 * k_est):
        if len(pairs) == k_est:
            break
        full, half = t_full(), t_half()
        if full > half:
            pairs.append(((full - half) / (chain // 2), 2 * half - full))
    return pairs


def summary(pairs) -> Tuple[float, float, float, float]:
    """(median, least, largest, median fixed) of valid_pairs' result; all
    nan where there is none."""
    if not pairs:
        return NAN4
    per = [p for p, _ in pairs]
    return (statistics.median(per), min(per), max(per),
            statistics.median(f for _, f in pairs))


def repeated(fn: Callable, repeats: int, device) -> Tuple[float, float,
                                                           float]:
    """(median, least, largest) seconds of one fn() over `repeats` calls
    after a warm-up call: between CUDA events on a CUDA device (device time
    plus whatever host time fn adds between them), on the host clock on the
    CPU."""
    on_card = torch.device(device).type == "cuda"
    fn()
    times = []
    for _ in range(repeats):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


# a read of five times the H100's 50 MB L2 before a timed call leaves none
# of that call's operands in it: a "cold" reading, against the DRAM bound
L2_FLUSH_BYTES = 256 << 20
_l2 = {}


def l2_flush() -> None:
    """Read L2_FLUSH_BYTES on the current CUDA device (one float sum)."""
    if "buf" not in _l2:
        _l2["buf"] = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    _l2["buf"].sum()
