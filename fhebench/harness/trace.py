"""The traced slice: torch.profiler over a bounded run of requests in the
middle of the window, reduced to what the per-layer metrics read: the
device's busy time and the slice's length, the mean device time of each
kernel family, the device operations that took most time, and the longest
idle gaps named by what the host was doing. A slice whose profile holds no
kernel record (the profiler now and then returns none) is taken again
later in the window; where none comes, the device metrics are not
measured."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

TOP = 10


def family(name: str, bases: Iterable[str]) -> str:
    """The longest of `bases` that kernel `name` holds, or the name cut at
    its argument list (a library or torch kernel)."""
    found = [b for b in bases if b in name]
    if found:
        return max(found, key=len)
    return name.split("(")[0].replace("void ", "")[:80]


def _merge(spans: List[List[float]]) -> List[List[float]]:
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_profile(events, bases: Iterable[str]) -> Optional[Dict]:
    """The slice's numbers from torch.profiler's events (times in us), or
    None where it holds no kernel record."""
    device = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in events:
        span = (ev.time_range.start, ev.time_range.end)
        (dev if ev.device_type == device else host).append((ev.name, *span))
    kernels = [d for d in dev if "memcpy" not in d[0].lower()
               and "memset" not in d[0].lower()]
    if not kernels:
        return None
    bases = list(bases)
    merged = _merge([[s, e] for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    window = merged[-1][1] - merged[0][0]
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for name, s, e in kernels:
        fam = family(name, bases)
        total[fam] = total.get(fam, 0.0) + (e - s)
        count[fam] = count.get(fam, 0) + 1
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        covering = [h for h in host if h[1] <= mid <= h[2]]
        what = (min(covering, key=lambda h: h[2] - h[1])[0] if covering
                else "host: no operation recorded")
        gaps.append([what, (s1 - e0) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([fam, t * 1e-6] for fam, t in total.items()),
                 key=lambda o: -o[1])
    return {"busy_s": busy * 1e-6, "window_s": window * 1e-6,
            "mean_s": {fam: total[fam] / count[fam] * 1e-6
                       for fam in total},
            "records": len(kernels), "device_ops": ops[:TOP],
            "idle_gaps": gaps[:TOP]}


class Slice:
    """Profiles requests [first, first + count) of a window: called before
    each request is sent (serve's on_request). Retries, `count` requests
    later, up to `tries` slices, while a profile holds no kernel."""

    def __init__(self, first: int, count: int, bases, tries: int = 4):
        self.first, self.count, self.tries = first, count, tries
        self.bases = list(bases)
        self.prof = None
        self.result: Optional[Dict] = None
        self.taken = 0

    def __call__(self, i: int) -> None:
        if self.result is not None or self.taken >= self.tries:
            return
        if self.prof is None and i == self.first:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif self.prof is not None and i == self.first + self.count:
            self.close()
            self.first = i + self.count

    def close(self) -> None:
        """Ends a slice in progress (also when the window ends in it)."""
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.taken += 1
        self.result = reduce_profile(self.prof.events(), self.bases)
        self.prof = None


def warm_profiler(fn) -> None:
    """One short profile of fn() at set-up: the first profile of a process
    pays the profiler's own start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
