"""A copy of the benchmark's cells at a ring degree a CPU test can hold
(n=1024; BFV at 5 data primes; CKKS keeps its primes, which its program's
depth needs, and cuts its vectors to the n/2 slots): every other number
as committed. Beside the committed cells it holds the CKKS cell
`logreg.single`, which BENCHMARK.json leaves out until the program serves
its configuration within its tolerance (PERF.md, open questions): the
harness's CKKS path is tested on it."""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CKKS_CONFIG = {"name": "ckks-logreg-n32768",
               "source": "see the configuration's file",
               "file": "fhebench/configs/ckks-logreg-n32768.json",
               "reduced": [], "why": "the harness's CKKS path"}
CKKS_CELL = {"name": "logreg.single", "config": "ckks-logreg-n32768",
             "traffic": "records", "chips": 1,
             "why": "one client, 16384 records a request, 1 in flight"}
CKKS_METRICS = [
    {"name": "programs_per_s.logreg", "unit": "programs/s",
     "better": "higher", "bound": 0.1, "source": "host_clock",
     "workloads": ["logreg.single"]},
    {"name": "latency_p95_ms.logreg", "unit": "ms", "better": "lower",
     "bound": 0.14, "source": "host_clock", "workloads": ["logreg.single"]}]


def _bench() -> dict:
    """BENCHMARK.json with the CKKS cell and its two end-to-end entries."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(CKKS_CONFIG)
    bench["workloads"].append(CKKS_CELL)
    bench["end_to_end"] = CKKS_METRICS + bench["end_to_end"]
    return bench


def _write_root(tmp_path, tiny: bool) -> str:
    bench = _bench()
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        if tiny and cfg["scheme"] == "ckks":
            cfg["n"] = 1024
            for group in ("inputs", "outputs"):
                for v in cfg[group].values():
                    v["length"] = min(v["length"], cfg["n"] // 2)
        elif tiny:
            cfg.update(n=1024, data_primes=5)
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def tiny_root(tmp_path) -> str:
    """A directory with BENCHMARK.json and the configurations cut to
    n=1024; traffic, layers and metrics are read from the benchmark's own
    folder."""
    return _write_root(tmp_path, tiny=True)


def full_root(tmp_path) -> str:
    """The same at the committed sizes."""
    return _write_root(tmp_path, tiny=False)


def tiny_cell(tmp_path, name, **traffic):
    from fhebench.harness import spec
    cell = spec.load_cell(name, root=tiny_root(tmp_path))
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def full_cell(tmp_path, name):
    from fhebench.harness import spec
    return spec.load_cell(name, root=full_root(tmp_path))
