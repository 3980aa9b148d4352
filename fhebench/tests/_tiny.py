"""A copy of the benchmark's cells at a ring degree a CPU test can hold
(n=1024, 5 data primes): every other number as committed."""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def tiny_root(tmp_path) -> str:
    """A directory with BENCHMARK.json and the configurations cut to
    n=1024; traffic, layers and metrics are read from the benchmark's own
    folder."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(n=1024, data_primes=5)
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def tiny_cell(tmp_path, name, **traffic):
    from fhebench.harness import spec
    cell = spec.load_cell(name, root=tiny_root(tmp_path))
    cell.traffic = dict(cell.traffic, **traffic)
    return cell
