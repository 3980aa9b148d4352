"""A cell's files, found by the names in BENCHMARK.json: nothing here names
a configuration, a traffic mix or a metric. A cell is an entry of
`workloads`; its configuration is the `configs` entry of that name (its
`file`), its traffic `workloads/<traffic>.json`, each per-layer metric
`metrics/<metric name>.py` (or `metrics/<its name before the first
dot>.py`), each layer that owns kernels `layers/*.json`."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class SpecError(ValueError):
    """A cell, a file or a key that BENCHMARK.json or a data file lacks."""


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    layers: Dict[str, Dict] = field(default_factory=dict)
    bench_dir: str = HERE

    @property
    def program_name(self) -> str:
        return self.config["program"]

    def program_source(self) -> str:
        with open(os.path.join(self.bench_dir, "programs",
                               f"{self.program_name}.fhe")) as f:
            return f.read()

    def reference(self):
        """The configuration's plain reference (reference/<program>.py)."""
        return load_module(os.path.join(self.bench_dir, "reference",
                                        f"{self.program_name}.py"))


def _read_json(path: str) -> Dict:
    if not os.path.exists(path):
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark's own, loaded by its file path (metric
    names hold dots, so they are no import names)."""
    if not os.path.exists(path):
        raise SpecError(f"missing file {path}")
    name = "fhebench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Does `cell` report this metric: listed in its `workloads`, or, with
    no such key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root: Optional[str] = None,
              bench_dir: Optional[str] = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its configuration,
    traffic and layers read from bench_dir (the benchmark's folder)."""
    root = root or ROOT
    bench_dir = bench_dir or HERE
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(there are {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"{name}: no configuration {entry['config']!r}")
    config = _read_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _read_json(os.path.join(bench_dir, "workloads",
                                      f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"]
           if m.get("workloads") is None or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    layers = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "layers",
                                              "*.json"))):
        layer = _read_json(path)
        layers[os.path.splitext(os.path.basename(path))[0]] = layer
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                layers=layers, bench_dir=bench_dir)


def kernel_families(layers: Dict[str, Dict]) -> List[str]:
    """Every kernel family the layers own (`kernels` of layers/*.json)."""
    return [k for layer in layers.values() for k in layer.get("kernels", ())]


def reader(cell: Cell, metric: str):
    """The `read(run)` function of metrics/<metric>.py, or, where there is
    no such file, of metrics/<the name before its first dot>.py: a
    quantity split by the end-to-end metric it moves (ntt_roofline.single,
    ntt_roofline.batch) is read by one reader."""
    path = os.path.join(cell.bench_dir, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(cell.bench_dir, "metrics",
                            f"{metric.split('.')[0]}.py")
    return load_module(path).read
