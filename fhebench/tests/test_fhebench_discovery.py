"""A cell, a configuration, a traffic mix and a per-layer metric are found
by their names in BENCHMARK.json: a later change adds files and entries and
edits none."""

import json
import os
import shutil

from _tiny import REPO
from fhebench.harness import spec


def test_new_files_found_by_name(tmp_path):
    bench_dir = tmp_path / "fhebench"
    shutil.copytree(os.path.join(REPO, "fhebench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # a new configuration, traffic mix, cell and metric, as new files
    cfg = json.load(open(bench_dir / "configs" / "bfv-hamming-n8192.json"))
    cfg["name"] = "bfv-hamming-other"
    (bench_dir / "configs" / "bfv-hamming-other.json").write_text(
        json.dumps(cfg))
    (bench_dir / "workloads" / "other.json").write_text(json.dumps(
        {"batch": 1, "in_flight": 4, "pool": 64,
         "keep": 16, "trace_requests": 200}))
    (bench_dir / "metrics" / "replay_count.other.py").write_text(
        "def read(run):\n    return 42\n")
    (bench_dir / "layers" / "extra.json").write_text(json.dumps(
        {"layer": "extra", "kernels": ["rns_ew_"]}))
    bench["configs"].append({"name": "bfv-hamming-other",
                             "source": "x", "reduced": [], "why": "x",
                             "file": "fhebench/configs/"
                                     "bfv-hamming-other.json"})
    bench["workloads"].append({"name": "hamming.other",
                               "config": "bfv-hamming-other",
                               "traffic": "other", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "replay_count.other", "unit": "n",
                               "better": "lower", "source": "host_clock",
                               "layer": "extra", "moves": "setup_s",
                               "workloads": ["hamming.other"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("hamming.other", root=str(tmp_path),
                          bench_dir=str(bench_dir))
    assert cell.config["name"] == "bfv-hamming-other"
    assert cell.traffic["in_flight"] == 4
    assert "extra" in cell.layers
    names = [m["name"] for m in cell.per_layer]
    assert names == ["replay_count.other"]
    assert spec.reader(cell, "replay_count.other")(None) == 42
    assert cell.reference().answers({"x": [[1, 0, 0, 1]],
                                     "y": [[0, 0, 0, 1]]}) == [{"out": [1]}]
    # the committed cells see only their own metrics
    lap = spec.load_cell("laplace.single", root=str(tmp_path),
                         bench_dir=str(bench_dir))
    assert "replay_count.other" not in [m["name"] for m in lap.per_layer]


def test_every_metric_has_its_reader():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.per_layer and cell.end_to_end
        for m in cell.per_layer:
            assert callable(spec.reader(cell, m["name"])), m["name"]
