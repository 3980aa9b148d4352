"""BENCHMARK.json keeps to the benchmark's contract as far as a file can
show it: its keys, names, units, bounds, cells and files."""

import json
import os
import re

from _tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_and_paths():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(REPO, p))
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_configs_and_cells():
    b = load()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and \
            line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert json.load(open(os.path.join(REPO, c["file"])))["name"] == \
            c["name"]
    pairs = set()
    used = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        four += w["chips"] == 4
        assert os.path.exists(os.path.join(REPO, "fhebench", "workloads",
                                           w["traffic"] + ".json"))
    assert used == set(configs)
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = load()
    cells = {w["name"] for w in b["workloads"]}
    names = set()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["name"] not in names
        names.add(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in b["per_layer"])
        mine = {m["name"] for m in b["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert "setup_s" in mine and len(mine) >= 2
        # a per-layer metric moves an end-to-end metric of each of its cells
        for m in b["per_layer"]:
            if cell in m["workloads"]:
                assert m["moves"] in mine, (cell, m["name"])
