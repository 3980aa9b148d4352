"""Nothing under fhebench/ imports JAX or the JAX package (top-level
module names compared whole: abc_tpu_torch is not abc_tpu), the plain
references import nothing of the port, and a run on a machine without the
card, or in a directory with nothing but the benchmark, prints no
result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from _tiny import REPO

BENCH = os.path.join(REPO, "fhebench")
FORBIDDEN = {"jax", "jaxlib", "flax", "abc_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_references_are_plain():
    for path in sources("reference"):
        assert imported_tops(path) <= {"__future__", "typing", "numpy"}, \
            path


def test_run_forbids_by_whole_name():
    from fhebench.run import FORBIDDEN as run_forbidden, loaded_forbidden
    assert set(run_forbidden) == FORBIDDEN
    assert loaded_forbidden(["abc_tpu_torch.ops", "numpy", "jaxtyping"]) \
        == []
    assert loaded_forbidden(["abc_tpu.crypto", "jax.numpy", "flax"]) == \
        ["abc_tpu", "flax", "jax"]


def run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "fhebench.run", "--workload",
         "laplace.single", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600)


def test_no_card_no_result():
    p = run(REPO)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
