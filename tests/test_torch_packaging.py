"""Packaging of the port (pyproject.toml): the `torch` extra, the
`abc-tpu-torch` console script and the package data (kernel sources, test
data), and an install of the package into an empty target, from which
`abc_tpu_torch/ops/_build.py` finds its CUDA sources. The install takes no
index and no build isolation (`--no-index --no-build-isolation --no-deps`),
from a copy of the port's files, so nothing is written into the checkout.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = ["csrc/*.cu", "csrc/*.cuh", "testdata/*.json", "testdata/*.npz",
        "testdata/*.npy"]


def _config():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_pyproject_declares_the_port():
    cfg = _config()
    assert cfg["project"]["scripts"]["abc-tpu-torch"] == \
        "abc_tpu_torch.cli:main"
    assert cfg["project"]["optional-dependencies"]["torch"] == ["torch"]
    assert cfg["tool"]["setuptools"]["package-data"]["abc_tpu_torch"] == DATA
    # what tests/test_packaging.py pins for the reference stays
    assert cfg["project"]["scripts"]["abc-tpu"] == "abc_tpu.cli:main"
    assert cfg["tool"]["setuptools"]["package-data"]["abc_tpu"] == \
        ["_native_src/modpoly.cpp"]
    # every kernel source and test-data file is covered by a pattern
    pkg = os.path.join(REPO, "abc_tpu_torch")
    for sub in ("csrc", "testdata"):
        files = {os.path.relpath(p, pkg) for p in
                 glob.glob(os.path.join(pkg, sub, "*"))}
        covered = {os.path.relpath(p, pkg) for pat in DATA
                   for p in glob.glob(os.path.join(pkg, pat))}
        assert files and files <= covered, sub


def test_console_entry_point_resolves():
    from abc_tpu_torch.cli import main
    assert callable(main)


def test_installed_tree_finds_its_kernel_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src / name)
    shutil.copytree(os.path.join(REPO, "abc_tpu_torch"),
                    src / "abc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--quiet", "--no-index",
         "--no-build-isolation", "--no-deps", "--target", str(target),
         str(src)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    probe = (
        "import json, os, abc_tpu_torch, abc_tpu_torch.cli\n"
        "from abc_tpu_torch.ops import _build\n"
        f"assert abc_tpu_torch.__file__.startswith(r'{target}')\n"
        "assert _build._CSRC.startswith(os.path.dirname("
        "abc_tpu_torch.__file__))\n"
        "assert all(os.path.exists(p) for p in _build.SOURCES + "
        "_build.HEADERS), _build.SOURCES\n"
        "assert _build._stale()\n"
        "data = os.path.join(os.path.dirname(abc_tpu_torch.__file__), "
        "'testdata')\n"
        "print(json.dumps(sorted(os.listdir(data))))\n")
    env = dict(os.environ, PYTHONPATH=str(target))
    r2 = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                        text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r2.returncode == 0, r2.stderr[-2000:]
    installed = set(json.loads(r2.stdout.strip().splitlines()[-1]))
    assert installed == set(os.listdir(os.path.join(REPO, "abc_tpu_torch",
                                                    "testdata")))
    scripts = os.listdir(target / "bin")
    assert "abc-tpu-torch" in scripts
