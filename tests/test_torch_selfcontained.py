"""abc_tpu_torch stands alone: no file of the package, and not
chip_smoke.py, imports abc_tpu or jax, and the package compiles and runs a
program encrypted with both made unimportable.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("abc_tpu", "jax")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "abc_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """Top-level package of every import statement in the file, wherever it
    stands (module level, function bodies, conditionals)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=[os.path.relpath(p, REPO) for p in _sources()])
def test_file_imports_nothing_of_the_reference(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_the_walk_sees_the_package():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"chip_smoke.py", "abc_tpu_torch/crypto/bfv.py",
            "abc_tpu_torch/passes/pipeline.py",
            "abc_tpu_torch/runtime/jit_executor.py", "abc_tpu_torch/cli.py",
            "abc_tpu_torch/scripts/ntt_ablation.py",
            "abc_tpu_torch/bench.py", "abc_tpu_torch/benchsuite.py",
            "abc_tpu_torch/entry.py", "abc_tpu_torch/utils/timing.py",
            "abc_tpu_torch/scripts/hybrid_ks_ab.py"} <= names


def test_import_detection_sees_nested_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\ndef f():\n    from jax import numpy\n"
                     "try:\n    import abc_tpu.ops.native as n\n"
                     "except ImportError:\n    pass\n"
                     "from . import sibling\n")
    assert _imported_roots(str(probe)) == {"os", "jax", "abc_tpu"}


COPIED = ["utils/errors.py", "utils/datatype.py", "utils/operators.py",
          "utils/scope.py", "utils/__init__.py",
          "ast_ir/__init__.py", "ast_ir/nodes.py", "ast_ir/compare.py",
          "ast_ir/json_serde.py",
          "parser/__init__.py", "parser/tokens.py", "parser/tokenizer.py",
          "parser/parser.py",
          "passes/__init__.py", "passes/visitor.py", "passes/hash_visitor.py",
          "passes/printer.py", "passes/type_checking.py", "passes/ctes.py",
          "passes/secret_branching.py", "passes/unroll.py", "passes/dse.py",
          "passes/cfg.py", "passes/vectorizer.py", "passes/cone_rewriter.py",
          "passes/pipeline.py",
          "runtime/__init__.py", "runtime/values.py", "runtime/backend.py",
          "runtime/executor.py", "runtime/dummy.py",
          "crypto/numthy.py", "crypto/params.py", "crypto/noise.py",
          "circuits.py"]
# comment and docstring lines of the copies that are worded differently
REWORDED = {"passes/cone_rewriter.py": 1, "passes/pipeline.py": 2,
            "passes/secret_branching.py": 1, "passes/type_checking.py": 1}


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_differs_in_import_lines_only(rel):
    """The host-only layers are copies of abc_tpu's files with the import
    lines renamed: a fix to one side shows up here until it reaches the
    other. Five comment lines are reworded and nothing else."""
    import difflib

    def body(path, package):
        with open(path) as f:
            return [ln for ln in f.read().splitlines() if not re.match(
                rf"\s*(from|import) {package}\b", ln)]

    ours = body(os.path.join(REPO, "abc_tpu_torch", rel), "abc_tpu_torch")
    theirs = body(os.path.join(REPO, "abc_tpu", rel), "abc_tpu")
    changed = [ln for ln in difflib.unified_diff(theirs, ours, lineterm="",
                                                 n=0)
               if ln.startswith("+") and not ln.startswith("+++")]
    assert len(changed) == REWORDED.get(rel, 0), changed
    assert len(ours) == len(theirs)


_BLOCKED_RUN = """
import sys
sys.modules["abc_tpu"] = None
sys.modules["jax"] = None
from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                           input_types_from_ast, run_compiled)
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
inputs = Parser.parse("secret int x = {1,1,0,1}; secret int y = {1,0,1,1};")
program = '''
  int sum = 0;
  for (int i = 0; i < 4; i = i + 1) {
    sum = sum + (x[i]-y[i])*(x[i]-y[i]);
  }
  return sum;
'''
compiled = compile_program(program, input_types_from_ast(inputs),
                           CompileOptions(vectorize=True))
factory = BfvCiphertextFactory(slots=1024, seed=5, device="cpu")
_, out = run_compiled(compiled, inputs, Parser.parse("hd = sum;"), factory)
print(factory.decrypt(out[0][1])[0], factory.context.counters["mult"],
      sorted(m for m in sys.modules
             if m.split(".")[0] in ("abc_tpu", "jax")
             and sys.modules[m] is not None))
"""


def test_readme_program_runs_with_the_reference_unimportable():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "2 1 []"
