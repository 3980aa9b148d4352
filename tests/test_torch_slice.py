"""abc_tpu_torch end to end: DSL programs compiled by the port's passes and
run encrypted through the port's RuntimeVisitor and BFV factory, against the
same programs through abc_tpu with its np64 factory of the same seed (words,
op counters, decryption).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import abc_tpu
import abc_tpu_torch
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu_torch.ast_ir.nodes import VariableDeclaration
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.passes.type_checking import run_type_checking
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from helpers import run_program
from test_secret_index import LAPLACE_SECRET_PROGRAM, _laplace_expected

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAMMING_INPUTS = "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};"
HAMMING = """
  int sum = 0;
  for (int i = 0; i < 4; i = i + 1) {
    sum = sum + (x[i]-y[i])*(x[i]-y[i]);
  }
  return sum;
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hamming(factory, pkg=abc_tpu_torch):
    """The README quick start through package `pkg` (the port, or abc_tpu
    for the reference factory): vectorized compile, run, decrypt slot 0."""
    inputs = pkg.Parser.parse(HAMMING_INPUTS)
    compiled = pkg.compile_program(HAMMING, pkg.input_types_from_ast(inputs),
                                   pkg.CompileOptions(vectorize=True))
    _, outputs = pkg.run_compiled(compiled, inputs,
                                  pkg.Parser.parse("hd = sum;"), factory)
    ct = outputs[0][1]
    return ct, factory.decrypt(ct)[0]


def _run_program_port(inputs_src, program_src, output_src, factory):
    """helpers.run_program through the port's parser, type checker and
    RuntimeVisitor."""
    parse = abc_tpu_torch.Parser.parse
    ast_input, ast_program = parse(inputs_src), parse(program_src)
    input_types = {decl.target.identifier: decl.datatype
                   for decl in ast_input.children()
                   if isinstance(decl, VariableDeclaration)}
    tcv = run_type_checking(ast_program, input_types)
    rv = RuntimeVisitor(factory, ast_input, tcv.get_secret_tainted_nodes())
    rv.execute_ast(ast_program)
    return rv, rv.get_output(parse(output_src))


def _words(handle):
    data = handle.ct.data
    return to_host(data) if isinstance(data, torch.Tensor) else data


def _ref_counters(counters):
    """The port's op counters under the reference's keys: the port also
    counts its plaintext products by a scalar and by a vector
    (`plain_scalar`, `plain_product`), which the reference does not."""
    return {k: v for k, v in counters.items()
            if k not in ("plain_scalar", "plain_product")}


def test_hamming_matches_reference_factory():
    port = BfvCiphertextFactory(slots=1024, seed=5, device="cpu")
    ref = RefFactory(slots=1024, seed=5, engine="np64")
    ct, hd = _hamming(port)
    ref_ct, ref_hd = _hamming(ref, abc_tpu)
    assert hd == ref_hd == 2
    np.testing.assert_array_equal(_words(ct), _words(ref_ct))
    assert _ref_counters(port.context.counters) == ref.context.counters


def test_laplace_sharpening_matches_oracle_and_reference():
    """The reference's LaplaceSharpening program (secret index reads share
    one hoisted decomposition) at n=1024."""
    size = 4
    img = np.random.default_rng(9).integers(0, 64, size * size).tolist()
    inputs = ("secret int img = {" + ",".join(map(str, img)) + "};"
              f" int imgSize = {size};")
    port = BfvCiphertextFactory(slots=1024, seed=3, device="cpu")
    ref = RefFactory(slots=1024, seed=3, engine="np64")
    _, pairs = _run_program_port(inputs, LAPLACE_SECRET_PROGRAM,
                                 "out = img2;", port)
    _, ref_pairs = run_program(inputs, LAPLACE_SECRET_PROGRAM, "out = img2;",
                               ref)
    assert port.decrypt(pairs[0][1])[:size * size] == \
        _laplace_expected(img, size)
    np.testing.assert_array_equal(_words(pairs[0][1]),
                                  _words(ref_pairs[0][1]))
    c = port.context.counters
    assert c["decomp_hit"] > c["decomp"]
    assert _ref_counters(c) == ref.context.counters


_JAX_FREE_SLICE = f"""
import sys
from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                           input_types_from_ast, run_compiled)
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
inputs = Parser.parse({HAMMING_INPUTS!r})
compiled = compile_program({HAMMING!r}, input_types_from_ast(inputs),
                           CompileOptions(vectorize=True))
factory = BfvCiphertextFactory(slots=1024, seed=5, device="cpu")
_, out = run_compiled(compiled, inputs, Parser.parse("hd = sum;"), factory)
hd = factory.decrypt(out[0][1])[0]
assert factory.context.counters["mult"] == 1
print(hd, "jax" in sys.modules or "abc_tpu" in sys.modules)
"""


def test_slice_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE_SLICE], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["2", "False"]


def test_package_source_never_imports_jax():
    pkg = os.path.join(REPO, "abc_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name


def test_cuda_factory_without_gpu_raises(monkeypatch):
    """No CPU fallback: asking for CUDA where there is none is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BfvCiphertextFactory(slots=1024, seed=5, device="cuda")


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_hamming_on_cuda_matches_cpu(cuda):
    gpu = BfvCiphertextFactory(slots=8192, seed=5, device=cuda)
    cpu = BfvCiphertextFactory(slots=8192, seed=5, device="cpu")
    before = dict(nk.launches)
    ct, hd = _hamming(gpu)
    torch.cuda.synchronize()
    assert all(nk.launches[k] > before[k] for k in before)
    cpu_ct, cpu_hd = _hamming(cpu)
    assert hd == cpu_hd == 2
    assert torch.equal(ct.ct.data.cpu(), cpu_ct.ct.data)
