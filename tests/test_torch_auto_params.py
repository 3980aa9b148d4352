"""The port's noise analysis and automatic parameter selection
(abc_tpu_torch.crypto.noise, a copy of abc_tpu's) against the reference on
the programs of tests/test_noise.py and tests/test_auto_params.py: each
program goes through both packages' compile pipelines, and analyze_circuit,
estimate_noise_bits, choose_parameters and auto_params_report must agree
field for field. Then the user surfaces of the port: every workload family
runs encrypted on its auto-chosen set on the CPU,
and jit_compile_program(auto_params=True) (`--auto-params` on the CLI is in
tests/test_torch_cli.py).
"""

import dataclasses
import warnings

import pytest

import abc_tpu
import abc_tpu_torch
from abc_tpu.crypto import noise as ref_noise
from abc_tpu_torch.crypto import noise
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.runtime.values import AbstractCiphertext
from abc_tpu_torch.utils.errors import CompilerError
from test_auto_params import WORKLOADS

_DEEP = "secret int x = a *** a;" + "".join("x = x *** a;"
                                            for _ in range(6)) + "return x;"
_CHAIN = "secret int r = a;{}return r;"
# (inputs, program, CompileOptions keywords): tests/test_noise.py's circuits
# and the depth chains of tests/test_auto_params.py
NOISE_PROGRAMS = {
    "depths": ("secret int a = {1}; secret int b = {2}; int p = 3;",
               "secret int x = a *** b; x = x *** a; x = x *** p; return x;",
               {}),
    "rotations": ("secret int a = {1,2,3,4};",
                  "a = a +++ rotate(a, 2); a = a +++ rotate(a, 1);", {}),
    "residual_multiplicative_loop": (
        "secret int v = {1,2};",
        "secret int acc = v;"
        "for (int i = 0; i < 4; i = i + 1) { acc = acc * v; }"
        "return acc;", {"loop_unrolling": False}),
    "residual_additive_loop": (
        "secret int v = {1,2}; secret int w = {3,4};",
        "secret int acc = v * w;"
        "for (int i = 0; i < 100; i = i + 1) { acc = acc + v; }"
        "return acc;", {"loop_unrolling": False}),
    "shallow": ("secret int a = {1};", "a = a *** a; return a;", {}),
    "deep": ("secret int a = {2};", _DEEP, {}),
    "chain_1": ("secret int a = 2;", _CHAIN.format("r = r * a;"), {}),
    "chain_5": ("secret int a = 2;", _CHAIN.format("r = r * a;" * 5), {}),
}
NOISE_PROGRAMS.update({f"workload_{name}": (i, p, {"vectorize": True})
                       for name, (i, p, _) in WORKLOADS.items()})
UNBOUNDED = ("secret int v = {1,2}; int n = 1000;",
             "secret int acc = v;"
             "for (int i = 0; i < n; i = i + 1) { acc = acc * v; }"
             "return acc;",
             {"loop_unrolling": False, "max_unroll_iterations": 0})


def _compiled(pkg, inputs_src, program_src, options):
    inputs = pkg.Parser.parse(inputs_src)
    return pkg.compile_program(program_src, pkg.input_types_from_ast(inputs),
                               pkg.CompileOptions(**options))


def _both(case):
    return (_compiled(abc_tpu_torch, *case), _compiled(abc_tpu, *case))


@pytest.mark.parametrize("name", sorted(NOISE_PROGRAMS))
def test_analysis_and_report_equal_the_reference(name):
    port, ref = _both(NOISE_PROGRAMS[name])
    stats, ref_stats = noise.analyze_circuit(port), \
        ref_noise.analyze_circuit(ref)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    for n in (1024, 8192, 32768):
        for t_bits in (16, 20):
            assert noise.estimate_noise_bits(stats, n, t_bits) == \
                ref_noise.estimate_noise_bits(ref_stats, n, t_bits)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # dev-size sets warn on security
        for kwargs in ({}, {"security_strict": True}, {"t_bits": 18}):
            params, report = noise.auto_params_report(port, seed=4, **kwargs)
            ref_params, ref_report = ref_noise.auto_params_report(
                ref, seed=4, **kwargs)
            assert report == ref_report
            assert dataclasses.asdict(params) == \
                dataclasses.asdict(ref_params)


def test_unbounded_residual_loop_escalates_to_error_in_both():
    port, ref = _both(UNBOUNDED)
    assert noise.analyze_circuit(port).mult_depth == \
        ref_noise.analyze_circuit(ref).mult_depth >= 64
    with pytest.raises(CompilerError):
        noise.choose_parameters(port)
    with pytest.raises(abc_tpu.utils.errors.CompilerError):
        ref_noise.choose_parameters(ref)


def test_security_strict_skips_dev_presets():
    port, _ = _both(NOISE_PROGRAMS["shallow"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert noise.choose_parameters(port).n <= 2048
    assert noise.choose_parameters(port, security_strict=True).n >= 8192


def test_insecure_choice_warns():
    port, _ = _both(NOISE_PROGRAMS["shallow"])
    with pytest.warns(UserWarning, match="NO security claim"):
        _, report = noise.auto_params_report(port, seed=1)
    assert report["he_standard_128bit"] is False


def _run_factory(factory, inputs_src, program_src, output_src):
    parse = abc_tpu_torch.Parser.parse
    ia, oa = parse(inputs_src), parse(output_src)
    compiled = abc_tpu_torch.compile_program(
        program_src, abc_tpu_torch.input_types_from_ast(ia),
        abc_tpu_torch.CompileOptions(vectorize=True))
    rv = RuntimeVisitor(factory, ia, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    out = []
    for name, value in rv.get_output(oa):
        if isinstance(value, AbstractCiphertext):
            out.append((name, factory.decrypt(value)[:16]))
        else:
            out.append((name, list(value.values)[:16]))
    return compiled, out


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_runs_on_auto_chosen_params(name):
    """Every reference end-to-end family, encrypted by the port on the set
    chosen from its circuit, decrypts to the dummy backend's outputs."""
    inputs_src, program_src, output_src = WORKLOADS[name]
    compiled, dummy_out = _run_factory(DummyCiphertextFactory(slots=64),
                                       inputs_src, program_src, output_src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params, report = noise.auto_params_report(compiled, seed=4)
    assert report["predicted_margin_bits"] > 0
    factory = BfvCiphertextFactory(context=BfvContext(params, "cpu"))
    assert factory.params is params and factory.slot_count == params.n
    _, bfv_out = _run_factory(factory, inputs_src, program_src, output_src)
    assert bfv_out == dummy_out, (
        f"{name}: auto-chosen n={report['n']} diverged from dummy")


def test_chosen_parameters_leave_noise_budget():
    inputs_src, program_src, _ = WORKLOADS["hamming"]
    compiled = _compiled(abc_tpu_torch, inputs_src, program_src,
                         {"vectorize": True})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = noise.choose_parameters(compiled, seed=3)
    factory = BfvCiphertextFactory(
        slots=params.n, seed=3, device="cpu",
        plain_bits=params.plain_modulus.bit_length())
    assert factory.params.plain_modulus == params.plain_modulus
    inputs = abc_tpu_torch.Parser.parse(inputs_src)
    _, pairs = abc_tpu_torch.run_compiled(
        compiled, inputs, abc_tpu_torch.Parser.parse("hd = sum;"), factory)
    assert factory.decrypt(pairs[0][1])[0] == 2
    assert pairs[0][1].noise_bits() > 0


def test_jit_auto_params_report_equals_the_reference_report():
    """jit_compile_program(auto_params=True): the report the reference
    computes for the same circuit, and the program decrypts to 2 on the set
    the port built from it."""
    inputs_src, program_src, output_src = WORKLOADS["hamming"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = abc_tpu_torch.jit_compile_program(
            program_src, inputs_src, output_src,
            options=abc_tpu_torch.CompileOptions(vectorize=True),
            auto_params=True, seed=4, device="cpu")
        _, ref_report = ref_noise.auto_params_report(
            _compiled(abc_tpu, inputs_src, program_src, {"vectorize": True}),
            seed=4)
    assert jp.auto_params == jp.compiled.auto_params == ref_report
    assert jp.auto_params["predicted_margin_bits"] > 0
    assert jp.factory.params.n == ref_report["n"]
    assert jp.run()["out"][0] == 2


# ------------------------------------------------------------------- CKKS

CKKS_W = "secret double w0 = {1.0,2.0}; secret double w1 = {0.5,0.25};"
CKKS_DEPTH2 = ("secret double acc = w0 * w1; acc = acc + rotate(w0, 1); "
               "acc = acc * w1; return acc;")
# name: (program, inputs, scale_bits, levels)
CKKS_CIRCUITS = {
    # rotating depth-2 circuit → prime-sized scale (29), 3 levels
    "rotating_depth_2": (CKKS_DEPTH2, CKKS_W, 29, 3),
    # rotation-free depth-1 circuit: scale_bits sized so the FINAL
    # (post-rescale) scale clears the ~2^17 noise floor with headroom
    # (2·27 − 30 = 24 bits) while leaving the last limb ≥5 bits of
    # coefficient capacity
    "depth_1": ("secret double acc = w0 * w0; return acc;",
                "secret double w0 = {1.0,2.0};", 27, 2),
    # depth-0 keeps the headroom default
    "depth_0": ("secret double acc = w0 + w0; return acc;",
                "secret double w0 = {1.0,2.0};", 25, 2),
}


@pytest.mark.parametrize("name", sorted(CKKS_CIRCUITS))
def test_ckks_auto_params_selection(name):
    """choose_ckks_parameters: the reference test's expectations, and the
    reference's own parameters and report for the same circuit."""
    prog, inputs, scale_bits, levels = CKKS_CIRCUITS[name]
    ours, theirs = _both((inputs, prog, {}))
    params, rep = noise.choose_ckks_parameters(ours, seed=5)
    ref_params, ref_rep = ref_noise.choose_ckks_parameters(theirs, seed=5)
    assert rep["scale_bits"] == scale_bits and rep["levels"] == levels
    assert rep["he_standard_128bit"]
    assert rep == ref_rep
    assert dataclasses.asdict(params) == dataclasses.asdict(ref_params)


def test_ckks_auto_params_executes_accurately():
    from abc_tpu_torch.crypto.ckks import CkksContext
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    ia = abc_tpu_torch.Parser.parse(CKKS_W)
    comp = _compiled(abc_tpu_torch, CKKS_W, CKKS_DEPTH2, {})
    params, rep = noise.choose_ckks_parameters(comp, seed=5)
    factory = CkksCiphertextFactory(context=CkksContext(params, "cpu"))
    rv = RuntimeVisitor(factory, ia, comp.secret_tainted)
    rv.execute_ast(comp.ast)
    ((_, v),) = rv.get_output(abc_tpu_torch.Parser.parse("out = acc;"))
    got = factory.decrypt(v)[:2]
    want = [(1.0 * 0.5 + 2.0) * 0.5, (2.0 * 0.25 + 2.0) * 0.25]
    assert all(abs(g - w) <= 1e-2 for g, w in zip(got, want)), got


def test_jit_auto_params_routes_float_circuits_to_ckks():
    """Float inputs under auto_params go to CKKS on the device asked for,
    with the reference's report; integer inputs still go to BFV."""
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    prog, inputs = "secret double acc = w0 * w0; return acc;", \
        "secret double w0 = {1.5,2.0};"
    jp = abc_tpu_torch.jit_compile_program(
        prog, inputs, "out = acc;", auto_params=True, seed=5, device="cpu")
    assert isinstance(jp.factory, CkksCiphertextFactory)
    assert jp.auto_params["scheme"] == "ckks"
    _, ref_rep = ref_noise.choose_ckks_parameters(
        _compiled(abc_tpu, inputs, prog, {}), seed=5)
    assert jp.auto_params == jp.compiled.auto_params == ref_rep
    assert (jp.factory.params.n, jp.factory.params.L) == \
        (ref_rep["n"], ref_rep["levels"])
    got = jp.run()["out"][:2]
    assert all(abs(g - w) <= 1e-2 for g, w in zip(got, [2.25, 4.0])), got
