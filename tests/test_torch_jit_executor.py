"""Whole-program execution of the port (abc_tpu_torch.runtime.jit_executor)
against abc_tpu: the BFV cases of tests/test_jit_executor.py at slots=1024 on
the CPU, each holding the port's raw output words identical (no tolerance:
residues are canonical) to the reference of the same seed: abc_tpu's np64
factory walked eagerly through the same compile pipeline, and once abc_tpu's
own jit_compile_program (jx32). Plus what a CUDA-graph capture needs of the
context (identity caches emptied around a run, host-made constants on a
tape) driven here without a graph, the CKKS cases of the same reference
file (float programs, values to its tolerance, words against abc_tpu's jx32
program), and the refusals (a malformed mesh, no GPU).
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import abc_tpu
from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
from abc_tpu.runtime.jit_executor import (
    jit_compile_program as ref_jit_compile_program)
from abc_tpu_torch import CompileOptions, JittedProgram, jit_compile_program
from abc_tpu_torch.crypto.bfv import BfvCiphertext
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.runtime.bfv_backend import (BfvCiphertextFactory,
                                               TorchBfvCiphertext)
from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
from abc_tpu_torch.runtime.dummy import DummyCiphertextFactory
from abc_tpu_torch.runtime.host_constants import HostConstants
from abc_tpu_torch.utils.errors import RuntimeExecutionError

HAMMING_LOOP = ("int sum = 0;"
                "for (int i = 0; i < 4; i = i + 1) {"
                "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
                "} return sum;")
XY = "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};"
MULT_ROTATE = dict(
    program_src="secret int p = a *** b; p = rotate(p, 1);",
    inputs_src="secret int a = {3, 1, 4, 1}; secret int b = {2, 7, 1, 8};",
    output_src="y = p;")

# the BFV programs of tests/test_jit_executor.py: (program, inputs, output,
# leading decrypted slots)
PROGRAMS = {
    "hamming_distance": ("""
          secret int diff = (x --- y) *** (x --- y);
          diff = diff +++ rotate(diff, 2);
          diff = diff +++ rotate(diff, 1);
          return diff;
        """, XY, "hd = diff;", [2]),
    "loop_unrolls_into_circuit": ("""
          for (int i = 0; i < 3; i = i + 1) {
            acc = acc +++ acc;
          }
          return acc;
        """, "secret int acc = {2};", "y = acc;", [16]),
    "mixed_plain_secret": ("""
          int w = 10;
          secret int z = x *** w +++ 5;
          return z;
        """, "secret int x = {1, 2, 3};", "y = z;", [15, 25, 35]),
    "matches_eager": (MULT_ROTATE["program_src"], MULT_ROTATE["inputs_src"],
                      MULT_ROTATE["output_src"], [7, 4, 8]),
    "rerun": ("secret int s = x +++ x;", "secret int x = {5};", "y = s;",
              [10]),
    "census_fallback": ("secret int y = rotate(x, 1); return y;",
                        "secret int x = {10, 20, 30};", "out = y;",
                        [20, 30]),
    "streaming_hamming": (HAMMING_LOOP, XY, "out = sum;", [2]),
    "in_program_encryption": ("secret int v = 7; v = v +++ x; return v;",
                              "secret int x = {5};", "out = v;", [12]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _port(seed, device="cpu"):
    return BfvCiphertextFactory(slots=1024, seed=seed, device=device)


def _reference_eager_words(program, inputs, output, seed, options=None):
    """The program through abc_tpu's compile pipeline and its eager executor
    on the np64 factory of `seed`: (output words, decrypted slots)."""
    ast_in = abc_tpu.Parser.parse(inputs)
    compiled = abc_tpu.Compiler(options).compile_source(
        program, abc_tpu.input_types_from_ast(ast_in))
    factory = RefFactory(slots=1024, seed=seed, engine="np64")
    _, pairs = abc_tpu.run_compiled(compiled, ast_in,
                                    abc_tpu.Parser.parse(output), factory)
    ct = pairs[0][1]
    return np.asarray(ct.ct.data), factory.decrypt(ct)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_jitted_program_words_equal_reference_eager(name):
    program, inputs, output, want = PROGRAMS[name]
    jp = jit_compile_program(program, inputs, output, factory=_port(seed=9))
    raw = jp.run_raw(jp.secret_inputs)
    (out_name, words), = raw.items()
    ref_words, ref_plain = _reference_eager_words(program, inputs, output,
                                                  seed=9)
    np.testing.assert_array_equal(to_host(words), ref_words)
    got = jp.decrypt_outputs(raw)[out_name]
    assert got[:len(want)] == want == ref_plain[:len(want)]
    assert jp.run()[out_name][:len(want)] == want


def test_jitted_words_equal_reference_jit():
    """The port against abc_tpu's own jit_compile_program (jx32, one XLA
    program) on the program of test_jitted_matches_eager."""
    ref = ref_jit_compile_program(
        factory=RefFactory(slots=1024, engine="jx32", seed=9), **MULT_ROTATE)
    jp = jit_compile_program(factory=_port(seed=9), **MULT_ROTATE)
    for name in ("a", "b"):
        np.testing.assert_array_equal(to_host(jp.secret_inputs[name]),
                                      np.asarray(ref.secret_inputs[name]))
    np.testing.assert_array_equal(
        to_host(jp.run_raw(jp.secret_inputs)["y"]),
        np.asarray(ref.run_raw(ref.secret_inputs)["y"]))
    assert jp.run()["y"][:3] == ref.run()["y"][:3] == [7, 4, 8]


def test_attributes_and_phases_of_the_reference():
    jp = jit_compile_program(factory=_port(seed=9), **MULT_ROTATE)
    assert set(jp.secret_inputs) == {"a", "b"}
    assert set(jp.phase_ms) == {"eval_ready", "encrypt", "key_census",
                                "key_build", "setup_other", "parse_compile"}
    assert all(v >= 0 for v in jp.phase_ms.values())
    assert jp.auto_params is None and jp.device_bytes is None
    # the census found both keys, so key_build made them before any run
    assert set(jp.factory.context._keys) == {"relin", "galois_3"}


def test_rerun_on_a_fresh_ciphertext():
    program, inputs, output, _ = PROGRAMS["rerun"]
    factory = _port(seed=9)
    jp = jit_compile_program(program, inputs, output, factory=factory)
    assert jp.run()["y"][0] == 10
    ct2 = factory.create_ciphertext([21])
    raw = jp.run_raw({"x": ct2.ct.data})
    assert factory.context.decode(factory.context.decrypt(
        BfvCiphertext(raw["y"])))[0] == 42


@pytest.mark.parametrize("census", [{"relin"}, None],
                         ids=["drops_the_rotate_key", "cannot_run"])
def test_census_missing_key_is_built_by_the_first_run(monkeypatch, census):
    """If the dummy-run key census under-approximates, or cannot run, the
    first walk of the program builds the missing key: correct, just later."""
    monkeypatch.setattr(JittedProgram, "_census_key_ids",
                        lambda self, compiled, i, o: census)
    program, inputs, output, want = PROGRAMS["census_fallback"]
    jp = jit_compile_program(program, inputs, output, factory=_port(seed=21))
    assert "galois_3" not in jp.factory.context._keys
    assert jp.run()["out"][:2] == want
    assert "galois_3" in jp.factory.context._keys


def test_census_finds_exactly_the_keys():
    jp = jit_compile_program(factory=_port(seed=3), **MULT_ROTATE)
    assert jp._census_key_ids(jp.compiled, jp.input_ast, jp.output_ast) == \
        {"relin", f"galois_{pow(3, 1, 2 * 1024)}"}


def test_encrypt_inputs_streams_fresh_values():
    """Serving pattern: compile once, stream new encrypted inputs through
    the same program, decrypt correct results."""
    jp = jit_compile_program(HAMMING_LOOP, XY, "out = sum;",
                             factory=_port(seed=5))
    assert jp.run()["out"][0] == 2
    for x, y in (([0, 0, 0, 0], [1, 1, 1, 1]),
                 ([1, 0, 1, 0], [1, 0, 1, 0]),
                 ([1, 1, 1, 0], [0, 1, 0, 0])):
        fresh = jp.encrypt_inputs({"x": x, "y": y})
        got = jp.decrypt_outputs(jp.run_raw(fresh))["out"][0]
        assert got == sum(int(a != b) for a, b in zip(x, y)), (x, y, got)
    # partial update reuses the original other input (y = {1,0,1,1})
    fresh = jp.encrypt_inputs({"x": [0, 0, 1, 1]})
    assert fresh["y"] is jp.secret_inputs["y"]
    assert jp.decrypt_outputs(jp.run_raw(fresh))["out"][0] == 1
    with pytest.raises(RuntimeExecutionError, match="unknown"):
        jp.encrypt_inputs({"zzz": [1]})


def test_run_raw_refuses_other_inputs_than_the_programs():
    jp = jit_compile_program(factory=_port(seed=9), **MULT_ROTATE)
    a = jp.secret_inputs["a"]
    with pytest.raises(RuntimeExecutionError, match="exactly"):
        jp.run_raw({"a": a})
    with pytest.raises(RuntimeExecutionError, match="expected"):
        jp.run_raw({"a": a, "b": a[:1]})
    with pytest.raises(RuntimeExecutionError, match="expected"):
        jp.run_raw({"a": a, "b": a.to(torch.int64)})


# ------------------------------------------------ what a capture needs

def test_fresh_caches_keeps_entries_from_crossing_a_run():
    """The trap of the identity-keyed caches: a static input tensor keeps
    its identity while its contents change. An entry made before a run (the
    warm-up's) must miss inside it, and one made inside must miss after."""
    ctx = _port(seed=4).context
    a, b, c = ctx.encrypt_many([ctx.encode([3]), ctx.encode([5]),
                                ctx.encode([7])])
    static = a.data.clone()
    before = ctx.multiply(BfvCiphertext(static), b)           # the warm-up
    assert ctx.counters["op_ntt"] == 2
    with ctx.fresh_caches():
        inside = ctx.multiply(BfvCiphertext(static), b)       # the capture
        assert ctx.counters["op_ntt"] == 4 and \
            ctx.counters["op_ntt_hit"] == 0
        static.copy_(c.data)                                  # a fresh input
    after = ctx.multiply(BfvCiphertext(static), b)
    assert ctx.counters["op_ntt_hit"] == 0
    assert torch.equal(before.data, inside.data)
    assert torch.equal(after.data, ctx.multiply(c, b).data)
    assert ctx.decode(ctx.decrypt(after))[0] == 35
    # rotations: the same for the decomposition cache
    with ctx.fresh_caches():
        ctx.rotate_rows(BfvCiphertext(static), 1)
    ctx.rotate_rows(BfvCiphertext(static), 2)
    assert ctx.counters["decomp"] == 2 and ctx.counters["decomp_hit"] == 0


@pytest.mark.parametrize("repaired", [True, False])
def test_two_runs_on_one_tensor_with_new_contents(monkeypatch, repaired):
    """Two run_raw calls on different inputs held in the SAME tensors (what
    a graph's static inputs are), each equal to the eager result. With the
    emptying of the caches taken out, the second run multiplies by the
    first inputs' transforms: this test sees it."""
    factory = _port(seed=9)
    ctx = factory.context
    if not repaired:
        monkeypatch.setattr(ctx, "fresh_caches", contextlib.nullcontext)
    jp = jit_compile_program(factory=factory, **MULT_ROTATE)
    static = {k: v.clone() for k, v in jp.secret_inputs.items()}
    first = jp.run_raw(static)["y"]
    fresh = jp.encrypt_inputs({"a": [2, 2, 2, 2], "b": [5, 6, 7, 8]})
    for name in static:
        static[name].copy_(fresh[name])
    second = jp.run_raw(static)["y"]
    eager = ctx.rotate_rows(ctx.multiply(BfvCiphertext(fresh["a"].clone()),
                                         BfvCiphertext(fresh["b"].clone())),
                            1).data
    assert jp.decrypt_outputs({"y": first})["y"][:3] == [7, 4, 8]
    if repaired:
        assert torch.equal(second, eager)
        assert jp.decrypt_outputs({"y": second})["y"][:3] == [12, 14, 16]
    else:
        assert not torch.equal(second, eager)


def test_in_program_encryptions_are_constants_of_the_program():
    """`secret int v = 7;` encrypts inside the program: host draws and a
    host-to-device copy, which a captured run cannot make. The first run
    records them, later runs get the same ciphertext back."""
    program, inputs, output, _ = PROGRAMS["in_program_encryption"]
    jp = jit_compile_program(program, inputs, output, factory=_port(seed=9))
    r1 = jp.run_raw(jp.secret_inputs)["out"]
    rng_state = jp.factory.context.rng.bit_generator.state
    r2 = jp.run_raw(jp.secret_inputs)["out"]
    assert torch.equal(r1, r2)
    assert jp.factory.context.rng.bit_generator.state == rng_state
    assert [key[0] for key, _ in jp._tape.items] == ["encrypt"]


def test_plain_operands_are_encoded_once():
    program, inputs, output, _ = PROGRAMS["mixed_plain_secret"]
    jp = jit_compile_program(program, inputs, output, factory=_port(seed=9))
    jp.run_raw(jp.secret_inputs)
    keys = [key for key, _ in jp._tape.items]
    assert keys == [("encode", (10,)), ("encode", (5,))]
    held = [value.coeffs for _, value in jp._tape.items]
    jp.run_raw(jp.secret_inputs)
    assert all(a is b.coeffs for a, (_, b) in zip(held, jp._tape.items))


def test_host_constants_tape_refuses_another_order():
    tape = HostConstants()
    assert tape.take("a", lambda: 1) == 1
    assert tape.take("b", lambda: 2) == 2
    tape.end_run(completed=True)
    assert tape.take("a", lambda: 99) == 1
    with pytest.raises(RuntimeExecutionError, match="another host-made"):
        tape.take("c", lambda: 3)
    tape.end_run(completed=False)
    assert tape.take("a", None) == 1
    with pytest.raises(RuntimeExecutionError, match="fewer"):
        tape.end_run(completed=True)
    assert [tape.take(k, None) for k in "ab"] == [1, 2]
    with pytest.raises(RuntimeExecutionError, match="another host-made"):
        tape.take("c", lambda: 3)


def test_a_failed_recording_run_is_forgotten():
    tape = HostConstants()
    tape.take("a", lambda: 1)
    tape.end_run(completed=False)
    assert tape.items == []
    assert tape.take("b", lambda: 2) == 2


def test_context_additions_equal_the_reference():
    """ensure_eval_ready and square against the np64 context of the same
    seed; the factory lowers `x *** x` to square (one operand transform)."""
    from abc_tpu.crypto.bfv import BfvContext as RefContext
    from abc_tpu.crypto.params import BfvParams as RefParams
    factory = _port(seed=11)
    ctx = factory.context
    ref = RefContext(RefParams.create(1024, engine="np64", seed=11))
    ctx.ensure_eval_ready()
    assert ctx._behz is not None
    a, b = ctx.encrypt_many([ctx.encode([3, 4]), ctx.encode([5, 6])])
    ra, rb = ref.encrypt_many([ref.encode([3, 4]), ref.encode([5, 6])])
    np.testing.assert_array_equal(to_host(ctx.square(a).data),
                                  ref.square(ra).data)
    np.testing.assert_array_equal(to_host(ctx.multiply(a, b).data),
                                  ref.multiply(ra, rb).data)
    before = dict(ctx.counters)
    handle = TorchBfvCiphertext(a, factory)
    squared = handle.multiply(handle)
    assert ctx.counters["mult"] == before["mult"] + 1
    assert ctx.counters["op_ntt"] + ctx.counters["op_ntt_hit"] == \
        before["op_ntt"] + before["op_ntt_hit"] + 1
    np.testing.assert_array_equal(
        to_host(squared.ct.data), ref.square(ra, relinearize=False).data)


# ------------------------------------------------------------------- CKKS

CKKS_MULT_ROTATE = dict(
    program_src="secret double p = a *** b; p = rotate(p, 1);",
    inputs_src="secret double a = {1.5, 2.0, -0.5};"
               " secret double b = {0.5, 0.25, 4.0};",
    output_src="yp = p;")


def _ckks_port(seed):
    return CkksCiphertextFactory(n=512, levels=3, seed=seed, device="cpu")


def test_jitted_ckks_program():
    """The whole-program path is backend-generic: a CKKS float program
    through the jit_pack/jit_unpack protocol with (level, scale) as meta.
    Values to the reference test's tolerance; words equal to abc_tpu's own
    jit_compile_program (jx32, one XLA program) of the same seed."""
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory as RefCkks
    jp = jit_compile_program(factory=_ckks_port(seed=4), **CKKS_MULT_ROTATE)
    out = jp.run()["yp"]
    expected = [2.0 * 0.25, -0.5 * 4.0]   # rotated left by 1
    for g, e in zip(out, expected):
        assert abs(g - e) <= 1e-2, (out[:2], expected)
    L, scale = jp.factory.params.L, jp.factory.params.scale
    assert jp._input_meta == {"a": (L, scale), "b": (L, scale)}
    assert jp._out_meta == {"yp": (L, scale * scale)}    # lazy rescale
    ref = ref_jit_compile_program(
        factory=RefCkks(n=512, levels=3, engine="jx32", seed=4),
        **CKKS_MULT_ROTATE)
    for name in ("a", "b"):
        np.testing.assert_array_equal(to_host(jp.secret_inputs[name]),
                                      np.asarray(ref.secret_inputs[name]))
    np.testing.assert_array_equal(
        to_host(jp.run_raw(jp.secret_inputs)["yp"]),
        np.asarray(ref.run_raw(ref.secret_inputs)["yp"]))
    assert out == ref.run()["yp"]


def test_two_programs_of_two_contexts_run_in_turns():
    """Two whole programs of different contexts alive at once (BFV hamming
    at n=1024, a CKKS program at n=512) run in turns for 5 rounds on fresh
    inputs: every run's words equal that program's run alone on the same
    ciphertexts, and abc_tpu's jit_compile_program of the same seed on
    them."""
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory as RefCkks
    rng = np.random.default_rng(11)
    bfv = jit_compile_program(HAMMING_LOOP, XY, "out = sum;",
                              factory=_port(seed=11))
    pairs = rng.integers(0, 2, size=(5, 2, 4)).tolist()
    in_b = [bfv.encrypt_inputs({"x": x, "y": y}) for x, y in pairs]
    alone_b = [bfv.run_raw(i)["out"] for i in in_b]
    ckks = jit_compile_program(factory=_ckks_port(seed=12),
                               **CKKS_MULT_ROTATE)
    vals = rng.uniform(-1.0, 1.0, size=(5, 2, 3))
    in_c = [ckks.encrypt_inputs({"a": list(a), "b": list(b)})
            for a, b in vals]
    alone_c = [ckks.run_raw(i)["yp"] for i in in_c]
    for r in range(5):
        got_b, got_c = bfv.run_raw(in_b[r])["out"], ckks.run_raw(in_c[r])["yp"]
        assert torch.equal(got_b, alone_b[r]) and torch.equal(got_c,
                                                              alone_c[r]), r
        x, y = pairs[r]
        assert bfv.decrypt_outputs({"out": got_b})["out"][0] == \
            sum(u != v for u, v in zip(x, y))
        np.testing.assert_allclose(
            ckks.decrypt_outputs({"yp": got_c})["yp"][:2],
            (vals[r, 0] * vals[r, 1])[1:], atol=1e-2)
    refs = {"out": (ref_jit_compile_program(
                HAMMING_LOOP, XY, "out = sum;",
                factory=RefFactory(slots=1024, engine="jx32", seed=11)),
                in_b, alone_b),
            "yp": (ref_jit_compile_program(
                factory=RefCkks(n=512, levels=3, engine="jx32", seed=12),
                **CKKS_MULT_ROTATE), in_c, alone_c)}
    for name, (ref, inputs, alone) in refs.items():
        for i, words in zip(inputs, alone):
            want = ref.run_raw({k: to_host(v) for k, v in i.items()})[name]
            np.testing.assert_array_equal(to_host(words), np.asarray(want))


def test_ckks_census_discovers_keys(monkeypatch):
    """The dummy-run key census serves CKKS too (both schemes map
    rotate(steps) to galois element 3^(steps mod n/2) mod 2n over the ring
    degree): one multiply + one rotation discovers exactly {relin,
    galois_3}, and key_build makes them before any run."""
    seen = {}
    orig = JittedProgram._census_key_ids

    def spy(self, *a):
        seen["census"] = orig(self, *a)
        return seen["census"]

    monkeypatch.setattr(JittedProgram, "_census_key_ids", spy)
    jp = jit_compile_program(
        "secret double p = a *** b; p = rotate(p, 1);",
        "secret double a = {3.0, 1.0, 4.0};"
        " secret double b = {2.0, 7.0, 1.0};",
        "y = p;", _ckks_port(seed=3))
    assert seen["census"] == {"relin", f"galois_{pow(3, 1, 2 * 512)}"}
    assert set(jp.factory.context._keys) == seen["census"]
    np.testing.assert_allclose(jp.run()["y"][:2], [7.0, 4.0], atol=1e-2)


def test_ckks_streams_fresh_inputs_and_tapes_plain_operands():
    """encrypt_inputs gives full-level, base-scale ciphertexts (the inputs'
    own meta), run_raw serves them; a plaintext operand is an encryption
    under CKKS and goes onto the tape once, keyed by values, level and
    scale, so a second run draws nothing."""
    factory = _ckks_port(seed=6)
    jp = jit_compile_program(
        "secret double t = x *** w; t = t +++ 1.0; return t;",
        "secret double x = {1.0, 2.0, 3.0}; double w = {0.5, 0.5, 2.0};",
        "y = t;", factory=factory)
    np.testing.assert_allclose(jp.run()["y"][:3], [1.5, 2.0, 7.0], atol=1e-2)
    L, scale = factory.params.L, factory.params.scale
    assert [key for key, _ in jp._tape.items] == [
        ("encrypt", (0.5, 0.5, 2.0), L, scale),
        ("encrypt", (1.0,), L, scale * scale)]
    rng_state = factory.context.rng.bit_generator.state
    again = jp.run_raw(jp.secret_inputs)["y"]
    assert factory.context.rng.bit_generator.state == rng_state
    assert torch.equal(again, jp.run_raw(jp.secret_inputs)["y"])
    fresh = jp.encrypt_inputs({"x": [4.0, -2.0, 0.5]})
    assert fresh["x"].shape == jp.secret_inputs["x"].shape
    got = jp.decrypt_outputs(jp.run_raw(fresh))["y"]
    np.testing.assert_allclose(got[:3], [3.0, 0.0, 2.0], atol=1e-2)


@pytest.mark.parametrize("repaired", [True, False])
def test_ckks_two_runs_on_one_tensor_with_new_contents(monkeypatch, repaired):
    """The stale-cache trap under CKKS: two run_raw calls on different
    inputs held in the SAME tensors (what a graph's static inputs are). The
    program rotates its input, so the run goes through the identity-keyed
    decomposition cache; with CkksContext.fresh_caches taken out, the second
    run key-switches the first input's decomposition."""
    factory = _ckks_port(seed=9)
    ctx = factory.context
    if not repaired:
        monkeypatch.setattr(ctx, "fresh_caches", contextlib.nullcontext)
    jp = jit_compile_program(
        "secret double r = rotate(a, 1) +++ rotate(a, 2); return r;",
        "secret double a = {1.0, 2.0, 3.0, 4.0};", "y = r;", factory=factory)
    static = {k: v.clone() for k, v in jp.secret_inputs.items()}
    first = jp.run_raw(static)["y"]
    fresh = jp.encrypt_inputs({"a": [10.0, 20.0, 30.0, 40.0]})
    static["a"].copy_(fresh["a"])
    second = jp.run_raw(static)["y"]
    a = jp.factory.jit_unpack(fresh["a"].clone(), jp._input_meta["a"]).ct
    eager = ctx.add(ctx.rotate(a, 1), ctx.rotate(a, 2)).data
    np.testing.assert_allclose(jp.decrypt_outputs({"y": first})["y"][:2],
                               [5.0, 7.0], atol=1e-2)
    if repaired:
        assert torch.equal(second, eager)
        np.testing.assert_allclose(
            jp.decrypt_outputs({"y": second})["y"][:2], [50.0, 70.0],
            atol=1e-2)
    else:
        assert not torch.equal(second, eager)


def test_ckks_factory_refuses_mesh_like_bfv():
    with pytest.raises(RuntimeExecutionError, match="Mesh with axes"):
        jit_compile_program(factory=_ckks_port(seed=4), mesh=object(),
                            **CKKS_MULT_ROTATE)


# ------------------------------------------------------------- refusals

def test_mesh_and_batch_values_wait_for_the_multi_gpu_slice():
    """The multi-GPU slice is here (tests/test_torch_jit_mesh.py): what is
    still refused is a mesh that is not a ("dp", "limb") Mesh and a batch
    without a mesh to shard it over."""
    for kwargs, match in (({"mesh": object()}, "Mesh with axes"),
                          ({"batch_values": {"a": [[1], [2]]}},
                           "needs mesh=")):
        with pytest.raises(RuntimeExecutionError, match=match):
            jit_compile_program(factory=_port(seed=9), **MULT_ROTATE,
                                **kwargs)


def test_float_program_under_auto_params_waits_for_ckks():
    """The float program that used to wait for CKKS now runs under it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jit_compile_program("secret double acc = w0 * w0; return acc;",
                                 "secret double w0 = {1.5,2.0};",
                                 "out = acc;", auto_params=True,
                                 device="cpu", seed=5)
    assert isinstance(jp.factory, CkksCiphertextFactory)
    assert jp.factory.context.device.type == "cpu"
    np.testing.assert_allclose(jp.run()["out"][:2], [2.25, 4.0], atol=1e-2)


def test_factory_and_auto_params_exclude_each_other():
    with pytest.raises(RuntimeExecutionError, match="factory=None"):
        jit_compile_program(factory=_port(seed=9), auto_params=True,
                            **MULT_ROTATE)
    with pytest.raises(RuntimeExecutionError, match="pass a factory"):
        jit_compile_program(**MULT_ROTATE)
    with pytest.raises(RuntimeExecutionError, match="whole-program protocol"):
        jit_compile_program(factory=DummyCiphertextFactory(64), **MULT_ROTATE)


def test_cuda_device_without_gpu_raises(monkeypatch):
    """No CPU fallback: the default device is the card, and asking for it
    where there is none is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit_compile_program(HAMMING_LOOP, XY, "out = sum;", auto_params=True,
                            options=CompileOptions(vectorize=True), seed=4)


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_graph_replay_equals_eager_on_cuda(cuda):
    jp = jit_compile_program(factory=_port(seed=9, device=cuda),
                             **MULT_ROTATE)
    cpu = jit_compile_program(factory=_port(seed=9), **MULT_ROTATE)
    assert jp._graph is not None
    assert {"warmup", "capture"} <= set(jp.phase_ms)
    assert jp.device_bytes["graph_pool"] > 0
    first = jp.run_raw(jp.secret_inputs)["y"]
    assert torch.equal(first.cpu(), cpu.run_raw(cpu.secret_inputs)["y"])
    fresh = jp.encrypt_inputs({"a": [2, 2, 2, 2], "b": [5, 6, 7, 8]})
    counters = dict(nk.launches), dict(jp.factory.context.counters)
    second = jp.run_raw(fresh)["y"]
    torch.cuda.synchronize()
    assert (dict(nk.launches), dict(jp.factory.context.counters)) == counters
    assert torch.equal(second, jp.run_eager(fresh)["y"])
    assert jp.decrypt_outputs({"y": second})["y"][:3] == [12, 14, 16]
    assert jp.decrypt_outputs({"y": first})["y"][:3] == [7, 4, 8]
