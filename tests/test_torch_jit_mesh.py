"""Whole programs on a mesh (abc_tpu_torch.runtime.jit_executor with mesh=,
batch_values=) against abc_tpu: every case of tests/test_jit_mesh.py on a
LocalComm mesh of dp=2 × limb=4 shards at n=256. The compiled hamming and
CKKS programs give the raw output words of abc_tpu's mesh run on its 8
virtual devices (np.testing.assert_array_equal; residues are canonical) and
decrypt to the single-device runs and the oracle; the limb psum shows in
the mesh's census; the indivisible-limb warning and the mesh / batch_values
errors are the reference's.
"""

import warnings

import numpy as np
import pytest
import torch

from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.parallel.dryrun import build_context
from abc_tpu_torch.parallel.mesh import coeff_mesh
from abc_tpu_torch.parallel.report import collective_report
from abc_tpu_torch.parallel.sharding import make_mesh
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.jit_executor import jit_compile_program
from abc_tpu_torch.utils.errors import RuntimeExecutionError

HAMMING = """
    int sum = 0;
    for (int i = 0; i < n; i = i + 1) {
      sum = sum + (x[i]-y[i])*(x[i]-y[i]);
    }
    return sum;
"""

XS = [[1, 1, 0, 1], [0, 1, 1, 1], [1, 0, 1, 0], [1, 1, 1, 1]]
YS = [[1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 1, 0], [0, 0, 0, 0]]
CKKS_PROG = ("secret double acc = w0 * w1; acc = acc + rotate(w0, 1); "
             "return acc;")
CKKS_INPUTS = ("secret double w0 = {1.0,2.0,3.0}; "
               "secret double w1 = {0.5,0.25,2.0};")
W0S = [[1.0, 2.0, 3.0], [0.5, -1.0, 2.5], [4.0, 0.0, 1.0], [-2.0, 3.0, 0.5]]
W1S = [[0.5, 0.25, 2.0], [1.0, 1.0, 1.0], [0.25, 2.0, -1.0], [2.0, 0.5, 0.5]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hamming(x, y):
    return sum(int(a != b) for a, b in zip(x, y))


def _inputs_src(x, y):
    return (f"secret int x = {{{','.join(map(str, x))}}}; "
            f"secret int y = {{{','.join(map(str, y))}}}; int n = 4;")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(dp=2, limb=4, device="cpu")


def _ref_mesh():
    import jax
    from abc_tpu.parallel.sharding import make_mesh as ref_make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax, ref_make_mesh(dp=2, limb=4)


def test_compiled_hamming_on_mesh_matches_single_device(mesh):
    """The reference workload compiled once and run dp=2 × limb=4: a batch
    of 4 independent input pairs, every rotation/relinearization key switch
    limb-sharded. Decrypted outputs equal the single-device runs and the
    oracle; raw words equal abc_tpu's mesh run."""
    from abc_tpu.parallel.dryrun import build_context as ref_build_context
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFac
    from abc_tpu.runtime.jit_executor import (
        jit_compile_program as ref_jit_compile_program)

    factory = BfvCiphertextFactory(context=build_context(
        n=256, data_limbs=4, seed=21, device="cpu"))
    jp = jit_compile_program(
        HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
        mesh=mesh, batch_values={"x": XS, "y": YS})
    assert jp._limb_ok and jp.rows == [0, 1, 2, 3]
    raw = jp.run_raw(jp.secret_inputs)
    got = [row[0] for row in jp.decrypt_outputs(raw)["out"]]

    f_single = BfvCiphertextFactory(context=build_context(
        n=256, data_limbs=4, seed=21, device="cpu"))
    singles = [jit_compile_program(HAMMING, _inputs_src(x, y), "out = sum;",
                                   f_single).run()["out"][0]
               for x, y in zip(XS, YS)]
    assert got == [_hamming(x, y) for x, y in zip(XS, YS)]
    assert got == singles

    _, rmesh = _ref_mesh()
    rjp = ref_jit_compile_program(
        HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;",
        RefFac(context=ref_build_context(n=256, data_limbs=4, seed=21)),
        mesh=rmesh, batch_values={"x": XS, "y": YS})
    for name in ("x", "y"):
        np.testing.assert_array_equal(np.asarray(rjp.secret_inputs[name]),
                                      to_host(jp.secret_inputs[name]))
    np.testing.assert_array_equal(
        np.asarray(rjp.run_raw(rjp.secret_inputs)["out"]),
        to_host(raw["out"]))


def test_mesh_program_emits_limb_psum(mesh):
    """The mesh program CONTRACTS over "limb": its walk runs all-reduce
    collectives (the modular psums of the key-switch inner product) — dp
    alone moves no bytes."""
    factory = BfvCiphertextFactory(context=build_context(
        n=256, data_limbs=4, seed=22, device="cpu"))
    jp = jit_compile_program(
        HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
        mesh=mesh, batch_values={"x": XS, "y": YS})
    rep = collective_report(jp.mesh, jp.run_eager, jp.secret_inputs)
    assert "all-reduce" in rep and rep["all-reduce"]["ops"] >= 1, rep
    assert set(rep) == {"all-reduce"}


def test_mesh_rejects_bad_batch(mesh):
    factory = BfvCiphertextFactory(context=build_context(
        n=256, data_limbs=4, seed=23, device="cpu"))
    with pytest.raises(RuntimeExecutionError, match="divisible"):
        jit_compile_program(
            HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
            mesh=mesh, batch_values={"x": XS[:3], "y": YS[:3]})
    with pytest.raises(RuntimeExecutionError, match="row counts differ"):
        jit_compile_program(
            HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
            mesh=mesh, batch_values={"x": XS, "y": YS[:2]})
    with pytest.raises(RuntimeExecutionError, match="needs mesh="):
        jit_compile_program(
            HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
            batch_values={"x": XS, "y": YS})
    with pytest.raises(RuntimeExecutionError, match="Mesh with axes"):
        jit_compile_program(
            HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
            mesh=coeff_mesh(8, device="cpu"))


def test_mesh_plain_and_secret_mix(mesh):
    """dp-batched program with ct·ct multiply + plaintext ops + rotation:
    covers relin + galois key switches through the mesh path."""
    factory = BfvCiphertextFactory(context=build_context(
        n=256, data_limbs=4, seed=24, device="cpu"))
    prog = ("secret int acc = a * b; acc = acc + rotate(a, 1); "
            "acc = acc + 3; return acc;")
    a_rows = [[1, 2, 3, 4], [5, 6, 7, 8]]
    b_rows = [[2, 2, 2, 2], [1, 0, 1, 0]]
    jp = jit_compile_program(
        prog, "secret int a = {1,2,3,4}; secret int b = {2,2,2,2};",
        "out = acc;", factory, mesh=mesh,
        batch_values={"a": a_rows, "b": b_rows})
    out = jp.run()
    for row, av, bv in zip(out["out"], a_rows, b_rows):
        ap = av + [av[-1]] * 4          # last-element padding into view
        exp = [av[i] * bv[i] + ap[i + 1] + 3 for i in range(4)]
        assert row[:4] == exp, (row[:4], exp)
    # serving: fresh rows through the same program
    fresh_a = [[2, 2, 2, 2], [1, 1, 1, 1]]
    rows = jp.decrypt_outputs(jp.run_raw(jp.encrypt_inputs(
        {"a": fresh_a})))["out"]
    for row, av, bv in zip(rows, fresh_a, b_rows):
        assert row[:4] == [av[i] * bv[i] + av[i] + 3 for i in range(4)]
    with pytest.raises(RuntimeExecutionError, match="expected 2 rows"):
        jp.encrypt_inputs({"a": [[1, 2, 3, 4]]})


def test_compiled_ckks_program_on_mesh_dp(mesh):
    """CKKS programs run the mesh path on the dp axis (keys whole: the
    leveled digit count varies per switch). Decrypted values match the
    single-device runs within CKKS tolerance (1e-2, the reference test's);
    raw words equal abc_tpu's mesh run."""
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory as RefFac
    from abc_tpu.runtime.jit_executor import (
        jit_compile_program as ref_jit_compile_program)
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory

    factory = CkksCiphertextFactory(n=512, levels=4, seed=9, scale_bits=30,
                                    device="cpu")
    jp = jit_compile_program(CKKS_PROG, CKKS_INPUTS, "out = acc;", factory,
                             mesh=mesh, batch_values={"w0": W0S, "w1": W1S})
    assert not jp._limb_ok
    raw = jp.run_raw(jp.secret_inputs)
    rows = jp.decrypt_outputs(raw)["out"]

    f_single = CkksCiphertextFactory(n=512, levels=4, seed=9, scale_bits=30,
                                     device="cpu")
    for row, w0, w1 in zip(rows, W0S, W1S):
        pad = w0 + [w0[-1]]
        want = [w0[i] * w1[i] + pad[i + 1] for i in range(3)]
        ins = (f"secret double w0 = {{{','.join(map(str, w0))}}}; "
               f"secret double w1 = {{{','.join(map(str, w1))}}};")
        single = jit_compile_program(CKKS_PROG, ins, "out = acc;",
                                     f_single).run()["out"]
        assert np.allclose(row[:3], want, atol=1e-2), (row[:3], want)
        assert np.allclose(row[:3], single[:3], atol=1e-2)

    _, rmesh = _ref_mesh()
    rjp = ref_jit_compile_program(
        CKKS_PROG, CKKS_INPUTS, "out = acc;",
        RefFac(n=512, levels=4, engine="jx32", seed=9, scale_bits=30),
        mesh=rmesh, batch_values={"w0": W0S, "w1": W1S})
    np.testing.assert_array_equal(
        np.asarray(rjp.run_raw(rjp.secret_inputs)["out"]),
        to_host(raw["out"]))


def test_mesh_falls_back_when_limb_axis_indivisible(mesh):
    """A preset whose switching-key digit count the limb axis does not
    divide (the 30-bit chains have α ∈ {5, 6, 13, 27}) runs dp-only with
    whole keys and a warning naming the constraint."""
    from abc_tpu_torch.passes.pipeline import CompileOptions

    bv = {"x": [[1, 1, 0, 1], [1, 0, 1, 1], [0, 0, 1, 1], [1, 1, 1, 1]],
          "y": [[1, 0, 1, 1], [1, 0, 1, 1], [1, 1, 0, 0], [0, 1, 1, 0]]}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jp = jit_compile_program(
            "secret int acc = (x-y)*(x-y); acc = acc + rotate(acc, 2); "
            "acc = acc + rotate(acc, 1); return acc;",
            "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};",
            "out = acc;", options=CompileOptions(vectorize=True),
            auto_params=True, seed=7, mesh=mesh, batch_values=bv,
            device="cpu")
        out = np.asarray(jp.run()["out"])
    assert any("limb mesh axis" in str(x.message) for x in w)
    assert not jp._limb_ok
    for i, (xr, yr) in enumerate(zip(bv["x"], bv["y"])):
        assert out[i, 0] == sum((a - b) ** 2 for a, b in zip(xr, yr))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_hamming_on_mesh_as_one_graph_on_cuda(cuda):
    """The mesh program on 8 shards of the card is one CUDA graph; its
    replay gives the words of the port's CPU mesh run, and a replay moves
    no launch count."""
    from abc_tpu_torch.ops import ntt_kernels as nk

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        factory = BfvCiphertextFactory(context=build_context(
            n=8192, data_limbs=8, seed=17, device=dev))
        runs[dev.type] = jit_compile_program(
            HAMMING, _inputs_src(XS[0], YS[0]), "out = sum;", factory,
            mesh=make_mesh(dp=2, limb=4, device=dev),
            batch_values={"x": XS, "y": YS})
    jp = runs["cuda"]
    assert jp._graph is not None and jp._limb_ok
    before = dict(nk.launches)
    raw = jp.run_raw(jp.secret_inputs)
    assert nk.launches == before
    cpu = runs["cpu"]
    assert torch.equal(raw["out"].cpu(),
                       cpu.run_raw(cpu.secret_inputs)["out"])
    assert [r[0] for r in jp.decrypt_outputs(raw)["out"]] == \
        [_hamming(x, y) for x, y in zip(XS, YS)]


@pytest.mark.gpu
def test_dryrun_multichip_on_cuda(cuda):
    from abc_tpu_torch import entry

    rep = entry.dryrun_multichip(8)
    assert rep["production"]["bfv"]["n"] == 8192
    assert rep["production"]["ckks"]["n"] == 32768
    assert "all-reduce" in rep["production"]["bfv"]["collectives_per_step"]
    assert "collective-permute" in \
        rep["production"]["ckks"]["collectives_per_step"]


def test_dryrun_on_cpu_and_its_entry_point_wants_the_card(monkeypatch):
    """The reference's dryrun_multichip at its small shapes on 8 shards of
    the CPU (the production shapes are the card's: phase 13); the entry
    point itself has no CPU fallback."""
    from abc_tpu_torch import entry
    from abc_tpu_torch.parallel.dryrun import run_dryrun

    rep = run_dryrun(8, n=256, device="cpu", verbose=False, production=False)
    assert rep["bfv"]["mesh"] == {"dp": 2, "limb": 4}
    assert rep["bfv"]["collectives_per_step"]["all-reduce"]["ops"] == 2
    assert rep["compiled_program"]["limb_sharded"] is True
    assert rep["ckks"]["coeff_shards"] == 8 and rep["ckks"]["max_err"] < 0.05
    assert rep["ckks"]["timer"].startswith("host clock")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        entry.dryrun_multichip(8)
