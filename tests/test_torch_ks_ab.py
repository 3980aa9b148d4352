"""abc_tpu_torch.scripts.ks_ab, scripts.ew_ab, scripts.rlwe_ab and
scripts.behz_ab (the A/B of a kernel source against other builds of it) on
the CPU: their arguments, their refusal without a card, their shapes
(chip_smoke.py phases 2c's, 2d's and 2e's timed ones), the binding of a
build from before the rotation's tail took g^-1 and of one from before the
scale-and-round wrote its own flag, and ks_ab's, ew_ab's and rlwe_ab's
calls of csrc/keyswitch.cu's, csrc/elementwise.cu's and csrc/rlwe.cu's
entry points, run on host builds of the sources (g++ against
tests/host_cuda's stub runtime) and held word-equal to the plain versions.
Residues are integers, so the tolerance is exact equality."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.scripts import behz_ab, ew_ab, ks_ab, rlwe_ab

HOST_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "host_cuda")


def test_ks_ab_arguments():
    args = ks_ab.parser().parse_args([])
    assert (args.baseline, args.rounds, args.out) == ([], 3, None)
    args = ks_ab.parser().parse_args(
        ["--baseline", "build/parent", "build/v1", "--rounds", "2", "--out",
         "x.jsonl"])
    assert (args.baseline, args.rounds, args.out) == \
        (["build/parent", "build/v1"], 2, "x.jsonl")
    for bad in (["--rounds", "two"], ["--cols", "2"]):
        with pytest.raises(SystemExit):
            ks_ab.parser().parse_args(bad)


def test_ew_ab_arguments():
    args = ew_ab.parser().parse_args([])
    assert (args.baseline, args.rounds, args.out) == ([], 3, None)
    args = ew_ab.parser().parse_args(["--baseline", "build/ab/parent",
                                      "build/ab/u2", "--rounds", "1"])
    assert (args.baseline, args.rounds) == \
        (["build/ab/parent", "build/ab/u2"], 1)
    with pytest.raises(SystemExit):
        ew_ab.parser().parse_args(["--rounds", "one"])


def test_rlwe_ab_arguments():
    args = rlwe_ab.parser().parse_args([])
    assert (args.baseline, args.rounds, args.chain, args.out) == \
        ([], 3, 200, None)
    args = rlwe_ab.parser().parse_args(
        ["--baseline", "build/ab/parent", "build/ab/lanes8", "--rounds", "2",
         "--chain", "0", "--out", "x.jsonl"])
    assert (args.baseline, args.rounds, args.chain, args.out) == \
        (["build/ab/parent", "build/ab/lanes8"], 2, 0, "x.jsonl")
    with pytest.raises(SystemExit):
        rlwe_ab.parser().parse_args(["--chain", "many"])


def test_behz_ab_arguments():
    args = behz_ab.parser().parse_args(["--baseline", "d", "--rounds", "0"])
    assert (args.baseline, args.rounds, args.out) == ("d", 0, None)


@pytest.mark.parametrize("script", [ks_ab, ew_ab, behz_ab, rlwe_ab])
def test_refused_without_a_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        script.main(["--rounds", "1"])


def test_ks_ab_times_phase_2c_shapes():
    assert ks_ab.SHAPES == chip_smoke.KS_TIMED


def test_ew_ab_times_phase_2e_shapes():
    """ew_ab's shapes are phase 2e's timed ones, LaplaceSharpening's
    (16384, 13) among them; the elementwise ops do not depend on k."""
    timed = {(sc, n, L, b) for sc, n, L, _, b, level in chip_smoke.K9_TIMED
             if level == L}
    assert set(ew_ab.SHAPES) == timed
    assert ("bfv", 16384, 13, 1) in ew_ab.SHAPES


def test_rlwe_ab_times_phase_2d_cases():
    """rlwe_ab's forms are phase 2d's timed cases of rlwe_lift and
    bfv_dec_round: every encryption (one ciphertext and B=64 at n=8192,
    one at n=16384, CKKS's at n=32768), the lift of u, the 19 keys' error
    lift and both decryptions."""
    timed = set()
    for what, scheme, n, L, k, K, B in chip_smoke.RLWE_TIMED:
        if what == "enc":
            timed.add(("lift_encrypt", scheme, n, L, B))
            if (scheme, n, B) == ("bfv", 8192, 1):
                timed.add(("lift_u", scheme, n, L, B))
        elif what == "keys" and K == 19:
            timed.add(("lift_errors", scheme, n, L, K))
        elif what == "dec":
            timed.add(("bfv_dec_round", scheme, n, L, 1))
    assert set(rlwe_ab.FORMS) == timed
    assert rlwe_ab.WHOLE == [(8192, 6), (16384, 13)]


def test_a_build_before_flag_words_binds_the_memset_entry():
    """A baseline whose abc_bfv_dec_round zeroes its one flag word by a
    memset (no abc_rlwe_plan) is bound without the flag's length; this
    tree's build with it."""
    class Fn:
        pass

    class Old:
        abc_rlwe_lift, abc_bfv_dec_round = Fn(), Fn()

    class New:
        abc_rns_uniform, abc_ksk_compose = Fn(), Fn()
        abc_rlwe_lift, abc_bfv_dec_round, abc_rlwe_plan = Fn(), Fn(), Fn()

    assert not rlwe_ab.bind(Old) and rlwe_ab.bind(New)
    assert len(Old.abc_bfv_dec_round.argtypes) == 9
    assert len(New.abc_bfv_dec_round.argtypes) == 10
    assert Old.abc_rlwe_lift.argtypes == New.abc_rlwe_lift.argtypes


def test_a_build_before_g_inverse_binds_the_tables():
    """A baseline whose abc_ks_mod_down_tail reads galois_gather's tables
    (no abc_ks_mod_down_plan) is bound with two pointers where this tree's
    takes g^-1."""
    class Fn:
        pass

    class Old:
        abc_ks_decompose, abc_ks_contract = Fn(), Fn()
        abc_ks_mod_down, abc_ks_mod_down_tail = Fn(), Fn()

    class New(Old):
        abc_ks_mod_down_plan = Fn()

    for lib in (Old, New):
        lib.abc_ks_mod_down_tail = Fn()
        ks_ab.bind_two(lib)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert not ks_ab.takes_ginv(Old) and ks_ab.takes_ginv(New)
    assert Old.abc_ks_mod_down_tail.argtypes[-3:] == [vp, vp, vp]
    assert New.abc_ks_mod_down_tail.argtypes[-3:] == [i64, i64, vp]


def test_old_entry_points_bind_without_the_split():
    """A baseline build from before abc_ks_plan binds the two entry points
    with this tree's argument types."""
    class Fn:
        pass

    class Lib:
        abc_ks_decompose, abc_ks_contract = Fn(), Fn()

    class Tree(Lib):
        abc_ks_mod_down = abc_ks_mod_down_tail = abc_ks_mod_down_plan = \
            abc_ks_plan = Fn()

    ks_ab.bind_two(Lib)
    _build.bind_keyswitch(Tree)
    assert len(Lib.abc_ks_decompose.argtypes) == 13
    assert len(Lib.abc_ks_contract.argtypes) == 13
    assert Lib.abc_ks_decompose.argtypes == Tree.abc_ks_decompose.argtypes
    assert Lib.abc_ks_contract.argtypes == Tree.abc_ks_contract.argtypes


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("ks_ab_host") / "libks_host.so"
    src = [s for s in _build.SOURCES if s.endswith("keyswitch.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}", src,
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ks_ab.bind_two(lib)
    assert ks_ab.takes_ginv(lib)
    return lib


@pytest.mark.parametrize("k,batch", [(1, 1), (2, 2)])
def test_ks_ab_calls_on_the_host(host_lib, k, batch):
    """ks_ab's calls, made to a host build of csrc/keyswitch.cu on CPU
    tensors at n=1024 (5 data primes), equal the plain versions: the k = 1
    lift or the k = 2 base conversion, the contraction, the contraction
    with the Galois permutation, the decryption's one-half contraction and
    the mod switch down alone and with either tail."""
    ops = ks_ab.operands("bfv", 1024, 5, k, batch, 5, "cpu")
    calls = ks_ab.calls(host_lib, ops, None)
    for name, (launch, out) in calls.items():
        assert launch() == 0, name
    d, D, q = ops["d"], ops["D"], ops["q"]
    want = kk.lift_plain(d, q) if k == 1 else \
        kk.decompose_plain(d, q, ops["digits"])
    assert torch.equal(calls["ks_decompose"][1], want)
    assert torch.equal(calls["ks_contract"][1],
                       kk.contract_plain(D, ops["kb"], ops["ka"], q))
    assert torch.equal(calls["ks_contract+perm"][1],
                       kk.contract_plain(D, ops["kb"], ops["ka"], q,
                                         ops["perm"]))
    assert torch.equal(calls["ks_contract/1"][1],
                       kk.contract_plain(ops["ct"], ops["sk"], None,
                                         ops["qd"]))
    x, div, prod = ops["x"], ops["division"], ops["prod"]
    assert torch.equal(calls["ks_mod_down"][1], kk.mod_down_plain(x, div))
    assert torch.equal(calls["ks_mod_down_relin"][1], kk.mod_down_plain(
        x, div, kk.Tail("relin", prod)))
    assert torch.equal(calls["ks_mod_down_rotate"][1], kk.mod_down_plain(
        x, div, kk.Tail("rotate", prod[..., 0, :, :], ops["ginv"])))
    assert "ks_mod_down/rescale" not in calls       # BFV: no rescale


def test_ks_ab_rescale_on_the_host(host_lib):
    """At a CKKS shape ks_ab also times the rescale, the mod switch down of
    a ciphertext by its last prime, equal to the plain division."""
    ops = ks_ab.operands("ckks", 1024, 4, 2, 1, 4, "cpu")
    launch, out = ks_ab.calls(host_lib, ops, None)["ks_mod_down/rescale"]
    assert launch() == 0
    assert torch.equal(out, kk.mod_down_plain(ops["ct"], ops["rescale"]))


@pytest.fixture(scope="module")
def host_ew(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("ew_ab_host") / "libew_host.so"
    src = [s for s in _build.SOURCES if s.endswith("elementwise.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}", src,
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_elementwise(lib)
    return lib


@pytest.mark.parametrize("edge", [None, "max"])
def test_ew_ab_calls_on_the_host(host_ew, edge):
    """ew_ab's calls, made to a host build of csrc/elementwise.cu on CPU
    tensors at n=1024 (a batch of 2), equal the plain versions in every
    form, on random and all-(q-1) inputs."""
    ops = ew_ab.operands("bfv", 1024, 3, 2, edge, "cpu")
    calls = ew_ab.calls(host_ew, ops, None)
    assert set(calls) == set(ew_ab.FORMS)
    for form, (launch, out, plain) in calls.items():
        assert launch() == 0, form
        assert torch.equal(out, plain()), form


@pytest.fixture(scope="module")
def host_rlwe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("rlwe_ab_host") / "librlwe_host.so"
    src = [s for s in _build.SOURCES if s.endswith("rlwe.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}", src,
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    assert rlwe_ab.bind(lib)
    return lib


@pytest.mark.parametrize("form,scheme,count", [
    ("lift_encrypt", "bfv", 1), ("lift_encrypt", "bfv", 3),
    ("lift_encrypt", "ckks", 1), ("lift_u", "bfv", 1),
    ("lift_errors", "bfv", 3), ("bfv_dec_round", "bfv", 1)])
@pytest.mark.parametrize("edge", [None, "max"])
def test_rlwe_ab_calls_on_the_host(host_rlwe, form, scheme, count, edge):
    """rlwe_ab's calls, made to a host build of csrc/rlwe.cu on CPU tensors
    at n=1024, equal the plain versions (the scale-and-round's flag too)
    in every form, on random and all-(q-1) inputs with lifts of ±19."""
    L = 5 if scheme == "bfv" else 4
    ops = rlwe_ab.operands(form, scheme, 1024, L, count, edge, "cpu")
    launch, result, plain = rlwe_ab.call(host_rlwe, True, form, ops, None)
    assert launch() == 0
    assert torch.equal(result(), plain())
