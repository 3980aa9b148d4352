"""abc_tpu_torch.ops.elementwise_kernels (K9b: the RNS elementwise kernel)
and the tails of keyswitch_kernels.mod_down (K9a, whose source is tested in
test_torch_keyswitch_kernels.py): the CPU route, reached through BfvContext
and CkksContext, against abc_tpu's np64 contexts word for word;
csrc/elementwise.cu compiled for the host against the stub runtime of
tests/host_cuda and held word-equal to the plain versions in every op,
broadcast form and component-0 form; the routing; and, on a CUDA device,
every op against its plain version at the main paths' shapes.

Inputs are drawn with numpy from a seed; residues are integers, so the
tolerance is exact equality.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.ckks import CkksContext as RefCkksContext
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops.modarith import as_residues, ratio_table, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

HOST_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "host_cuda")
N_REF = 1024              # the CPU route against the reference
VALS_A, VALS_B = [1, -2, 3000, 4, 77], [9, 8, -7, 6, -1]
# (n, L, rows, U) of the host build's launches on a card of one SM (2048
# threads an SM): U = 2 from one full load of the card (2048 quads) where a
# block's 128 threads x 2 quads fit one line (n >= 1024), else 1
EW_WIDE_CASES = [(1024, 4, 2, 2), (1024, 3, 3, 2), (2048, 4, 2, 2),
                 (2048, 5, 3, 2), (256, 7, 6, 1), (512, 4, 8, 1)]
# {(output lines, n): U} of the plan on the stub's card of 132 SMs: 2 from
# 270 336 quads
EW_PLANS = {(12, 8192): 1, (26, 16384): 1, (16, 32768): 1, (768, 8192): 2,
            (131, 8192): 1, (132, 8192): 2, (1056, 1024): 2, (1055, 1024): 1,
            (3000, 512): 1, (100000, 256): 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _moduli(n, L):
    return gen_ntt_primes(30, L, n)


def _rand(moduli, shape, seed, edge=None):
    """int32 residues of `shape` ([..., L, n]) over the L moduli, with 0
    and q-1 among them, or all 0 (`edge` "zero") or all q-1 ("max")."""
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    if edge == "zero":
        x = np.zeros(shape, dtype=np.uint64)
    elif edge == "max":
        x = np.broadcast_to(q - 1, shape).copy()
    else:
        x = np.random.default_rng(seed).integers(0, q, size=shape,
                                                 dtype=np.uint64)
        x[..., 0] = 0
        x[..., 1::5] = (q - 1)
    return as_residues(x, "cpu")


def _tables(moduli):
    q = as_residues(np.asarray(moduli, np.uint32).reshape(-1, 1), "cpu")
    return q, ratio_table(moduli, "cpu")


# ---------------------- the kernel source, compiled for the host (g++)

def _host_build(tmp_path_factory, sms):
    """csrc/elementwise.cu compiled by g++ against tests/host_cuda's stub
    runtime (a launch runs its blocks in turn, a std::thread per thread),
    on a card of `sms` SMs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("ew_host") / f"libew_host{sms}.so"
    src = [s for s in _build.SOURCES if s.endswith("elementwise.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}",
                    f"-DHOST_CUDA_SMS={sms}", src, "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_elementwise(lib)
    return lib


@pytest.fixture(scope="module")
def host_ew(tmp_path_factory):
    """The host build on the stub's card of an H100's 132 SMs."""
    return _host_build(tmp_path_factory, 132)


@pytest.fixture(scope="module")
def host_ew_one_sm(tmp_path_factory):
    """The host build on a card of one SM, whose plans take U = 2 quads a
    thread from a few blocks (2048 quads)."""
    return _host_build(tmp_path_factory, 1)


def _host_ew(lib, op, a, b, q, ratio, w=None, first=False):
    """One call of the host build with the arguments the wrapper passes."""
    shape, args = ew._args(op, a, b, q, ratio, w, first)
    out = torch.full(shape, -1, dtype=torch.int32)
    assert lib.abc_rns_ew(*args(out), None) == 0
    return out


def _forms(moduli, n, seed, edge, dev="cpu", rows=3):
    """{form: (op, a, b, w, first)} on `dev`: every op on operands of one
    shape ([rows, 2, L, n]), a plaintext over every component and row, an
    [n] coefficient vector over the limbs too, with and without a
    multiplier w, a column, the component-0 forms, fewer leading rows, and
    views read in place (a batch's components, a level's limbs of a wider
    ciphertext)."""
    L = len(moduli)

    def rand(mods, shape, s, e=edge):
        return _rand(mods, shape, s, e).to(dev)

    a = rand(moduli, (rows, 2, L, n), seed)
    b = rand(moduli, (rows, 2, L, n), seed + 1)
    plane = rand(moduli, (L, n), seed + 2)
    coeffs = rand(moduli[:1], (1, n), seed + 3)[0] % 65537
    w = rand(moduli, (L, 1), seed + 4, None)
    col = rand(moduli, (L, 1), seed + 5)
    wide = rand(moduli + moduli[:2], (rows, 3, L + 2, n), seed + 6)
    view = wide[:, 1:3, :L]
    forms = {}
    for op in ("add", "sub", "mul"):
        forms[f"{op} same shape"] = (op, a, b, None, False)
        forms[f"{op} plaintext"] = (op, a, plane, None, False)
        forms[f"{op} fewer rows"] = (op, a, b[0], None, False)
        forms[f"{op} views"] = (op, view, a, None, False)
        forms[f"{op} [L, n]"] = (op, plane, b[1, 0], None, False)
    forms["mul column"] = ("mul", a, col, None, False)
    forms["mul column view"] = ("mul", view, col, None, False)
    forms["neg"] = ("neg", a, None, None, False)
    forms["neg view"] = ("neg", view, None, None, False)
    for op in ("add", "sub", "neg"):
        forms[f"{op} c0 plaintext"] = (op, a, plane, None, True)
        forms[f"{op} c0 coefficients w"] = (op, a, coeffs.expand(L, -1), w,
                                            True)
        forms[f"{op} c0 view"] = (op, view, plane, w, True)
    forms["add coefficients w"] = ("add", a, coeffs.expand(L, -1), w, False)
    return forms


@pytest.mark.parametrize("edge", [None, "zero", "max"])
@pytest.mark.parametrize("n,L", [(4, 3), (64, 5), (256, 2)])
def test_every_form_on_the_host(host_ew, n, L, edge):
    """Every op, broadcast form and component-0 form of the host build
    equals the plain t64 chain, word for word, on random residues with 0
    and q-1 among them and on all-0 and all-(q-1) inputs."""
    moduli = _moduli(max(n, 8), L)
    q, ratio = _tables(moduli)
    for form, (op, a, b, w, first) in _forms(moduli, n, n + L,
                                              edge).items():
        want = ew.ew_plain(op, a, b, q, w, first)
        got = _host_ew(host_ew, op, a, b, q, ratio, w, first)
        assert torch.equal(got, want), form


def _host_plan(lib, op, lines, n):
    info = (ctypes.c_longlong * 6)()
    assert lib.abc_ew_launch_info(ew.OPS[op], lines, n.bit_length() - 1,
                                  info) == 0
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm"), info))


@pytest.mark.parametrize("edge", [None, "max"])
@pytest.mark.parametrize("n,L,rows,U", EW_WIDE_CASES)
def test_wide_plans_on_the_host(host_ew_one_sm, n, L, rows, U, edge):
    """Where the plan gives a thread U = 2 quads (a card of one SM: from
    2048 quads; U = 1 below n = 1024, where a block's 128 threads x 2 quads
    take more than one line), every op and form of the host build equals
    the plain chain, on random residues and all-(q-1) inputs, and a ragged
    grid (n = 256: 64 quads a line) too."""
    moduli = _moduli(n, L)
    q, ratio = _tables(moduli)
    assert _host_plan(host_ew_one_sm, "add", rows * 2 * L, n)["arg0"] == U
    for form, (op, a, b, w, first) in _forms(moduli, n, n + L, edge,
                                              rows=rows).items():
        want = ew.ew_plain(op, a, b, q, w, first)
        got = _host_ew(host_ew_one_sm, op, a, b, q, ratio, w, first)
        assert torch.equal(got, want), form


def test_plan_choice_on_the_host(host_ew):
    """abc_ew_launch_info on the stub's card (132 SMs): U quads a thread by
    the launch's size, each op alike, 2 only where a block's 128 x 2 quads
    fit one line (n >= 1024), blocks of 128 threads."""
    for (lines, n), U in EW_PLANS.items():
        for op in ew.OPS:
            got = _host_plan(host_ew, op, lines, n)
            assert got["arg0"] == U, (lines, n, op)
            assert (got["threads"], got["blocks"]) == \
                (128, -(-lines * n // 4 // (128 * U))), (lines, n, op)
    info = (ctypes.c_longlong * 6)()
    assert host_ew.abc_ew_launch_info(4, 12, 13, info) != 0
    assert host_ew.abc_ew_launch_info(0, 12, 1, info) != 0


def test_division_by_multiply_and_shift():
    """The kernels' 32-bit index split (rns_common.cuh: Div, div_by, quot),
    mirrored: with l = ceil(log2 d) and m = ceil(2^(31+l) / d), m < 2^32
    and (x m) >> (31 + l) = x // d for every x below 2^31, at every d up to
    3000, at d = 2^30 - 1, 2^30 and 2^31 - 1, and at the edges x = 0, d - 1,
    d, d + 1, 2^31 - 1 and random x."""
    rng = np.random.default_rng(5)
    ds = list(range(1, 3001)) + [2 ** 30 - 1, 2 ** 30, 2 ** 31 - 1] + \
        [int(v) for v in rng.integers(3001, 2 ** 31, size=200)]
    for d in ds:
        l = next(i for i in range(32) if (1 << i) >= d)
        m = -(-(1 << (31 + l)) // d)
        assert m < 1 << 32, d
        xs = [0, d - 1, d, d + 1, 2 ** 31 - 1] + \
            [int(v) for v in rng.integers(0, 2 ** 31, size=20)]
        for x in xs:
            if x < 2 ** 31:
                assert (x * m) >> (31 + l) == x // d, (x, d)


def test_host_refusals(host_ew):
    """Operands the kernel does not take are refused, by the wrapper's
    checks and by the entry point."""
    moduli = _moduli(64, 3)
    q, ratio = _tables(moduli)
    a = _rand(moduli, (2, 3, 64), 1)
    with pytest.raises(ValueError, match="consecutive"):
        ew._args("add", a[..., ::2], a[..., ::2], q[:, :1], ratio, None,
                 False)
    wide = _rand(moduli, (2, 2, 2, 3, 64), 2).transpose(0, 1)
    with pytest.raises(ValueError, match="one stride"):
        ew._args("add", wide, wide, q, ratio, None, False)
    with pytest.raises(ValueError, match="table q"):
        ew._args("add", a, a, q[:2], ratio, None, False)
    with pytest.raises(ValueError, match="component-0"):
        ew._args("add", a[0], a[0], q, ratio, None, True)
    # no b for add; neg with b only in the component-0 form; a rows that do
    # not divide the output's
    assert host_ew.abc_rns_ew(0, a.data_ptr(), 1, 0, 0, 64, None, 1, 0, 0,
                              0, 0, None, a.data_ptr(), q.data_ptr(),
                              ratio.data_ptr(), 1, 2, 3, 0, 6, None) != 0
    assert host_ew.abc_rns_ew(3, a.data_ptr(), 1, 0, 0, 64, a.data_ptr(), 1,
                              0, 0, 64, 0, None, a.data_ptr(), q.data_ptr(),
                              ratio.data_ptr(), 1, 2, 3, 0, 6, None) != 0
    assert host_ew.abc_rns_ew(0, a.data_ptr(), 3, 192, 0, 64, a.data_ptr(),
                              1, 0, 0, 64, 0, None, a.data_ptr(),
                              q.data_ptr(), ratio.data_ptr(), 2, 1, 3, 0, 6,
                              None) != 0


# -------------------------------------------- the CPU route vs the reference

@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def bfv_pair(request):
    """(port BfvContext on the CPU, abc_tpu np64 BfvContext): n=1024,
    seed 7, k special primes."""
    k = request.param
    return (BfvContext(BfvParams.create(N_REF, seed=7, ks_digits=k), "cpu"),
            RefBfvContext(RefBfvParams.create(N_REF, seed=7, engine="np64",
                                              ks_digits=k)))


def _same(port_data, ref_data):
    np.testing.assert_array_equal(to_host(port_data), np.asarray(ref_data))


BFV_CASES = {
    "relinearize": lambda c, a, b, pt: [
        c.relinearize(c.multiply(a, b, relinearize=False))],
    "rotate_rows": lambda c, a, b, pt: [c.rotate_rows(a, 3),
                                        c.rotate_rows(a, -5),
                                        c.rotate_columns(b)],
    "hoisted_rotations": lambda c, a, b, pt: c.hoisted_rotations(
        a, [1, 5, 0, N_REF // 2 - 1]),
    "add_plain": lambda c, a, b, pt: [c.add_plain(a, pt),
                                      c.sub_plain(b, pt)],
    "sub_from_plain": lambda c, a, b, pt: [c.sub_from_plain(a, pt),
                                           c.negate(b), c.add(a, b),
                                           c.sub(a, b)],
    "multiply_plain": lambda c, a, b, pt: [c.multiply_plain(a, pt)],
}


@pytest.mark.parametrize("case", sorted(BFV_CASES))
def test_bfv_route_matches_np64(bfv_pair, case):
    """The CPU route of every routed BFV call equals abc_tpu's np64 engine
    for the same seed, word for word, and launches nothing."""
    port, ref = bfv_pair
    a, b = port.encrypt(port.encode(VALS_A)), port.encrypt(port.encode(VALS_B))
    ra, rb = ref.encrypt(ref.encode(VALS_A)), ref.encrypt(ref.encode(VALS_B))
    _same(a.data, ra.data)
    before = {**ew.launches, **kk.launches}
    got = BFV_CASES[case](port, a, b, port.encode(VALS_B))
    want = BFV_CASES[case](ref, ra, rb, ref.encode(VALS_B))
    assert {**ew.launches, **kk.launches} == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g.data, w.data)


@pytest.fixture(scope="module")
def ckks_pair():
    """(port CkksContext on the CPU, abc_tpu np64 CkksContext): n=1024,
    4 data primes, k=2, scale 2^25, seed 9."""
    kw = dict(levels=4, seed=9, ks_digits=2, scale_bits=25)
    return (CkksContext(CkksParams.create(N_REF, **kw), "cpu"),
            RefCkksContext(RefCkksParams.create(N_REF, engine="np64", **kw)))


def test_ckks_route_matches_np64(ckks_pair):
    """CKKS add, sub, the integer multiply of scale alignment, the
    plaintext product, relinearize and rotations (at full level and at a
    level below) equal the np64 engine's words."""
    port, ref = ckks_pair
    vals = [0.5, -1.25, 3.0, 0.125]
    a, ra = port.encrypt(port.encode(vals)), ref.encrypt(ref.encode(vals))
    b = port.encrypt(port.encode(vals[::-1]))
    rb = ref.encrypt(ref.encode(vals[::-1]))
    _same(a.data, ra.data)
    low, rlow = port.mod_drop_to(a, 2), ref.mod_drop_to(ra, 2)
    pairs = [
        (port.add(a, b), ref.add(ra, rb)), (port.sub(a, b), ref.sub(ra, rb)),
        (port._scale_lift(a, 5), ref._scale_lift(ra, 5)),
        (port._scale_lift(low, 7), ref._scale_lift(rlow, 7)),
        (port.multiply_plain(a, port.encode(vals)),
         ref.multiply_plain(ra, ref.encode(vals))),
        (port.multiply(a, b, rescale=False),
         ref.multiply(ra, rb, rescale=False)),
        (port.rotate(a, 3), ref.rotate(ra, 3)),
        (port.rotate(low, 1), ref.rotate(rlow, 1))]
    pairs += list(zip(port.hoisted_rotations(b, [1, 2]),
                      ref.hoisted_rotations(rb, [1, 2])))
    for got, want in pairs:
        assert (got.level, got.scale) == (want.level, want.scale)
        _same(got.data, want.data)


# ---------------------------------------------------------------- the routing

def test_a_tensor_off_the_cpu_is_never_taken_by_the_plain_path():
    """Only a CPU tensor takes a plain version: any other device goes to the
    kernel's checks (here meta tensors, refused)."""
    moduli = _moduli(64, 3)
    q = as_residues(np.asarray(moduli, np.uint32).reshape(-1, 1), "meta")
    ratio = ratio_table(moduli, "meta")
    x = torch.empty((2, 3, 64), dtype=torch.int32, device="meta")
    div = kk.Division(moduli + _moduli(64, 4)[3:], 1, "meta")
    acc = torch.empty((2, 4, 64), dtype=torch.int32, device="meta")
    for call in (lambda: ew.add(x, x, q, ratio),
                 lambda: ew.sub(x, x, q, ratio),
                 lambda: ew.mul(x, x, q, ratio), lambda: ew.neg(x, q),
                 lambda: ew.add(x, x[0], q, ratio, first=True),
                 lambda: kk.mod_down(acc, div, kk.Tail("relin", x[None]))):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_launch_counters_name_every_op():
    assert set(ew.launches) == {f"rns_ew_{op}" for op in ew.OPS}


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n,L,lead", [(8192, 6, ()), (8192, 6, (64,)),
                                      (16384, 13, ()), (32768, 8, ())])
def test_every_form_equals_plain_on_cuda(cuda, n, L, lead):
    """Every op and form on the card against its plain version, each one
    launch of its op."""
    moduli = _moduli(n, L)
    q, ratio = _tables(moduli)
    qd, rd = q.to(cuda), ratio.to(cuda)
    for form, (op, a, b, w, first) in _forms(moduli, n, L, None,
                                              cuda).items():
        before = ew.launches[f"rns_ew_{op}"]
        got = ew._ew(op, a, b, qd, rd, w, first)
        torch.cuda.synchronize()
        assert ew.launches[f"rns_ew_{op}"] == before + 1, form
        host = [None if t is None else t.cpu() for t in (a, b, w)]
        assert torch.equal(got.cpu(), ew.ew_plain(op, host[0], host[1], q,
                                                  host[2], first)), form
