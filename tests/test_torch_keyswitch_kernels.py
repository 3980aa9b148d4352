"""abc_tpu_torch.ops.keyswitch_kernels (K4: the hybrid key switch and the
rescale): the plain torch versions, reached through BfvContext and
CkksContext, against abc_tpu's np64 contexts word for word; the kernel
source itself compiled for the host against the stub runtime of
tests/host_cuda and held word-equal to the plain versions; the CPU routing;
and, on a CUDA device, each kernel against its plain version at the main
paths' shapes.

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
from abc_tpu.crypto.ckks import CkksCiphertext as RefCkksCiphertext
from abc_tpu.crypto.ckks import CkksContext as RefCkksContext
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
from abc_tpu_torch.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.crypto.rlwe import galois_gather
from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops.modarith import as_residues, ratio_table, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")

HOST_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "host_cuda")
N = 256                   # the plain-vs-reference cases
L = 5
# (n, L kept rows, k, leading axes, the plan's kept rows a thread G) of
# ks_mod_down on a card of one SM: G = 2 from one full load of the card
# (2048 threads of a thread a kept row), but 1 past 2 special primes and
# for one kept row
MD_ROWS_CASES = [(256, 13, 1, (10,), 2), (256, 13, 1, (2,), 2),
                 (128, 6, 2, (6,), 2), (256, 6, 2, (11,), 2),
                 (256, 1, 1, (40,), 1), (256, 5, 3, (16,), 1),
                 (64, 13, 1, (2,), 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _primes(n, L, k):
    """t of 20 bits and L + k primes of 30 bits at ring degree n."""
    t = gen_ntt_primes(20, 1, n)[0]
    return t, gen_ntt_primes(30, L + k, n, exclude=[t])


def _rand(moduli, lead, n, seed):
    """uint32 residues [*lead, len(moduli), n] with 0 and q-1 among them."""
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=tuple(lead) + (len(moduli), n),
                     dtype=np.uint64)
    x[..., 0] = 0
    x[..., 1::7] = q - 1
    return x.astype(np.uint32)


def _special_edges(x, cols, k):
    """x with the centring edges of each of its last k rows' prime p in its
    first columns: 0, p - 1, p >> 1 and (p >> 1) + 1."""
    x = x.copy()
    for s in range(k):
        p = cols[len(cols) - k + s]
        x[..., len(cols) - k + s, :4] = [0, p - 1, p >> 1, (p >> 1) + 1]
    return x


def _rows(x):
    return x.reshape((-1,) + x.shape[-2:])


# ---------------------------------------------- plain versions vs the reference

@pytest.fixture(scope="module", params=[1, 2, 3], ids=["k1", "k2", "k3"])
def bfv_pair(request):
    """(port BfvContext on the CPU, abc_tpu np64 BfvContext): n=256, 5 data
    primes, k special primes, seed 5."""
    k = request.param
    t, primes = _primes(N, L, k)
    kw = dict(n=N, coeff_modulus=primes, plain_modulus=t, seed=5,
              ks_digits=k)
    return BfvContext(BfvParams(**kw), "cpu"), \
        RefBfvContext(RefBfvParams(engine="np64", **kw))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_bfv_decompose_matches_np64(bfv_pair, lead):
    port, ref = bfv_pair
    d = _rand(port.params.data_primes, lead, N, 1)
    got = to_host(port._decompose_ntt(as_residues(d, "cpu")))
    for row, want_d in zip(got.reshape((-1,) + got.shape[-3:]), _rows(d)):
        np.testing.assert_array_equal(row, ref._decompose_ntt(want_d))


@pytest.mark.parametrize("perm", [False, True], ids=["plain", "galois"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_bfv_ks_inner_matches_np64(bfv_pair, lead, perm):
    """The contraction, the inverse transform and the mod switch down of
    random digits with a random key; a Galois permutation read inside the
    contraction against the reference's permuted digits."""
    port, ref = bfv_pair
    moduli = port.params.coeff_modulus
    alpha = port.params.num_ks_digits
    D = _rand(moduli, lead + (alpha,), N, 2)
    kb, ka = (_rand(moduli, (alpha,), N, s) for s in (3, 4))
    g = pow(3, 5, 2 * N)
    got = port._ks_inner(as_residues(D, "cpu"), as_residues(kb, "cpu"),
                         as_residues(ka, "cpu"),
                         perm=port._galois_perm_eval(g) if perm else None)
    got = [to_host(h).reshape((-1,) + h.shape[-2:]) for h in got]
    for i, Di in enumerate(D.reshape((-1,) + D.shape[-3:])):
        if perm:
            Di = Di[..., ref._galois_perm_eval(g)]
        want = ref._ks_inner(Di, kb, ka)
        for h in range(2):
            np.testing.assert_array_equal(got[h][i], want[h])


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_bfv_mod_switch_down_matches_np64(bfv_pair, lead):
    """Random words over q∪P with 0, p-1, p>>1 and (p>>1)+1 in each special
    row (both sides of the centring test)."""
    port, ref = bfv_pair
    moduli, k = port.params.coeff_modulus, port.params.ks_digits
    x = _special_edges(_rand(moduli, lead, N, 6), moduli, k)
    got = to_host(port._mod_switch_down(as_residues(x, "cpu")))
    for row, xi in zip(got.reshape((-1,) + got.shape[-2:]), _rows(x)):
        np.testing.assert_array_equal(row, ref._mod_switch_down(xi))


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["k1", "k2", "k3"])
def ckks_pair(request):
    """(port CkksContext on the CPU, abc_tpu np64 CkksContext): n=256, 5
    data primes, k special primes, seed 9."""
    k = request.param
    _, primes = _primes(N, L, k)
    kw = dict(n=N, coeff_modulus=primes, seed=9, ks_digits=k)
    return CkksContext(CkksParams(**kw), "cpu"), \
        RefCkksContext(RefCkksParams(engine="np64", **kw))


def _cols(ctx, level):
    p = ctx.params
    return p.data_primes[:level] + p.special_primes


@pytest.mark.parametrize("level", [L, 4, 3, 1])
def test_ckks_decompose_and_ks_inner_match_np64(ckks_pair, level):
    """At full level and below it (a partial last digit at k=2, 3): the
    digit lift, and the contraction with a Galois permutation and without,
    the inverse transform and the mod switch down."""
    port, ref = ckks_pair
    cols, k = _cols(port, level), port.params.ks_digits
    d = _rand(port.params.data_primes[:level], (), N, level)
    np.testing.assert_array_equal(
        to_host(port._decompose_ntt(as_residues(d, "cpu"), level)),
        ref._decompose_ntt(d, level))
    alpha = -(-level // k)
    D = _rand(cols, (alpha,), N, level + 1)
    kb, ka = (_rand(cols, (alpha,), N, level + s) for s in (2, 3))
    g = pow(3, 3, 2 * N)
    for perm in (None, g):
        got = port._ks_inner(
            as_residues(D, "cpu"), as_residues(kb, "cpu"),
            as_residues(ka, "cpu"), level,
            perm=None if perm is None else port._galois_perm_eval(g))
        Dr = D if perm is None else D[..., ref._galois_perm_eval(g)]
        want = ref._ks_inner(Dr, kb, ka, level)
        for h in range(2):
            np.testing.assert_array_equal(to_host(got[h]), want[h])


@pytest.mark.parametrize("level", [L, 3, 1])
def test_ckks_mod_switch_down_matches_np64(ckks_pair, level):
    port, ref = ckks_pair
    cols, k = _cols(port, level), port.params.ks_digits
    x = _special_edges(_rand(cols, (), N, 20 + level), cols, k)
    np.testing.assert_array_equal(
        to_host(port._mod_switch_down(as_residues(x, "cpu"), level)),
        ref._mod_switch_down(x, level))
    # both accumulators of a key switch in one call, as _ks_inner makes it
    pair = _special_edges(_rand(cols, (2,), N, 30 + level), cols, k)
    got = to_host(port._mod_switch_down(as_residues(pair, "cpu"), level))
    for h in range(2):
        np.testing.assert_array_equal(got[h],
                                      ref._mod_switch_down(pair[h], level))


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("level", [L, 4, 2])
def test_ckks_rescale_matches_np64(ckks_pair, level, size):
    """rescale of a ciphertext at full level and below (size 3: before
    relinearization), the dropped limb holding the centring edges; and of a
    mod_drop_to view of a higher-level one."""
    port, ref = ckks_pair
    qs = port.params.data_primes
    x = _special_edges(_rand(qs[:level], (size,), N, 40 + level),
                       qs[:level], 1)
    got = port.rescale(CkksCiphertext(as_residues(x, "cpu"), level, 2.0 ** 40))
    want = ref.rescale(RefCkksCiphertext(x, level, 2.0 ** 40))
    assert got.level == want.level == level - 1 and got.scale == want.scale
    np.testing.assert_array_equal(to_host(got.data), want.data)
    wide = as_residues(_rand(qs, (size,), N, 50), "cpu")
    wide[:, :level] = as_residues(x, "cpu")
    view = port.mod_drop_to(CkksCiphertext(wide, L, 2.0 ** 40), level)
    assert torch.equal(port.rescale(view).data, got.data)


# --------------------------------------------------------------- the routing

def test_cpu_route_launches_nothing(bfv_pair):
    """A key switch and a rotation on CPU tensors run the plain versions
    (with the relinearization's and the rotation's tails)."""
    port, _ = bfv_pair
    before = dict(kk.launches)
    ct = port.encrypt(port.encode([1, 2, 3]))
    port.rotate_rows(port.multiply(ct, ct), 1)
    assert kk.launches == before
    assert set(before) == {"ks_decompose", "ks_contract", "ks_mod_down",
                           "ks_mod_down_relin", "ks_mod_down_rotate"}


def test_a_tensor_off_the_cpu_is_never_taken_by_the_plain_path():
    """Only a CPU tensor takes a plain version: any other device goes to the
    kernel's checks (here meta tensors, refused)."""
    t, primes = _primes(64, 3, 1)
    div = kk.Division(primes, 1, "meta")
    q = as_residues(np.asarray(primes, np.uint32).reshape(-1, 1), "meta")
    ratio = ratio_table(primes, "meta")
    x = torch.empty((2, 4, 64), dtype=torch.int32, device="meta")
    D = torch.empty((3, 4, 64), dtype=torch.int32, device="meta")
    for call in (lambda: kk.mod_down(x, div),
                 lambda: kk.decompose(x[:, :3], q, ratio),
                 lambda: kk.contract(D, D, D, q, ratio)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_tables_have_the_source_layout():
    """The packed words have csrc/keyswitch.cu's sizes, and the division's
    steps are those of the plain loop (k of them, rows Lo + s)."""
    t, primes = _primes(64, 5, 3)
    div = kk.Division(primes, 3, "cpu")
    assert len(div) == 3 and div.Lo == 5
    assert div.words.numel() == 3 * kk.REC * (1 + 8)
    assert [s[0].shape[0] for s in div.steps] == [5, 6, 7]
    assert [s[3] for s in div.steps] == [p >> 1 for p in primes[5:]]
    dg = kk.Digits(primes[:5], [[0, 1, 2], [3, 4]], primes, 3, "cpu")
    assert (dg.alpha, dg.k) == (2, 3)
    assert dg.words.numel() == 2 * 3 * (kk.REC + 8)
    assert dg.inv_qhat[1, 2, 0] == 0          # the short digit's padding


# ---------------------- the kernel source, compiled for the host (g++)

def _host_build(tmp_path_factory, sms):
    """csrc/keyswitch.cu compiled by g++ against tests/host_cuda's stub
    runtime (a launch runs its blocks in turn, a std::thread per thread),
    on a card of `sms` SMs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lib_path = tmp_path_factory.mktemp("ks_host") / f"libks_host{sms}.so"
    src = [s for s in _build.SOURCES if s.endswith("keyswitch.cu")][0]
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", f"-I{HOST_STUB}", f"-I{_build._CSRC}",
                    f"-DHOST_CUDA_SMS={sms}", src, "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build.bind_keyswitch(lib)
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build on the stub's card of an H100's 132 SMs."""
    return _host_build(tmp_path_factory, 132)


@pytest.fixture(scope="module")
def host_lib_one_sm(tmp_path_factory):
    """The host build on a card of one SM, whose plans take G > 1 kept rows
    a thread from a few blocks."""
    return _host_build(tmp_path_factory, 1)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _base(n, L, k, cut=None):
    """(data primes, columns q ∪ P as a [R, 1] column and ratios) at ring
    degree n: L data primes and k special primes of 30 bits."""
    _, primes = _primes(n, L, k)
    cols = primes if cut is None else primes[:cut] + primes[L:]
    return primes[:L], cols, as_residues(
        np.asarray(cols, np.uint32).reshape(-1, 1), "cpu"), \
        ratio_table(cols, "cpu")


def _stride(x):
    """The words between x's [L, n] rows, as the wrappers pass them."""
    stride = kk._row_stride(x)
    assert stride is not None
    return stride


def _host_decompose(lib, d, q, ratio, digits):
    rows, Lin, n = d.numel() // (d.shape[-2] * d.shape[-1]), d.shape[-2], \
        d.shape[-1]
    A, K = (Lin, 1) if digits is None else (digits.alpha, digits.k)
    out = torch.full(tuple(d.shape[:-2]) + (A, q.shape[0], n), -1,
                     dtype=torch.int32)
    assert lib.abc_ks_decompose(
        d.data_ptr(), out.data_ptr(), q.data_ptr(), ratio.data_ptr(),
        _ptr(None if digits is None else digits.words), rows, _stride(d),
        Lin, A, q.shape[0], K, n.bit_length() - 1, None) == 0
    return out


def _host_contract(lib, D, kb, ka, q, ratio, perm):
    """ks_contract on the host (ka None: the one-half form)."""
    A, R, n = D.shape[-3:]
    rows = D.numel() // (A * R * n)
    krows = kb.numel() // (A * R * n)
    out = torch.full(tuple(D.shape[:-3]) + (1 if ka is None else 2, R, n),
                     -1, dtype=torch.int32)
    assert lib.abc_ks_contract(
        D.data_ptr(), kb.data_ptr(), _ptr(ka), out.data_ptr(),
        _ptr(perm), q.data_ptr(), ratio.data_ptr(), rows, krows, A, R,
        n.bit_length() - 1, None) == 0
    return out


def _host_mod_down(lib, x, div):
    n = x.shape[-1]
    rows = x.numel() // (x.shape[-2] * n)
    out = torch.empty(tuple(x.shape[:-2]) + (div.Lo, n), dtype=torch.int32)
    assert lib.abc_ks_mod_down(x.data_ptr(), out.data_ptr(),
                               div.words.data_ptr(), rows, _stride(x),
                               div.Lo, div.k, n.bit_length() - 1, None) == 0
    return out


@pytest.mark.parametrize("n,L,k,lead", [
    (4, 5, 1, (3,)), (64, 6, 1, ()), (512, 13, 1, (2,)), (8, 5, 2, (2,)),
    (64, 6, 2, ()), (128, 8, 3, (3,)), (256, 27, 2, ()), (32, 20, 17, ())])
def test_decompose_source_on_the_host(host_lib, n, L, k, lead):
    """ks_decompose on the host: the k = 1 lift and the k >= 2 fast base
    conversion (a short last digit where k does not divide L; 17 sources a
    digit, past one 64-bit sum of 16 products), n from 4 to 512, with and
    without a leading axis."""
    qs, cols, q, ratio = _base(n, L, k)
    digits = None if k == 1 else kk.Digits(
        qs, [list(range(j, min(j + k, L))) for j in range(0, L, k)], cols,
        k, "cpu")
    d = as_residues(_rand(qs, lead, n, n + L), "cpu")
    want = kk.lift_plain(d, q) if digits is None else \
        kk.decompose_plain(d, q, digits)
    assert torch.equal(_host_decompose(host_lib, d, q, ratio, digits), want)
    # the same rows read in place as component 1 of a batch of ciphertexts
    wide = torch.zeros(lead + (3,) + tuple(d.shape[-2:]), dtype=torch.int32)
    wide[..., 1, :, :] = d
    assert torch.equal(_host_decompose(host_lib, wide[..., 1, :, :], q,
                                       ratio, digits), want)


@pytest.mark.parametrize("perm", [False, True], ids=["plain", "galois"])
@pytest.mark.parametrize("n,A,lead,klead", [
    (4, 6, (3,), ()), (64, 16, (), ()), (64, 17, (2,), ()),
    (128, 27, (), ()), (512, 6, (2,), ()), (32, 27, (2, 4), (4,)),
    (16, 3, (4,), (4,)), (8, 33, (), ())])
def test_contract_source_on_the_host(host_lib, perm, n, A, lead, klead):
    """ks_contract on the host: α up to 33 digits (products summed past 16
    and 32 terms), a Galois permutation read in the loads or none, a key
    without leading axes and one with D's last leading axis (a LocalComm
    shard axis), n from 4 to 512."""
    _, cols, q, ratio = _base(n, 6, 1)
    D = as_residues(_rand(cols, lead + (A,), n, A), "cpu")
    kb, ka = (as_residues(_rand(cols, klead + (A,), n, A + s), "cpu")
              for s in (1, 2))
    p = torch.from_numpy(np.random.default_rng(n).permutation(n)) \
        if perm else None
    got = _host_contract(host_lib, D, kb, ka, q, ratio, p)
    assert torch.equal(got, kk.contract_plain(D, kb, ka, q, p))


@pytest.mark.parametrize("n,L,k,lead", [
    (16, 13, 1, (2,)), (8, 27, 1, ()), (8, 27, 1, (3,)), (32, 13, 1, ()),
    (16, 5, 2, (2,)), (8, 7, 3, (2,)), (8, 7, 3, ()), (8, 20, 17, ()),
    (4, 20, 17, (2,)), (4, 45, 3, ()), (4, 6, 2, (5,)), (2048, 6, 2, (30,)),
    (4096, 6, 2, (44,)), (2048, 7, 3, (20,)), (2048, 20, 17, (4,))])
def test_decompose_column_groups_on_the_host(host_lib, n, L, k, lead):
    """ks_decompose with a thread a digit quad over the plan's group of its
    R columns (on the stub's card of 132 SMs): the k = 1 lift at R = 14 and
    28 (two columns a thread, a ragged last group at R = 7 and 13), and the
    base conversion at k = 2, 3 and 17 with a short last digit (17 sources:
    two chunks, the second added to the first's stored residue), a table
    too large to stage in shared memory (45 + 3 primes); a thread a column
    on small launches, and on larger ones 3 of 8 columns (30 rows at n =
    2048), all 8 (44 rows at n = 4096), 2 of 10 and 2 of 37 (k = 17); in
    place as component 1 of a batch (the strided d) and contiguous."""
    qs, cols_q, q, ratio = _base(n, L, k)
    digits = None if k == 1 else kk.Digits(
        qs, [list(range(j, min(j + k, L))) for j in range(0, L, k)], cols_q,
        k, "cpu")
    d = as_residues(_rand(qs, lead, n, n + L + k), "cpu")
    want = kk.lift_plain(d, q) if digits is None else \
        kk.decompose_plain(d, q, digits)
    wide = torch.zeros(lead + (3,) + tuple(d.shape[-2:]), dtype=torch.int32)
    wide[..., 1, :, :] = d
    for src in (d, wide[..., 1, :, :]):
        assert torch.equal(_host_decompose(host_lib, src, q, ratio, digits),
                           want)


@pytest.mark.parametrize("n,A,lead,klead,perm,halves", [
    (16, 1, (3,), (), False, 2), (16, 2, (3,), (), True, 2),
    (8, 5, (), (), True, 2), (8, 8, (5,), (), False, 2),
    (8, 9, (3,), (), True, 2), (8, 16, (2,), (), False, 2),
    (8, 17, (3,), (), False, 2), (4, 33, (3,), (), True, 2),
    (4, 6, (7,), (), False, 2), (4, 6, (7,), (), True, 2),
    (4, 3, (6, 2), (2,), True, 2), (8, 6, (5, 4), (4,), False, 2),
    (8, 1, (3,), (), False, 1), (8, 3, (), (), True, 1),
    (4, 6, (5,), (), False, 1), (8, 9, (2,), (), False, 1),
    (64, 2, (1,), (), False, 1), (64, 3, (1,), (), False, 1),
    (2048, 6, (10,), (), False, 2), (2048, 6, (10,), (), True, 2),
    (2048, 9, (10,), (), True, 2), (2048, 17, (5, 2), (2,), False, 2),
    (2048, 3, (10,), (), False, 1)])
def test_contract_lanes_on_the_host(host_lib, n, A, lead, klead, perm,
                                    halves):
    """ks_contract with G lanes a quad (α = 1, 2, 5, 8, 9, 16, 17, 33: G =
    1, 2, 2, 2, 4, 4, 8, 8; 17 and 33 past 16 digits, each lane's sum
    reduced before the group's; 33 past the 32 loaded together), batches of
    3, 5 and 7 rows, n = 4 (a row of one quad), a Galois permutation read
    in the loads, a key with D's last leading axis (krows 2 and 4), and the
    one-half form (`ka` None: with G = 2 each lane stores two words as
    scalars, with G = 8 two lanes hold the same words), among them a
    decryption's, a ciphertext's 2 or 3 components against [1, s, s^2];
    past 256 quads an SM (n = 2048, 10 rows) the streaming kernel, a thread
    a quad walking the digits (17: past one 64-bit sum of 16 products)."""
    _, cols, q, ratio = _base(n, 6, 1)
    D = as_residues(_rand(cols, lead + (A,), n, A + n), "cpu")
    kb, ka = (as_residues(_rand(cols, klead + (A,), n, A + s), "cpu")
              for s in (1, 2))
    ka = ka if halves == 2 else None
    p = torch.from_numpy(np.random.default_rng(n + A).permutation(n)) \
        if perm else None
    got = _host_contract(host_lib, D, kb, ka, q, ratio, p)
    assert torch.equal(got, kk.contract_plain(D, kb, ka, q, p))


@pytest.mark.parametrize("n,L,k,lead,cut", [
    (4, 5, 1, (3,), None), (64, 6, 1, (2,), None), (64, 6, 2, (), None),
    (128, 5, 3, (2, 2), None), (512, 13, 1, (2,), None),
    (64, 5, 3, (), 3), (32, 5, 5, (2,), None), (16, 5, 16, (), None)])
def test_mod_down_source_on_the_host(host_lib, n, L, k, lead, cut):
    """ks_mod_down on the host: k = 1 .. 16 special primes divided out in
    one launch (every instantiation), a level below full (`cut` data
    primes), n from 4 to 512, the centring edges in each special row."""
    _, cols, _, _ = _base(n, L, k, cut)
    div = kk.Division(cols, k, "cpu")
    x = as_residues(_special_edges(_rand(cols, lead, n, n + k), cols, k),
                    "cpu")
    want = kk.mod_down_plain(x, div)
    assert torch.equal(_host_mod_down(host_lib, x, div), want)
    # the same rows read in place among wider ones
    wide = torch.zeros(lead + (len(cols) + 2, n), dtype=torch.int32)
    wide[..., :len(cols), :] = x
    assert torch.equal(_host_mod_down(host_lib, wide[..., :len(cols), :],
                                      div), want)


def _host_tail(lib, x, div, tail):
    """ks_mod_down with a tail (K9a) on the host, with the arguments the
    wrapper passes."""
    n = x.shape[-1]
    rows = x.numel() // (x.shape[-2] * n)
    c_stride, c_comp = kk._tail_operand(x, tail, div.Lo, n)
    out = torch.full(tuple(x.shape[:-2]) + (div.Lo, n), -1,
                     dtype=torch.int32)
    assert lib.abc_ks_mod_down_tail(
        x.data_ptr(), out.data_ptr(), div.words.data_ptr(), rows, _stride(x),
        div.Lo, div.k, n.bit_length() - 1, kk._TAILS[tail.kind],
        tail.c.data_ptr(), c_stride, c_comp, tail.ginv, None) == 0
    return out


def _edge_rand(moduli, lead, n, seed, edge):
    """_rand's residues, or all 0 (`edge` "zero"), or all q-1 ("max")."""
    x = _rand(moduli, lead, n, seed)
    if edge == "zero":
        x[...] = 0
    elif edge == "max":
        x[...] = np.asarray(moduli, np.uint32).reshape(-1, 1) - 1
    return as_residues(x, "cpu")


@pytest.mark.parametrize("edge", [None, "zero", "max"])
@pytest.mark.parametrize("n,L,k,lead", [
    (4, 3, 1, ()), (64, 5, 1, (3,)), (64, 5, 2, (2,)), (128, 4, 2, ()),
    (32, 3, 3, (2, 2))])
def test_tails_source_on_the_host(host_lib, n, L, k, lead, edge):
    """ks_mod_down with the relinearization's tail, and with the rotation's
    at Galois elements 3, 3^5 and 2n-1 (both signs occur), equals the plain
    chains (mod_down_plain, then the adds / the signed gather and the
    stack) at k = 1, 2 and 3, on residues with 0 and q-1 among them and on
    all-0 and all-(q-1) inputs; the ciphertexts are read in place, a
    batch's components at one stride."""
    _, cols, _, _ = _base(n, L, k)
    div = kk.Division(cols, k, "cpu")
    x = _edge_rand(cols, lead + (2,), n, n + k, edge)
    prod = _edge_rand(cols[:L], lead + (3,), n, n + k + 1, edge)
    tail = kk.Tail("relin", prod)
    assert torch.equal(_host_tail(host_lib, x, div, tail),
                       kk.mod_down_plain(x, div, tail))
    for g in (3, pow(3, 5, 2 * n), 2 * n - 1):
        _, sign = galois_gather(n, g, "cpu")
        assert sign.any() and not sign.all()
        tail = kk.Tail("rotate", prod[..., 2, :, :], pow(g, -1, 2 * n))
        assert torch.equal(_host_tail(host_lib, x, div, tail),
                           kk.mod_down_plain(x, div, tail)), g


def test_host_tail_launch_info_and_refusals(host_lib):
    """The tails launch as ks_mod_down does, instantiated by k; a tail
    without its ciphertext, over an odd number of rows, or a rotation by
    an even g^-1 or one past 2n, is refused, and so is a ciphertext the
    wrapper cannot hand to the kernel."""
    info = (ctypes.c_longlong * 8)()
    for tail in (1, 2):
        assert host_lib.abc_ks_mod_down_plan(tail, 2, 6, 2, 13, info) == 0
        assert tuple(info[:4]) == (2, 1, 128, 12 * 8192 // 4 // 128)
    assert host_lib.abc_ks_mod_down_plan(3, 2, 6, 2, 13, info) != 0
    assert host_lib.abc_ks_mod_down_tail(None, None, None, 2, 7 << 6, 6, 1,
                                         6, 1, None, 0, 0, 0, None) != 0
    assert host_lib.abc_ks_mod_down_tail(None, None, None, 3, 7 << 6, 6, 1,
                                         6, 1, 16, 0, 0, 0, None) != 0
    for ginv in (0, 4, 129):
        assert host_lib.abc_ks_mod_down_tail(None, None, None, 2, 7 << 6, 6,
                                             1, 6, 2, 16, 0, 0, ginv,
                                             None) != 0
    _, cols, _, _ = _base(64, 3, 1)
    x = as_residues(_rand(cols, (2,), 64, 1), "cpu")
    with pytest.raises(ValueError, match="relin tail"):
        kk._tail_operand(x, kk.Tail("relin", x[:1, :3]), 3, 64)
    with pytest.raises(ValueError, match="g\\^-1"):
        kk._tail_operand(x, kk.Tail("rotate", x[0, :3], 0), 3, 64)


def gather_of(n, ginv):
    """The rotation tail's sources as csrc/keyswitch.cu (kRotate) computes
    them from g^-1, mirrored: column j of c0^g reads c0 at s = j g^-1 mod
    2n, at s - n negated where s >= n; ([n] sources, [n] keep-sign
    flags)."""
    s = (np.arange(n, dtype=np.int64) * ginv) % (2 * n)
    return np.where(s >= n, s - n, s), s < n


@pytest.mark.parametrize("n", [4 << i for i in range(11)])
def test_rotation_sources_equal_galois_gather(n):
    """The rotation tail's sources as the kernel computes them from g^-1
    (gather_of) are galois_gather's tables for every odd g, n = 4 ..
    4096."""
    for g in range(1, 2 * n, 2):
        gather, sign = galois_gather(n, g, "cpu")
        src, keep = gather_of(n, pow(g, -1, 2 * n))
        assert np.array_equal(src, gather.numpy()), g
        assert np.array_equal(keep, sign.numpy()), g


def test_rotation_sources_at_laplace_sharpening():
    """The same at LaplaceSharpening's n = 16384 for its Galois elements
    (3^s mod 2n for its rotation steps, all |s| <= 64, kept here whole)
    and the column rotation's 2n - 1."""
    n = 16384
    for g in {pow(3, s % (n // 2), 2 * n) for s in range(-64, 65)} | \
            {2 * n - 1}:
        gather, sign = galois_gather(n, g, "cpu")
        src, keep = gather_of(n, pow(g, -1, 2 * n))
        assert np.array_equal(src, gather.numpy()), g
        assert np.array_equal(keep, sign.numpy()), g


def _host_md_plan(lib, tail, rows, Lo, k, n):
    info = (ctypes.c_longlong * 8)()
    assert lib.abc_ks_mod_down_plan(tail, rows, Lo, k, n.bit_length() - 1,
                                    info) == 0
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm", "total_threads", "sms"), info))


def test_mod_down_plan_choice_on_the_host(host_lib):
    """abc_ks_mod_down_plan on the stub's card (132 SMs): two kept rows a
    thread where a thread a kept row fills the card (270 336 quads: B=64 of
    (8192, 6), k = 1 and 2), else one (one ciphertext at (8192, 6),
    (16384, 13), CKKS (32768, 8, k = 2); past 2 special primes; one kept
    row), every tail alike."""
    for (rows, Lo, k, logn), G in {
            (2, 6, 1, 13): 1, (128, 6, 1, 13): 2, (2, 13, 1, 14): 1,
            (2, 8, 2, 15): 1, (128, 6, 2, 13): 2, (128, 6, 3, 13): 1,
            (600, 1, 1, 13): 1, (22, 6, 1, 13): 2, (21, 6, 1, 13): 1}.items():
        for tail in (0, 1, 2):
            plan = _host_md_plan(host_lib, tail, rows, Lo, k, 1 << logn)
            assert plan["arg1"] == G, (rows, Lo, k, logn, tail)
            assert plan["total_threads"] == \
                rows * -(-Lo // G) * (1 << logn) // 4


@pytest.mark.parametrize("edge", [None, "max"])
@pytest.mark.parametrize("n,L,k,lead,G", MD_ROWS_CASES)
def test_mod_down_rows_on_the_host(host_lib_one_sm, n, L, k, lead, G,
                                   edge):
    """ks_mod_down with G kept rows a thread, the plan's choice by the
    launch's size on a card of one SM (the specials loaded and
    divided once for the G rows, the rotation's sources once for them):
    alone, with the relinearization's tail and with the rotation's (g = 3
    and 2n - 1) equal to the plain chains, on random
    residues and on all-(q-1) inputs; 13 kept rows leave a ragged last
    group of one row in groups of 2 and of 4."""
    host_lib = host_lib_one_sm
    _, cols, _, _ = _base(n, L, k)
    rows = 2 * int(np.prod(lead))
    plan = _host_md_plan(host_lib, 0, rows, L, k, n)
    assert (plan["arg1"], plan["total_threads"]) == \
        (G, rows * -(-L // G) * n // 4)
    div = kk.Division(cols, k, "cpu")
    x = _edge_rand(cols, lead + (2,), n, n + k, edge)
    prod = _edge_rand(cols[:L], lead + (3,), n, n + k + 1, edge)
    assert torch.equal(_host_mod_down(host_lib, x, div),
                       kk.mod_down_plain(x, div))
    tails = [kk.Tail("relin", prod)] + [
        kk.Tail("rotate", prod[..., 0, :, :], pow(g, -1, 2 * n))
        for g in (3, 2 * n - 1)]
    for tail in tails:
        assert torch.equal(_host_tail(host_lib, x, div, tail),
                           kk.mod_down_plain(x, div, tail)), tail.kind


@pytest.mark.parametrize("level,size", [(6, 2), (2, 3)])
def test_rescale_source_on_the_host(host_lib, level, size):
    """A rescale is ks_mod_down's division of a level by its last prime."""
    qs, _, _, _ = _base(64, 6, 1)
    div = kk.Division(qs[:level], 1, "cpu")
    x = as_residues(_special_edges(_rand(qs[:level], (size,), 64, level),
                                   qs[:level], 1), "cpu")
    assert torch.equal(_host_mod_down(host_lib, x, div),
                       kk.mod_down_plain(x, div))


def _host_plan(lib, kernel, rows, A, R, K, halves, logn):
    info = (ctypes.c_longlong * 10)()
    assert lib.abc_ks_plan(kernel, rows, A, R, K, halves, logn, info) == 0
    return dict(zip(("arg0", "arg1", "arg2", "arg3", "threads", "blocks",
                     "blocks_per_sm", "warps_per_sm", "total_threads",
                     "sms"), info))


def test_host_launch_info_and_refusals(host_lib):
    """abc_ks_plan at the main path's (8192, 6, k=1) on the stub's card
    (132 SMs of 16 blocks): ks_decompose's k = 1 lift 2 columns a thread;
    at k = 2 a thread a column at one ciphertext (a digit quad a thread
    would not make half a wave) and all 8 columns a thread at B=64;
    ks_contract 2 lanes a quad (3 digits each), both halves, at one
    ciphertext (under 256 quads an SM), and a decryption's one half, and
    the streaming kernel, a thread a quad, at B=64 and (16384, 13).
    abc_ks_mod_down_plan: 128 a block, ks_mod_down's instantiation by k;
    shapes the kernels do not take are refused."""
    one = _host_plan(host_lib, 0, 1, 6, 7, 1, 2, 13)
    assert one == {**one, "arg0": 1, "arg2": 2, "arg3": 4,
                   "total_threads": 6 * 4 * 2048, "threads": 128,
                   "blocks": 6 * 4 * 2048 // 128, "blocks_per_sm": 16,
                   "sms": 132}
    b64 = _host_plan(host_lib, 0, 64, 6, 7, 1, 2, 13)
    assert (b64["arg2"], b64["arg3"]) == (2, 4)
    k2 = _host_plan(host_lib, 0, 1, 3, 8, 2, 2, 13)
    assert (k2["arg0"], k2["arg2"], k2["arg3"]) == (2, 1, 8)
    k2 = _host_plan(host_lib, 0, 64, 3, 8, 2, 2, 13)
    assert (k2["arg2"], k2["arg3"], k2["total_threads"]) == \
        (8, 1, 64 * 3 * 2048)
    assert _host_plan(host_lib, 0, 1, 2, 37, 17, 2, 5)["arg0"] == 16
    one = _host_plan(host_lib, 1, 1, 6, 7, 1, 2, 13)
    assert (one["arg0"], one["arg1"], one["arg2"], one["arg3"],
            one["total_threads"], one["blocks"], one["sms"]) == \
        (2, 2, 0, 0, 7 * 2048 * 2, 7 * 2048 * 2 // 128, 132)
    dec = _host_plan(host_lib, 1, 1, 2, 6, 1, 1, 13)
    assert (dec["arg0"], dec["arg1"], dec["total_threads"]) == \
        (2, 1, 6 * 2048 * 2)
    b64 = _host_plan(host_lib, 1, 64, 6, 7, 1, 2, 13)
    assert (b64["arg0"], b64["total_threads"]) == (1, 64 * 7 * 2048)
    assert _host_plan(host_lib, 1, 1, 13, 14, 1, 2, 14)["arg0"] == 1
    for A, lanes in ((1, 1), (2, 2), (3, 2), (8, 2), (9, 4), (16, 4),
                     (17, 8), (33, 8)):
        assert _host_plan(host_lib, 1, 2, A, 7, 1, 1, 13)["arg0"] == lanes
    info = (ctypes.c_longlong * 10)()
    assert host_lib.abc_ks_mod_down_plan(3, 2, 7, 1, 13, info) != 0
    assert host_lib.abc_ks_plan(2, 1, 6, 7, 1, 2, 13, info) != 0
    assert host_lib.abc_ks_plan(1, 1, 6, 7, 1, 3, 13, info) != 0
    for k, arg in ((1, 1), (2, 2), (3, 4), (5, 16), (16, 16)):
        assert host_lib.abc_ks_mod_down_plan(0, 2, 6, k, 13, info) == 0
        assert info[0] == arg
    assert host_lib.abc_ks_mod_down_plan(0, 2, 6, 17, 13, info) != 0
    assert host_lib.abc_ks_mod_down(None, None, None, 1, 23 << 13, 6, 17,
                                    13, None) != 0
    assert host_lib.abc_ks_mod_down(None, None, None, 1, 6 << 13, 6, 1, 13,
                                    None) != 0          # rows overlap
    assert host_lib.abc_ks_contract(None, None, None, None, None, None, None,
                                    3, 2, 6, 7, 13, None) != 0
    assert host_lib.abc_ks_contract(None, None, None, None, None, None, None,
                                    2, 1, 0, 7, 13, None) != 0
    assert host_lib.abc_ks_decompose(None, None, None, None, None, 1,
                                     6 << 13, 6, 5, 7, 1, 13, None) != 0
    assert host_lib.abc_ks_decompose(None, None, None, None, None, 1,
                                     (6 << 13) + 2, 6, 6, 7, 1, 13,
                                     None) != 0


def test_row_strides_the_kernels_take():
    """The lift and the mod switch read rows at one stride (a component of
    a batch, a level's limbs of a wider ciphertext); rows whose leading
    axes need two strides (a LocalComm shard axis over a component) are
    refused, and the contexts copy them once."""
    x = torch.zeros((4, 3, 6, 64), dtype=torch.int32)
    assert kk._row_stride(x) == 6 * 64
    assert kk._row_stride(x[:, 2]) == 3 * 6 * 64
    assert kk._row_stride(x[:, :, :4]) == 6 * 64
    assert kk._row_stride(x[0, 1]) == 6 * 64
    assert kk._row_stride(x[:, 1].unflatten(-2, (2, 3))) is None
    assert kk._row_stride(x[..., ::2]) is None


@pytest.mark.parametrize("edge", [None, "zero", "max", "half"])
def test_chip_smoke_library_call_is_the_k1_lift(edge):
    """chip_smoke.py phase 2c's library yardstick of ks_decompose, one
    torch.remainder, gives the plain lift's words at the main path's k = 1
    shape and on its edge inputs; a k = 2 shape (a base conversion) has
    none."""
    import chip_smoke
    k1, k2 = chip_smoke.KS_SHAPES[0], chip_smoke.KS_SHAPES[2]
    assert k1[3] == 1 and k2[3] == 2
    _, _, plain, _, _, _, library = chip_smoke.ks_calls(
        *k1, edge, "cpu")["ks_decompose"]
    assert torch.equal(library(), plain())
    assert chip_smoke.ks_calls(*k2, edge, "cpu")["ks_decompose"][-1] is None


# ------------------------------------------------------------- on the card

def _card_inputs(n, cols, lead, k, dev):
    """Random residues over `cols` with the centring edges in the last k
    rows, on the card and on the CPU."""
    h = _special_edges(_rand(cols, lead, n, n + len(cols)), cols, k)
    return as_residues(h, dev), as_residues(h, "cpu")


def _card_cases(scheme, n, L, k, lead, level, dev):
    """(kernel name, kernel call, plain call) of the three kernels of one
    context's key switch (the mod switch down also with the relinearization's
    and a rotation's tail, and a CKKS rescale; the contraction also with one
    half, a decryption's) at one shape."""
    if scheme == "bfv":
        params = BfvParams.create(n, seed=11, ks_digits=k)
        assert params.L == L
        ctx, cpu = BfvContext(params, dev), BfvContext(params, "cpu")
        cols, alpha = params.coeff_modulus, params.num_ks_digits
        lift, ks, msd = (lambda c, d: c._decompose_ntt(d)), \
            (lambda c, *a, perm=None: c._ks_partials(*a, perm=perm)), \
            (lambda c, x, tail=None: c._mod_switch_down(x, tail))
        qs, perm_g = params.data_primes, pow(3, 7, 2 * n)
    else:
        params = CkksParams.create(n, levels=L, seed=3, ks_digits=k)
        ctx, cpu = CkksContext(params, dev), CkksContext(params, "cpu")
        cols, alpha = params.data_primes[:level] + params.special_primes, \
            -(-level // k)
        lift = (lambda c, d: c._decompose_ntt(d, level))
        ks = (lambda c, D, b, a, perm=None: kk.contract(
            D, b, a, c._ntt_cols[level].q_col, c._ntt_cols[level].ratio,
            perm))
        msd = (lambda c, x, tail=None: c._mod_switch_down(x, level, tail))
        qs, perm_g = params.data_primes[:level], pow(3, 7, 2 * n)
    d, dc = _card_inputs(n, qs, lead, 0, dev)
    D, Dc = _card_inputs(n, cols, lead + (alpha,), k, dev)
    (kb, kbc), (ka, kac) = (_card_inputs(n, cols, (alpha,), k, dev)
                            for _ in range(2))
    x, xc = _card_inputs(n, cols, lead + (2,), k, dev)
    prod, prodc = _card_inputs(n, qs, lead + (3,), 0, dev)
    perm = ctx._galois_perm_eval(perm_g)
    cases = [
        ("ks_mod_down_relin", lambda: msd(ctx, x, kk.Tail("relin", prod)),
         lambda: msd(cpu, xc, kk.Tail("relin", prodc))),
        ("ks_mod_down_rotate", lambda: msd(ctx, x, kk.Tail(
            "rotate", prod[..., 1, :, :], ctx._galois_inv(perm_g))),
         lambda: msd(cpu, xc, kk.Tail("rotate", prodc[..., 1, :, :],
                                      cpu._galois_inv(perm_g)))),
        ("ks_decompose", lambda: lift(ctx, d), lambda: lift(cpu, dc)),
        ("ks_contract", lambda: ks(ctx, D, kb, ka),
         lambda: ks(cpu, Dc, kbc, kac)),
        ("ks_contract", lambda: ks(ctx, D, kb, ka, perm=perm),
         lambda: ks(cpu, Dc, kbc, kac, perm=perm.cpu())),
        ("ks_mod_down", lambda: msd(ctx, x), lambda: msd(cpu, xc))]
    # a decryption's dot product: the ciphertexts' two components with
    # [1, s] over the data primes (ks_contract, one half)
    ntt, cntt = (ctx.ntt_q, cpu.ntt_q) if scheme == "bfv" else \
        (ctx._ntt_at(level), cpu._ntt_at(level))
    ct, ctc = _card_inputs(n, qs, lead + (2,), 0, dev)
    sk, skc = _card_inputs(n, qs, (2,), 0, dev)
    cases.append(("ks_contract",
                  lambda: kk.contract(ct, sk, None, ntt.q_col, ntt.ratio),
                  lambda: kk.contract_plain(ctc, skc, None, cntt.q_col)))
    if scheme == "ckks" and level > 1:
        r, rc = _card_inputs(n, qs, (2,), 1, dev)
        cases.append(("ks_mod_down",
                      lambda: ctx.rescale(CkksCiphertext(r, level, 1.0)).data,
                      lambda: cpu.rescale(CkksCiphertext(rc, level,
                                                         1.0)).data))
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,n,L,k,lead,level", [
    ("bfv", 8192, 6, 1, (), None), ("bfv", 8192, 6, 2, (), None),
    ("bfv", 8192, 6, 1, (64,), None), ("bfv", 8192, 6, 2, (64,), None),
    ("bfv", 16384, 13, 1, (), None), ("ckks", 32768, 8, 2, (), 8),
    ("ckks", 32768, 8, 2, (), 7), ("ckks", 32768, 8, 2, (), 3)])
def test_kernels_equal_plain_on_cuda(cuda, scheme, n, L, k, lead, level):
    """Each kernel on the card against its plain version at the main paths'
    shapes: BFV n=8192 L=6 k=1 and 2 at one ciphertext and at B=64, n=16384
    L=13 (LaplaceSharpening), CKKS n=32768 at full level, one below and
    level 3 (a partial digit), with and without a Galois permutation, and
    the decryption's one-half contraction."""
    for name, kern, plain in _card_cases(scheme, n, L, k, lead, level,
                                         cuda):
        before = kk.launches[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert kk.launches[name] == before + 1, name
        assert torch.equal(got.cpu(), want), name


@pytest.mark.gpu
def test_views_are_copied_once_and_otherwise_refused_on_cuda(cuda):
    """The lift and the mod switch read rows at one stride in place; the
    contexts copy a view of two strides once; any other layout handed to a
    kernel raises."""
    params = BfvParams.create(1024, seed=3)
    ctx = BfvContext(params, cuda)
    ct = as_residues(_rand(params.data_primes, (4, 2), 1024, 1), cuda)
    got = ctx._decompose_ntt(ct[:, 1])            # rows at one stride
    assert torch.equal(got, ctx._decompose_ntt(ct[:, 1].contiguous()))
    split = ct[:, 1].unflatten(-2, (params.L, 1))   # two strides
    with pytest.raises(ValueError, match="contiguous"):
        kk.decompose(split, ctx.ntt_qp.q_col, ctx.ntt_qp.ratio)
    x = as_residues(_rand(params.coeff_modulus, (2, 2), 1024, 2), cuda)
    assert torch.equal(kk.mod_down(x[:, 0], ctx._division),
                       kk.mod_down(x[:, 0].contiguous(), ctx._division))
    for bad in (x[..., ::2], x.transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous"):
            kk.mod_down(bad, ctx._division)
    D = as_residues(_rand(params.coeff_modulus, (2, 5), 1024, 3), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kk.contract(D[:, :4], D[0, :4].contiguous(), D[0, :4].contiguous(),
                    ctx.ntt_qp.q_col, ctx.ntt_qp.ratio)
