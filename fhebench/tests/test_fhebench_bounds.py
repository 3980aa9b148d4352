"""The frozen bound functions of rooflines/bounds.py equal chip_smoke.py's
at the shapes of the kernel table (PERF.md §6), and the FHE operations'
least times are positive, additive and independent of the kernels."""

import itertools

import pytest

from _tiny import REPO  # noqa: F401  (puts the repository on the path)
from fhebench.rooflines import bounds, fhe_ops

# (n, L of the table, rows, inverse) of the kernel table's NTT rows
NTT_SHAPES = [(8192, 7, 42, False), (8192, 8, 24, True), (32768, 10, 40,
                                                          False),
              (32768, 8, 24, True), (16384, 14, 14, False),
              (16384, 14, 14, True), (4096, 8, 64, False),
              (4096, 8, 64, True), (16384, 14, 182, False),
              (8192, 7, 2688, False)]
# (K, D) of the BEHZ kernels: n=8192 L=6, L=16, L=13, L=27, L=65
BEHZ_KD = [(6, 8), (16, 18), (13, 15), (27, 29), (65, 67), (8, 6), (7, 6)]
# (R, A, K, k, Lo, halves) of the key-switch kernels
KS_ARGS = [(7, 6, 1, 1, 6, 2), (8, 3, 2, 2, 6, 2), (14, 13, 1, 1, 13, 2),
           (10, 4, 2, 2, 8, 2), (6, 2, 1, 1, 6, 1), (5, 2, 2, 2, 3, 2)]


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def test_rates_equal(smoke):
    assert (bounds.HBM_BYTES_S, bounds.IMAD_S, bounds.INT_ISSUE_S,
            bounds.IMAD_PER_BUTTERFLY, bounds.BEHZ_IMAD) == \
        (smoke.HBM_BYTES_S, smoke.IMAD_S, smoke.INT_ISSUE_S,
         smoke.IMAD_PER_BUTTERFLY, smoke.BEHZ_IMAD)


@pytest.mark.parametrize("shape", NTT_SHAPES)
def test_ntt_bound_equal(smoke, shape):
    assert bounds.ntt_bound(*shape) == smoke.ntt_bound(*shape)


@pytest.mark.parametrize("kernel,kd", list(itertools.product(
    ("behz_to_bsk", "behz_tensor", "behz_fast_floor", "behz_from_bsk"),
    BEHZ_KD)))
def test_behz_imads_equal(smoke, kernel, kd):
    assert bounds.behz_imads(kernel, *kd) == smoke.behz_imads(kernel, *kd)


@pytest.mark.parametrize("name,args", list(itertools.product(
    ("ks_decompose", "ks_contract", "ks_mod_down"), KS_ARGS)))
def test_ks_imads_equal(smoke, name, args):
    R, A, K, k, Lo, halves = args
    assert bounds.ks_imads(name, R, A, K, k, Lo, halves) == \
        smoke.ks_imads(name, R, A, K, k, Lo, halves)


@pytest.mark.parametrize("n_bytes,imads,ops", [(1e6, 0, 0), (0, 1e9, 0),
                                               (1e6, 1e6, 5e9)])
def test_bound_equal(smoke, n_bytes, imads, ops):
    assert bounds.bound(n_bytes, imads, ops) == smoke.bound(n_bytes, imads,
                                                            ops)


@pytest.mark.parametrize("shape", [(16384, 13, 1, 1), (8192, 6, 1, 64),
                                   (8192, 6, 2, 1)])
def test_least_time_is_a_sum_of_operations(shape):
    one = {op: fhe_ops.least_ms(layer, {op: 1}, *shape)
           for op in fhe_ops.OPS for layer in ("ntt",)}
    census = {op: 3 for op in fhe_ops.OPS}
    assert fhe_ops.least_ms("ntt", census, *shape) == \
        pytest.approx(3 * sum(one.values()))
    for op in fhe_ops.OPS:
        assert all(ms > 0 for _, ms in fhe_ops.launches(op, *shape))


def test_key_switch_charges_its_key():
    n, L, k, B = 16384, 13, 1, 1
    ks = fhe_ops.least_ms("keyswitch", {"key_switch": 1}, n, L, k, B)
    key_ms = 4 * 2 * L * (L + 1) * n / bounds.HBM_BYTES_S * 1e3
    assert ks >= key_ms
    with pytest.raises(ValueError):
        fhe_ops.launches("bootstrap", n, L, k, B)


CKKS = (32768, 8, 2, 1)


@pytest.mark.parametrize("op", fhe_ops.CKKS_OPS)
@pytest.mark.parametrize("level", [1, 5, 8])
def test_ckks_operations_by_level(op, level):
    if op == "ckks_rescale" and level == 1:
        return
    key = f"{op}@{level}"
    assert all(ms > 0 for _, ms in fhe_ops.launches(key, *CKKS))
    # at the top level a CKKS operation that BFV shares costs BFV's (a
    # CKKS product has no base conversion)
    bfv = op[len("ckks_"):]
    if bfv in fhe_ops.OPS and bfv != "multiply" and level == CKKS[1]:
        assert fhe_ops.launches(key, *CKKS) == \
            fhe_ops.launches(bfv, *CKKS)


def test_ckks_work_falls_with_the_level():
    for op in fhe_ops.CKKS_OPS:
        ms = [sum(t for _, t in fhe_ops.launches(f"{op}@{lv}", *CKKS))
              for lv in (2, 5, 8)]
        assert ms[0] < ms[1] < ms[2], op


def test_ckks_rescale_is_one_division_in_the_key_switch_layer():
    n, L, k, B = CKKS
    # both components read at 8 primes and written at 7
    want = 4 * 2 * (8 + 7) * n / bounds.HBM_BYTES_S * 1e3
    assert fhe_ops.least_ms("keyswitch", {"ckks_rescale@8": 1}, *CKKS) \
        == pytest.approx(want)
    assert fhe_ops.least_ms("ntt", {"ckks_rescale@8": 1}, *CKKS) == 0
    assert fhe_ops.least_ms("ntt", {"ckks_plain_scalar@8": 1}, *CKKS) == 0


@pytest.mark.parametrize("key", ["ckks_multiply", "ckks_multiply@0",
                                 "ckks_bootstrap@3", "ckks_rescale@x"])
def test_unknown_ckks_operation(key):
    with pytest.raises(ValueError):
        fhe_ops.launches(key, *CKKS)
