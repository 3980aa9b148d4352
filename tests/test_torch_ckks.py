"""CKKS of the port (abc_tpu_torch.crypto.ckks) on the CPU: the cases of
tests/test_ckks.py, each against the values the reference test expects with
its tolerance, and word for word (no tolerance: residues are canonical)
against an abc_tpu np64 CkksContext of the same parameters and seed: public
key, relinearization and Galois keys, encryptions, products (k = 1 and
k = 2, at full and at partial level), rescales, rotations, hoisted rotations
and decrypted residues. Decoded floats come from the same host numpy code on
the same words, so they are held equal too.

The reference's cross-engine cases (np64 against jx32) are here the port
against np64, and once against jx32; its checkpoint case waits for the port
of utils/checkpoint.py.
"""

import warnings

import numpy as np
import pytest
import torch

from abc_tpu.crypto.ckks import CkksContext as RefContext
from abc_tpu.crypto.ckks import CkksParams as RefParams
from abc_tpu_torch.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import as_residues, to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")


def pair(n, levels, seed, **kw):
    """(port context on the CPU, reference np64 context) of one recipe."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return (CkksContext(CkksParams.create(n, levels=levels, seed=seed,
                                              **kw), "cpu"),
                RefContext(RefParams.create(n, levels=levels, seed=seed,
                                            engine="np64", **kw)))


@pytest.fixture(scope="module")
def both():
    return pair(256, 3, 1)


@pytest.fixture(scope="module")
def ctx(both):
    return both[0]


@pytest.fixture(scope="module")
def both_k2():
    return pair(256, 4, 7, ks_digits=2)


def dec(ctx, ct, k=4):
    return np.real(ctx.decode(ctx.decrypt(ct))[:k])


def same(ct, ref_ct):
    """Port ciphertext == reference ciphertext: words, level, scale."""
    np.testing.assert_array_equal(to_host(ct.data), np.asarray(ref_ct.data))
    assert (ct.level, ct.scale) == (ref_ct.level, ref_ct.scale)


def enc2(both, vals):
    """Encrypt on both sides (the generators advance in step)."""
    p, r = both
    a, ra = p.encrypt(p.encode(vals)), r.encrypt(r.encode(vals))
    same(a, ra)
    return a, ra


# ------------------------------------------------ the cases of test_ckks.py

def test_encode_decode_roundtrip(both):
    ctx, ref = both
    vals = [1.5, -2.25, 3.0, 0.5]
    pt = ctx.encode(vals)
    np.testing.assert_array_equal(pt.coeffs_rns, ref.encode(vals).coeffs_rns)
    z = ctx.decode(pt)
    np.testing.assert_allclose(np.real(z[:4]), vals, atol=1e-6)
    assert abs(np.imag(z)).max() < 1e-9
    np.testing.assert_array_equal(z, ref.decode(ref.encode(vals)))


def test_encode_decode_complex(ctx):
    vals = [1 + 2j, -0.5 - 1j]
    z = ctx.decode(ctx.encode(vals))
    np.testing.assert_allclose(z[:2], vals, atol=1e-6)


def test_encode_product_scale_exceeds_int64(both):
    """A plaintext at a product scale has coefficients beyond int64: the
    residues come from exact Python integers on both sides."""
    ctx, ref = both
    scale = ctx.params.scale ** 3
    assert 100.5 * scale > 2 ** 63
    pt, rpt = (c.encode([100.5, -3.0], scale=scale) for c in (ctx, ref))
    np.testing.assert_array_equal(pt.coeffs_rns, rpt.coeffs_rns)


def test_encrypt_decrypt_approximate(both):
    vals = [3.14159, -2.71828, 0.0, 100.5]
    a, ra = enc2(both, vals)
    np.testing.assert_allclose(dec(both[0], a), vals, atol=1e-3)
    np.testing.assert_array_equal(both[0].decrypt(a).coeffs_rns,
                                  both[1].decrypt(ra).coeffs_rns)


def test_add_sub(both):
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0, 3.0])
    b, rb = enc2(both, [0.5, -0.5, 10.0])
    np.testing.assert_allclose(dec(ctx, ctx.add(a, b), 3), [1.5, 1.5, 13.0],
                               atol=1e-3)
    np.testing.assert_allclose(dec(ctx, ctx.sub(a, b), 3), [0.5, 2.5, -7.0],
                               atol=1e-3)
    same(ctx.add(a, b), ref.add(ra, rb))
    same(ctx.sub(a, b), ref.sub(ra, rb))


def test_multiply_with_relin_and_rescale(both):
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0, 3.0, 4.0])
    b, rb = enc2(both, [0.5, 0.25, 2.0, -1.0])
    p = ctx.multiply(a, b)
    assert p.level == ctx.params.L - 1          # one level consumed
    assert p.size == 2                          # relinearized
    np.testing.assert_allclose(dec(ctx, p), [0.5, 0.5, 6.0, -4.0], rtol=1e-3,
                               atol=1e-3)
    same(p, ref.multiply(ra, rb))


def test_multiply_depth_two(both):
    ctx, ref = both
    a, ra = enc2(both, [2.0, -1.5])
    b, rb = enc2(both, [3.0, 2.0])
    c, rc = enc2(both, [0.5, 4.0])
    p = ctx.multiply(ctx.multiply(a, b), c)     # auto level alignment
    assert p.level == ctx.params.L - 2
    np.testing.assert_allclose(dec(ctx, p, 2), [3.0, -12.0], rtol=2e-2,
                               atol=2e-2)
    same(p, ref.multiply(ref.multiply(ra, rb), rc))


def test_rescale_tracks_scale(both):
    ctx, ref = both
    a, ra = enc2(both, [1.0])
    b, rb = enc2(both, [1.0])
    p = ctx.multiply(a, b, rescale=False)
    assert p.scale == pytest.approx(ctx.params.scale ** 2)
    r = ctx.rescale(p)
    q_dropped = ctx.params.data_primes[p.level - 1]
    assert r.scale == pytest.approx(ctx.params.scale ** 2 / q_dropped)
    assert r.level == p.level - 1
    same(r, ref.rescale(ref.multiply(ra, rb, rescale=False)))


def test_rotation(both):
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(dec(ctx, ctx.rotate(a, 1), 3), [2.0, 3.0, 4.0],
                               atol=1e-3)
    # negative rotation wraps the other way within the n/2 slots
    r = ctx.rotate(a, -1)
    z = np.real(ctx.decode(ctx.decrypt(r)))
    np.testing.assert_allclose(z[1:5], [1.0, 2.0, 3.0, 4.0], atol=1e-3)
    same(ctx.rotate(a, 1), ref.rotate(ra, 1))
    same(r, ref.rotate(ra, -1))
    assert ctx.rotate(a, 0) is a


def test_rotation_after_multiply(both):
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0, 3.0, 4.0])
    p = ctx.multiply(a, a)                      # squares, level drops
    r = ctx.rotate(p, 2)                        # leveled galois key switch
    np.testing.assert_allclose(dec(ctx, r, 2), [9.0, 16.0], rtol=1e-3,
                               atol=1e-3)
    same(r, ref.rotate(ref.multiply(ra, ra), 2))


def test_mod_drop_alignment(both):
    ctx, ref = both
    a, ra = enc2(both, [5.0])
    b, rb = enc2(both, [7.0])
    p = ctx.multiply(a, b)                      # level L-1
    s = ctx.add(p, ctx.multiply(a, b))          # both aligned at L-1
    np.testing.assert_allclose(dec(ctx, s, 1), [70.0], rtol=1e-3)
    same(s, ref.add(ref.multiply(ra, rb), ref.multiply(ra, rb)))
    with pytest.raises(Exception, match="raise a ciphertext"):
        ctx.mod_drop_to(p, ctx.params.L)


def test_jx32_engine_bit_exact():
    """The reference's other engine holds the same words as the port."""
    c_pt, _ = pair(256, 3, 7)
    c_jx = RefContext(RefParams.create(256, levels=3, seed=7, engine="jx32"))
    vals_a, vals_b = [1.0, -2.0, 0.25], [3.0, 0.5, -4.0]
    a_pt, b_pt = (c_pt.encrypt(c_pt.encode(v)) for v in (vals_a, vals_b))
    a_jx, b_jx = (c_jx.encrypt(c_jx.encode(v)) for v in (vals_a, vals_b))
    same(a_pt, a_jx)
    same(c_pt.rotate(c_pt.multiply(a_pt, b_pt), 1),
         c_jx.rotate(c_jx.multiply(a_jx, b_jx), 1))


def test_hoisted_rotations_match_sequential():
    ctx, ref = pair(512, 3, 9)
    vals = np.linspace(-1.0, 1.0, ctx.params.n // 2)
    ct, rct = enc2((ctx, ref), vals)
    steps = [0, 1, 3, -2]
    hoisted = ctx.hoisted_rotations(ct, steps)
    for s, h, rh in zip(steps, hoisted, ref.hoisted_rotations(rct, steps)):
        want = ctx.decode(ctx.decrypt(ctx.rotate(ct, s))).real
        got = ctx.decode(ctx.decrypt(h)).real
        np.testing.assert_allclose(got, want, atol=1e-3)
        same(h, rh)
        assert torch.equal(h.data, ctx.rotate(ct, s).data)


def test_rotations_share_decomposition():
    """Transparent hoisting in CkksContext.rotate: k rotations of the SAME
    ciphertext cost ONE key-switch decomposition."""
    ctx, ref = pair(1024, 3, 5)
    vals = np.arange(ctx.params.slot_count, dtype=np.float64)
    ct = ctx.encrypt(ctx.encode(vals, level=ctx.params.L))
    rct = ref.encrypt(ref.encode(vals, level=ref.params.L))
    for c in (ctx, ref):
        for k in c.counters:
            c.counters[k] = 0
    outs = [ctx.rotate(ct, s) for s in (1, 2, 5)]
    routs = [ref.rotate(rct, s) for s in (1, 2, 5)]
    assert ctx.counters["galois"] == 3
    assert ctx.counters["decomp"] == 1
    assert ctx.counters["decomp_hit"] == 2
    assert ctx.counters == ref.counters
    for s, o, ro in zip((1, 2, 5), outs, routs):
        got = ctx.decode(ctx.decrypt(o))
        want = np.roll(vals, -s)
        assert np.max(np.abs(np.real(got) - want)) < 1e-2
        same(o, ro)


# ---------------------------------------------------------------- hybrid KS

def test_hybrid_decompose_shape(both_k2):
    """k=2, levels=4: the decomposition carries ceil(l/2) digit rows over
    l+2 extended-base limbs."""
    ctx, ref = both_k2
    L, n = ctx.params.L, ctx.params.n
    assert ctx.params.num_ks_digits == 2
    rng = np.random.default_rng(3)
    d = rng.integers(0, 2 ** 29, size=(L, n)).astype(np.uint32)
    D = ctx._decompose_ntt(as_residues(d, "cpu"), L)
    assert D.shape == (2, L + 2, n)             # 2*(4+2)=12 rows vs 4*5=20
    D3 = ctx._decompose_ntt(as_residues(d[:3], "cpu"), 3)
    assert D3.shape == (2, 3 + 2, n)            # partial second digit
    np.testing.assert_array_equal(to_host(D), ref._decompose_ntt(d, L))
    np.testing.assert_array_equal(to_host(D3), ref._decompose_ntt(d[:3], 3))


def test_hybrid_multiply_relin_rescale(both_k2):
    ctx, ref = both_k2
    a, ra = enc2(both_k2, [1.0, 2.0, 3.0, 4.0])
    b, rb = enc2(both_k2, [0.5, 0.25, 2.0, -1.0])
    p = ctx.multiply(a, b)
    assert p.level == ctx.params.L - 1 and p.size == 2
    np.testing.assert_allclose(dec(ctx, p), [0.5, 0.5, 6.0, -4.0], rtol=1e-3,
                               atol=1e-3)
    same(p, ref.multiply(ra, rb))


def test_hybrid_multiply_depth_two_partial_digit(both_k2):
    """The second multiply relinearizes at level 3 (= a PARTIAL digit with
    k=2: digits {q0,q1}, {q2}): the level-restricted sub-product
    recombination path."""
    ctx, ref = both_k2
    a, ra = enc2(both_k2, [2.0, -1.5])
    b, rb = enc2(both_k2, [3.0, 2.0])
    c, rc = enc2(both_k2, [0.5, 4.0])
    p = ctx.multiply(ctx.multiply(a, b), c)
    assert p.level == ctx.params.L - 2
    np.testing.assert_allclose(dec(ctx, p, 2), [3.0, -12.0], rtol=2e-2,
                               atol=2e-2)
    same(p, ref.multiply(ref.multiply(ra, rb), rc))


def test_hybrid_rotation_full_and_partial_level(both_k2):
    ctx, ref = both_k2
    half = ctx.params.slot_count
    vals = np.arange(half, dtype=np.float64)
    ct, rct = enc2(both_k2, vals)
    got = np.real(ctx.decode(ctx.decrypt(ctx.rotate(ct, 3))))
    np.testing.assert_allclose(got, np.roll(vals, -3), atol=1e-2)
    low = ctx.mod_drop_to(ct, 3)                # partial digit level
    rot = ctx.rotate(low, -2)
    got = np.real(ctx.decode(ctx.decrypt(rot)))
    np.testing.assert_allclose(got, np.roll(vals, 2), atol=1e-2)
    same(ctx.rotate(ct, 3), ref.rotate(rct, 3))
    same(rot, ref.rotate(ref.mod_drop_to(rct, 3), -2))


def test_hybrid_jx32_bit_exact():
    """The k=2 key-switch path holds the words of the reference's device
    engine as well (same seed => same keys => same words)."""
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        c_pt, _ = pair(256, 4, 11, ks_digits=2)
        c32 = RefContext(RefParams.create(256, levels=4, seed=11,
                                          ks_digits=2, engine="jx32"))
        vals = [1.25, -0.75, 2.0]
        a_pt = c_pt.encrypt(c_pt.encode(vals))
        a32 = c32.encrypt(c32.encode(vals))
        same(a_pt, a32)
        same(c_pt.rotate(c_pt.multiply(a_pt, a_pt), 1),
             c32.rotate(c32.multiply(a32, a32), 1))


def test_key_material_is_order_independent():
    """Keys come from the counter PRNG at (seed, key id): two equal-seed
    contexts produce IDENTICAL keys regardless of the order keys are
    materialized in, and they are the reference's."""
    c1, ref = pair(512, 2, 99)
    c2, _ = pair(512, 2, 99)
    g = 3
    r1 = c1.get_relin_key()          # relin first, then galois
    k1 = c1.get_galois_key(g)
    k2 = c2.get_galois_key(g)        # galois first, then relin
    r2 = c2.get_relin_key()
    for a, b in ((r1, r2), (k1, k2)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert c1.public_seed == c2.public_seed == ref.public_seed != 99


@pytest.mark.parametrize("k", [1, 2])
def test_keys_equal_the_reference_s(k):
    """Public key, secret, relinearization key and a Galois key, word for
    word; `materialize_keys` builds each once."""
    ctx, ref = pair(512, 4, 77, ks_digits=k)
    np.testing.assert_array_equal(ctx.s_coeffs, ref.s_coeffs)
    for name in ("s_ntt_full", "pk_b_ntt", "pk_a_ntt"):
        np.testing.assert_array_equal(to_host(getattr(ctx, name)),
                                      getattr(ref, name))
    g = pow(3, 5, 2 * 512)
    keys = ctx.materialize_keys(["relin", f"galois_{g}"])
    for got, want in ((keys["relin"], ref.get_relin_key()),
                      (keys[f"galois_{g}"], ref.get_galois_key(g))):
        assert got[0].shape == (ctx.params.num_ks_digits, 4 + k, 512)
        np.testing.assert_array_equal(to_host(got[0]), want[0])
        np.testing.assert_array_equal(to_host(got[1]), want[1])
    assert ctx.get_relin_key()[0] is keys["relin"][0]


# ---- automatic level/scale alignment --------------------------------------

def test_add_mixed_levels_auto_aligns(both):
    """Fresh (level L) + rescaled product (level L-1): add mod-drops the
    fresher operand automatically."""
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0])
    b, rb = enc2(both, [3.0, 4.0])
    p = ctx.multiply(a, b)                      # level L-1, post-rescale
    s = ctx.add(p, a)                           # L-1 vs L
    assert s.level == ctx.params.L - 1
    np.testing.assert_allclose(dec(ctx, s, 2), [4.0, 10.0], rtol=1e-2,
                               atol=1e-2)
    same(s, ref.add(ref.multiply(ra, rb), ra))


def test_add_unrescaled_product_auto_rescales(both):
    """Raw product at scale² + fresh at scale: add rescales the product
    side down, then aligns levels."""
    ctx, ref = both
    a, ra = enc2(both, [1.0, 2.0])
    b, rb = enc2(both, [3.0, 4.0])
    p = ctx.multiply(a, b, rescale=False)       # scale², level L
    s = ctx.add(p, a)
    np.testing.assert_allclose(dec(ctx, s, 2), [4.0, 10.0], rtol=1e-2,
                               atol=1e-2)
    same(s, ref.add(ref.multiply(ra, rb, rescale=False), ra))


def test_sub_scale_drift_absorbed(both):
    """Two products rescaled by DIFFERENT primes carry slightly different
    scales; sub relabels to the common scale (drift ~2^-11 relative)."""
    ctx, ref = both
    a, ra = enc2(both, [2.0])
    b, rb = enc2(both, [5.0])
    p1 = ctx.multiply(a, b)                     # level L-1, scale s²/q_{L-1}
    p2 = ctx.multiply(ctx.multiply(a, a), b)    # level L-2 after 2 rescales
    s = ctx.sub(p2, p1)                         # 20 - 10
    np.testing.assert_allclose(dec(ctx, s, 1), [10.0], rtol=1e-2, atol=1e-2)
    same(s, ref.sub(ref.multiply(ref.multiply(ra, ra), rb),
                    ref.multiply(ra, rb)))


def test_add_bridges_fresh_operand_down_not_up():
    """Fresh (scale 2^28, full level) + twice-rescaled (scale ~2^24, one
    limb left): alignment must BRIDGE the fresh side down through its
    spare levels, keeping the common scale the SMALL one. Lifting the
    rescaled side up to 2^28 instead leaves <2 bits of coefficient
    headroom in the one remaining 30-bit limb: the DC coefficient wraps
    q0 and every slot shifts by q0/scale ≈ +4."""
    c, ref = pair(256, 3, 2, scale_bits=28)
    # mean ≈ -1.6 so the result's DC coefficient lands in (q0/2, q0) at a
    # lifted 2^28 scale but comfortably inside at the bridged ~2^24 scale
    vals = [-1.6] * 4
    w, rw = enc2((c, ref), vals)

    def twice_rescaled(cx, ct):
        acc = cx.rescale(cx._scale_lift(ct, round(cx.params.data_primes[2]
                                                  / 2 ** 4)))  # ~2^24, L2
        return cx.rescale(cx._scale_lift(acc, round(
            cx.params.data_primes[1] / 2 ** 0)))               # ~2^24, L1

    acc, racc = twice_rescaled(c, w), twice_rescaled(ref, rw)
    same(acc, racc)
    s = c.add(acc, w)
    assert s.scale < 2 ** 26, "fresh side must bridge DOWN"
    np.testing.assert_allclose(dec(c, s, 4), [2 * v for v in vals],
                               rtol=1e-2, atol=1e-2)
    same(s, ref.add(racc, rw))


def test_decrypt_bit_exact_vs_reference():
    """The [level, n] residues of the port's device decrypt equal the np64
    host decrypt word for word: at full level, after a rescale, and for a
    lazy size-3 product."""
    cp, cn = pair(256, 3, 21)
    vals = [1.25, -0.5, 3.0]
    ct_p, ct_n = enc2((cp, cn), vals)
    for make in (
        lambda c, ct: ct,                                  # fresh
        lambda c, ct: c.multiply(ct, ct),                  # relin+rescale
        lambda c, ct: c.multiply(ct, ct, relinearize=False,
                                 rescale=False),           # lazy size-3
    ):
        a = cn.decrypt(make(cn, ct_n))
        b = cp.decrypt(make(cp, ct_p))
        assert a.level == b.level and a.scale == b.scale
        assert np.array_equal(np.asarray(a.coeffs_rns), b.coeffs_rns)
        assert np.array_equal(cn.decode(a), cp.decode(b))
    got = cp.decode(cp.decrypt(cp.multiply(ct_p, ct_p))).real[:3]
    np.testing.assert_allclose(got, np.asarray(vals) ** 2, rtol=1e-2,
                               atol=1e-2)


# --------------------------------------------------- what the port adds

def test_multiply_plain_equals_the_reference(both_k2):
    ctx, ref = both_k2
    a, ra = enc2(both_k2, [1.0, 2.0, 3.0])
    low, rlow = ctx.mod_drop_to(a, 3), ref.mod_drop_to(ra, 3)
    vals = [0.5, -2.0, 4.0]
    got = ctx.multiply_plain(low, ctx.encode(vals))
    same(got, ref.multiply_plain(rlow, ref.encode(vals)))
    np.testing.assert_allclose(dec(ctx, got, 3), [0.5, -4.0, 12.0],
                               atol=1e-2)


def test_spot_check_at_n8192():
    """One recipe at a ring size the card's kernels take (n=8192, levels=3,
    k=2; here through the plain stage loop): keys, encryption, the product
    at full level and the rotation of the rescaled product at the partial
    level 2: all the reference's words."""
    ctx, ref = pair(8192, 3, 13, ks_digits=2)
    vals = np.linspace(-2.0, 2.0, 64)
    a, ra = enc2((ctx, ref), vals)
    p, rp = ctx.multiply(a, a), ref.multiply(ra, ra)
    same(p, rp)
    same(ctx.rotate(p, 1), ref.rotate(rp, 1))
    np.testing.assert_array_equal(to_host(ctx.get_relin_key()[0]),
                                  ref.get_relin_key()[0])
    np.testing.assert_allclose(dec(ctx, p, 64), vals ** 2, atol=1e-2)


def test_cpu_context_launches_no_kernel():
    """On the CPU every transform goes to the plain version: the launch
    counts of the kernel wrappers do not move."""
    before = dict(nk.launches)
    ctx, _ = pair(1024, 2, 3)
    a = ctx.encrypt(ctx.encode([1.0, 2.0]))
    ctx.rotate(ctx.multiply(a, a), 1)
    assert nk.launches == before


def test_leveled_views_and_tables_are_built_by_the_constructor(both_k2):
    """Nothing per level is left for first use (a CUDA-graph capture could
    not make it): 2·L views, each with contiguous tables of its own row
    count, the full-level ones zero-copy."""
    ctx = both_k2[0]
    L, k = ctx.params.L, ctx.params.ks_digits
    assert set(ctx._ntt_level) == set(ctx._ntt_cols) == set(range(1, L + 1))
    for level in range(1, L + 1):
        assert ctx._ntt_level[level].moduli == \
            ctx.params.coeff_modulus[:level]
        cols = ctx._ntt_cols[level]
        assert cols.moduli == (ctx.params.coeff_modulus[:level]
                               + ctx.params.special_primes)
        assert cols.fwd_tw.shape == (level + k, ctx.params.n)
        assert cols.fwd_tw.is_contiguous() and cols.q.is_contiguous()
        assert ctx._q_cols[level].shape == (level + k, 1)
        assert len(ctx._msd[level]) == k
    assert ctx._ntt_cols[L].fwd_tw.data_ptr() == \
        ctx.ntt_qp.fwd_tw.data_ptr()
    assert ctx._ntt_level[2].fwd_tw.data_ptr() == \
        ctx.ntt_qp.fwd_tw.data_ptr()


def test_per_level_key_slices_are_cached_by_key_id(both_k2):
    ctx = both_k2[0]
    L, k = ctx.params.L, ctx.params.ks_digits
    full = ctx._ksk_device("relin", L)
    assert full[0] is ctx.get_relin_key()[0]          # the key itself
    low = ctx._ksk_device("relin", 3)
    assert low[0].shape == (2, 3 + k, ctx.params.n) and \
        low[0].is_contiguous()
    assert ctx._ksk_device("relin", 3)[0] is low[0]
    one = ctx._ksk_device("relin", 1)
    assert one[0].shape == (1, 1 + k, ctx.params.n)
    want = torch.cat([full[0][:2, :3], full[0][:2, L:]], dim=1)
    assert torch.equal(low[0], want)


def test_fresh_caches_keeps_entries_from_crossing_a_run(both):
    """The trap of the identity-keyed decomposition cache: a static input
    tensor keeps its identity while its contents change. An entry made
    before a run must miss inside it, and one made inside must miss
    after."""
    ctx = both[0]
    a = ctx.encrypt(ctx.encode([1.0, 2.0, 3.0]))
    c = ctx.encrypt(ctx.encode([5.0, 6.0, 7.0]))
    static = a.data.clone()
    held = CkksCiphertext(static, a.level, a.scale)
    for k in ctx.counters:
        ctx.counters[k] = 0
    before = ctx.rotate(held, 1)                          # the warm-up
    with ctx.fresh_caches():
        inside = ctx.rotate(held, 1)                      # the capture
        assert ctx.counters["decomp"] == 2
        static.copy_(c.data)                              # a fresh input
    after = ctx.rotate(held, 1)
    assert ctx.counters["decomp"] == 3 and ctx.counters["decomp_hit"] == 0
    assert torch.equal(before.data, inside.data)
    assert torch.equal(after.data, ctx.rotate(c, 1).data)
    np.testing.assert_allclose(dec(ctx, after, 2), [6.0, 7.0], atol=1e-3)
    # without the emptying, the next run reads this one's transforms
    hits = ctx.counters["decomp_hit"]
    static.copy_(a.data)
    stale = ctx.rotate(held, 2)
    assert ctx.counters["decomp_hit"] == hits + 1
    assert not torch.equal(stale.data, ctx.rotate(a, 2).data)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CkksContext(CkksParams.create(256, levels=2, seed=1), "cuda")


def test_params_equal_the_reference_s():
    for kw in (dict(levels=3), dict(levels=4, ks_digits=2, scale_bits=29)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            p, r = CkksParams.create(1024, seed=1, **kw), \
                RefParams.create(1024, seed=1, **kw)
        for name in ("n", "coeff_modulus", "scale", "seed", "error_std",
                     "ks_digits", "L", "num_ks_digits", "digit_groups",
                     "slot_count", "special_prime", "data_primes",
                     "special_primes", "engine"):
            assert getattr(p, name) == getattr(r, name), name
    with pytest.raises(ValueError, match="ks_digits"):
        CkksParams.create(1024, levels=2, ks_digits=3)
    with pytest.raises(ValueError, match="at least one data prime"):
        CkksParams(n=1024, coeff_modulus=[97], ks_digits=1)
