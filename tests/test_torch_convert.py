"""abc_tpu_torch.convert: a reference context's state, pulled out as numpy
arrays and plain values, carried into the port.

`reference_state` is the helper the port's tests use to hold the port's
evaluation against a live abc_tpu context (seeded or not); it lives here,
not in the package, because the package imports nothing of abc_tpu.
"""

import numpy as np
import pytest

from abc_tpu.crypto.bfv import BfvContext as RefBfvContext
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu.crypto.ckks import CkksContext as RefCkksContext
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu_torch.convert import (ckks_context_from_reference,
                                   context_from_reference)
from abc_tpu_torch.ops.modarith import to_host

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")


def reference_state(ref) -> dict:
    """The state of an abc_tpu BfvContext or CkksContext as numpy arrays and
    plain values, in the layout `context_from_reference` documents."""
    p = ref.params
    scheme = ({"scale": p.scale} if isinstance(ref, RefCkksContext)
              else {"plain_modulus": p.plain_modulus})
    keys = {}
    if ref.relin_key is not None:
        keys["relin"] = ref.relin_key
    for g, key in ref.galois_keys.items():
        keys[f"galois_{g}"] = key
    return {
        "params": {"n": p.n, "coeff_modulus": list(p.coeff_modulus),
                   "seed": p.seed, "error_std": p.error_std,
                   "ks_digits": p.ks_digits, **scheme},
        "master_seed": int(ref._master_seed),
        "rng_state": ref.rng.bit_generator.state,
        "s_coeffs": np.asarray(ref.s_coeffs),
        "s_ntt_full": np.asarray(ref.s_ntt_full),
        "pk_b_ntt": np.asarray(ref.pk_b_ntt),
        "pk_a_ntt": np.asarray(ref.pk_a_ntt),
        "switching_keys": {k: (np.asarray(b), np.asarray(a))
                           for k, (b, a) in keys.items()},
    }


def port_of(ref, device="cpu"):
    """The port's context holding `ref`'s state."""
    return context_from_reference(reference_state(ref), device)


@pytest.mark.parametrize("k", [1, 2])
def test_unseeded_context_evaluates_like_the_reference(k):
    """No seed: the keys exist only in the reference context. The port,
    given its state, encrypts, multiplies, rotates and decrypts the same
    words, and builds the same later keys from the carried master seed."""
    ref = RefBfvContext(RefBfvParams.create(1024, engine="np64",
                                            ks_digits=k))
    ref.get_relin_key()                       # a key built before the copy
    port = port_of(ref)
    assert set(port._keys) == {"relin"}
    a, b = [3, -1, 4], [1, 5, -9]
    pa, pb = port.encrypt_many([port.encode(a), port.encode(b)])
    ra, rb = ref.encrypt_many([ref.encode(a), ref.encode(b)])
    np.testing.assert_array_equal(to_host(pa.data), ra.data)
    np.testing.assert_array_equal(to_host(pb.data), rb.data)
    got = port.rotate_rows(port.multiply(pa, pb), 1)    # galois key: new
    want = ref.rotate_rows(ref.multiply(ra, rb), 1)
    np.testing.assert_array_equal(to_host(got.data), want.data)
    assert port.decode(port.decrypt(got))[:2] == [-5, -36]
    g = pow(3, 1, 2048)
    np.testing.assert_array_equal(to_host(port.get_galois_key(g)[0]),
                                  ref.get_galois_key(g)[0])


def test_state_is_arrays_and_plain_values():
    ref = RefBfvContext(RefBfvParams.create(1024, engine="np64", seed=1))
    state = reference_state(ref)

    def plain(v):
        if isinstance(v, dict):
            return all(plain(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        return v is None or isinstance(v, (int, float, str, np.ndarray))

    assert plain(state)


@pytest.mark.parametrize("drop", ["rng_state", "pk_a_ntt", "params.ks_digits"])
def test_incomplete_state_is_refused(drop):
    ref = RefBfvContext(RefBfvParams.create(1024, engine="np64", seed=1))
    state = reference_state(ref)
    if drop.startswith("params."):
        del state["params"][drop.split(".")[1]]
    else:
        del state[drop]
    with pytest.raises(ValueError, match=drop):
        context_from_reference(state, "cpu")


# ------------------------------------------------------------------- CKKS

@pytest.mark.parametrize("k", [1, 2])
def test_unseeded_ckks_context_evaluates_like_the_reference(k):
    """ckks_context_from_reference round trip: no seed, so the keys exist
    only in the reference context. The port, given its state, draws for the
    next encryption what the reference draws, multiplies, rescales, rotates
    and decrypts the same words, and builds the same later keys from the
    carried master seed."""
    ref = RefCkksContext(RefCkksParams.create(256, levels=4, engine="np64",
                                              ks_digits=k))
    ref.get_relin_key()                       # a key built before the copy
    ref.encrypt(ref.encode([9.0]))            # the generator has moved on
    state = reference_state(ref)
    port = ckks_context_from_reference(state, "cpu")
    assert set(port._keys) == {"relin"}
    assert port.params.scale == ref.params.scale and port.params.L == 4
    vals = [1.5, -2.0, 0.25]
    pa, ra = port.encrypt(port.encode(vals)), ref.encrypt(ref.encode(vals))
    np.testing.assert_array_equal(to_host(pa.data), ra.data)
    got = port.rotate(port.multiply(pa, pa), 1)         # galois key: new
    want = ref.rotate(ref.multiply(ra, ra), 1)
    np.testing.assert_array_equal(to_host(got.data), want.data)
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(port.decode(port.decrypt(got)),
                                  ref.decode(ref.decrypt(want)))
    np.testing.assert_allclose(
        np.real(port.decode(port.decrypt(got)))[:2], [4.0, 0.0625],
        atol=1e-2)
    g = pow(3, 1, 512)
    np.testing.assert_array_equal(to_host(port.get_galois_key(g)[0]),
                                  ref.get_galois_key(g)[0])
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


@pytest.mark.parametrize("drop", ["rng_state", "switching_keys",
                                  "params.scale"])
def test_incomplete_ckks_state_is_refused(drop):
    ref = RefCkksContext(RefCkksParams.create(256, levels=2, engine="np64",
                                              seed=1))
    state = reference_state(ref)
    if drop.startswith("params."):
        del state["params"][drop.split(".")[1]]
    else:
        del state[drop]
    with pytest.raises(ValueError, match=drop):
        ckks_context_from_reference(state, "cpu")
