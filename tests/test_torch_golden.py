"""The golden digests of abc_tpu_torch/testdata/golden.json against abc_tpu.

On a GPU host the port cannot ask abc_tpu for the oracle (it imports nothing
of it), so `chip_smoke.py` holds the card's result words against SHA-256
digests stored in the package. This file recomputes every digest from
abc_tpu's np64 engine and fails if the stored file is stale.

    python tests/test_torch_golden.py      # rewrite golden.json

A digest is the SHA-256 of the array's uint32 words, little-endian, C order.

The same run writes the reference-written checkpoint beside it
(CHECKPOINT["context"], CHECKPOINT["ciphertext"]: a seeded BFV context at
n=1024 and one ciphertext, from abc_tpu's np64 engine), whose restored keys,
plaintext and product the golden entry "checkpoint_bfv_n1024" holds; the
test of the same name fails if the committed files' words differ from a
fresh write.
"""

import functools
import hashlib
import json
import os
import sys
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "abc_tpu_torch", "testdata", "golden.json")

N = 8192
MULT = {"seed": 11, "a": [3, 4, 5], "b": [7, -2, 9]}
CKKS_MULT = {"n": 32768, "levels": 8, "seed": 3, "ks_digits": 2,
             "a": [1.5, -2.25, 3.0, 0.5, 100.5, -0.001]}
# a seeded BFV context file at n=1024 on the first 3 data primes of the
# n=1024 preset (the smallest chain on which one multiply decrypts), its
# relinearization key and one Galois key; one ciphertext
CHECKPOINT = {"n": 1024, "data_primes": 3, "seed": 77, "galois": 3,
              "values": [12, -5, 300, 7],
              "context": "ref_bfv_n1024_seeded.npz",
              "ciphertext": "ref_bfv_n1024_ct.npy"}
HAMMING = {
    "seed": 5,
    "inputs": "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};",
    "program": "int sum = 0; for (int i = 0; i < 4; i = i + 1) { "
               "sum = sum + (x[i]-y[i])*(x[i]-y[i]); } return sum;",
    "output": "hd = sum;",
}


def digest(words) -> str:
    arr = np.ascontiguousarray(np.asarray(words), dtype="<u4")
    return hashlib.sha256(arr.tobytes()).hexdigest()


@functools.lru_cache(maxsize=None)
def _mult_relin(k):
    """Keys and the mult+relin result of the np64 context (n=8192, k)."""
    from abc_tpu.crypto.bfv import BfvContext
    from abc_tpu.crypto.params import BfvParams
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ctx = BfvContext(BfvParams.create(N, seed=MULT["seed"], engine="np64",
                                          ks_digits=k))
    a, b = ctx.encrypt_many([ctx.encode(MULT["a"]), ctx.encode(MULT["b"])])
    out = ctx.multiply(a, b)
    relin_b, relin_a = ctx.get_relin_key()
    return {"n": N, "ks_digits": k, **MULT,
            "pk_b": digest(ctx.pk_b_ntt), "pk_a": digest(ctx.pk_a_ntt),
            "relin_b": digest(relin_b), "relin_a": digest(relin_a),
            "ct_a": digest(a.data), "ct_b": digest(b.data),
            "result": digest(out.data)}


@functools.lru_cache(maxsize=None)
def _hamming():
    """Output ciphertext of the README hamming program through abc_tpu's
    np64 factory (vectorized compile, n=8192)."""
    from abc_tpu import (CompileOptions, Parser, compile_program,
                         input_types_from_ast, run_compiled)
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    inputs = Parser.parse(HAMMING["inputs"])
    compiled = compile_program(HAMMING["program"],
                               input_types_from_ast(inputs),
                               CompileOptions(vectorize=True))
    factory = BfvCiphertextFactory(slots=N, seed=HAMMING["seed"],
                                   engine="np64")
    _, out = run_compiled(compiled, inputs, Parser.parse(HAMMING["output"]),
                          factory)
    ct = out[0][1]
    assert factory.decrypt(ct)[0] == 2
    return {"n": N, **HAMMING, "result": digest(ct.ct.data)}


@functools.lru_cache(maxsize=None)
def _ckks_mult_relin():
    """Keys and the multiply(a, a, rescale=False) result of the np64 CKKS
    context at the reference's own CKKS size (n=32768, 8 + 2 primes of 30
    bits, k=2)."""
    from abc_tpu.crypto.ckks import CkksContext, CkksParams
    r = CKKS_MULT
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ctx = CkksContext(CkksParams.create(
            r["n"], levels=r["levels"], seed=r["seed"], engine="np64",
            ks_digits=r["ks_digits"]))
    a = ctx.encrypt(ctx.encode(r["a"]))
    out = ctx.multiply(a, a, rescale=False)
    relin_b, relin_a = ctx.get_relin_key()
    return {**r, "pk_b": digest(ctx.pk_b_ntt), "pk_a": digest(ctx.pk_a_ntt),
            "relin_b": digest(relin_b), "relin_a": digest(relin_a),
            "ct_a": digest(a.data), "result": digest(out.data)}


def _checkpoint_params():
    from abc_tpu.crypto.params import BfvParams
    r = CHECKPOINT
    preset = BfvParams.create(r["n"], seed=r["seed"], engine="np64")
    return BfvParams(n=r["n"], plain_modulus=preset.plain_modulus,
                     coeff_modulus=(preset.coeff_modulus[:r["data_primes"]]
                                    + preset.coeff_modulus[-1:]),
                     engine="np64", seed=r["seed"])


def write_checkpoint(directory):
    """Write the checkpoint fixture into `directory` from abc_tpu's np64
    engine; returns its golden entry (digests of the keys a load restores,
    the plaintext, the relinearized product of the ciphertext with
    itself)."""
    from abc_tpu.crypto.bfv import BfvContext
    from abc_tpu.utils.checkpoint import save_ciphertext, save_context
    r = CHECKPOINT
    ctx = BfvContext(_checkpoint_params())
    relin_b, relin_a = ctx.get_relin_key()
    gal_b, gal_a = ctx.get_galois_key(r["galois"])
    ct = ctx.encrypt(ctx.encode(r["values"]))
    save_context(ctx, os.path.join(directory, r["context"]), seeded=True)
    save_ciphertext(ct, os.path.join(directory, r["ciphertext"]))
    prod = ctx.multiply(ct, ct)
    square = [v * v for v in r["values"]]
    assert ctx.decode(ctx.decrypt(prod))[:len(square)] == square
    g = r["galois"]
    return {**r, "coeff_modulus": ctx.params.coeff_modulus,
            "plain_modulus": ctx.params.plain_modulus,
            "s_coeffs": digest(np.asarray(ctx.s_coeffs).astype(np.uint32)),
            "pk_b": digest(ctx.pk_b_ntt), "pk_a": digest(ctx.pk_a_ntt),
            "relin_b": digest(relin_b), "relin_a": digest(relin_a),
            f"galois_{g}_b": digest(gal_b), f"galois_{g}_a": digest(gal_a),
            "ct": digest(ct.data), "product": digest(prod.data),
            "product_plain": square}


@functools.lru_cache(maxsize=None)
def _checkpoint():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return write_checkpoint(tmp)


ENTRIES = {"mult_relin_n8192_k1": lambda: _mult_relin(1),
           "mult_relin_n8192_k2": lambda: _mult_relin(2),
           "hamming_n8192": _hamming,
           "ckks_mult_relin_n32768_k2": _ckks_mult_relin,
           "checkpoint_bfv_n1024": _checkpoint}


def compute():
    return {name: make() for name, make in ENTRIES.items()}


def _stored():
    with open(GOLDEN) as f:
        return json.load(f)


CASES = [("mult_relin_n8192_k1", f) for f in
         ("pk_b", "pk_a", "relin_b", "relin_a", "ct_a", "ct_b", "result")] + \
        [("mult_relin_n8192_k2", f) for f in
         ("pk_b", "pk_a", "relin_b", "relin_a", "ct_a", "ct_b", "result")] + \
        [("hamming_n8192", "result")] + \
        [("ckks_mult_relin_n32768_k2", f) for f in
         ("pk_b", "pk_a", "relin_b", "relin_a", "ct_a", "result")] + \
        [("checkpoint_bfv_n1024", f) for f in
         ("s_coeffs", "pk_b", "pk_a", "relin_b", "relin_a", "galois_3_b",
          "galois_3_a", "ct", "product", "product_plain")]


@pytest.mark.parametrize("entry,field", CASES,
                         ids=[f"{e}-{f}" for e, f in CASES])
def test_stored_digest_is_the_reference_s(entry, field):
    assert _stored()[entry][field] == ENTRIES[entry]()[field]


def test_stored_recipes_are_this_file_s():
    """Seeds, inputs and program text, which chip_smoke.py reads from the
    file, are the ones the digests were made from; no entry is extra."""
    stored = _stored()
    assert set(stored) == {e for e, _ in CASES}
    for key in ("n", "seed", "a", "b", "ks_digits"):
        for k in (1, 2):
            want = {"n": N, "ks_digits": k, **MULT}[key]
            assert stored[f"mult_relin_n8192_k{k}"][key] == want
    for key in ("n", "seed", "inputs", "program", "output"):
        assert stored["hamming_n8192"][key] == {"n": N, **HAMMING}[key]
    for key, want in CKKS_MULT.items():
        assert stored["ckks_mult_relin_n32768_k2"][key] == want
    for key, want in CHECKPOINT.items():
        assert stored["checkpoint_bfv_n1024"][key] == want


def _arrays(path):
    z = np.load(path, allow_pickle=False)
    if isinstance(z, np.ndarray):
        return {"": z}
    with z:
        return {name: z[name] for name in z.files}


@pytest.mark.parametrize("name", ["context", "ciphertext"])
def test_checkpoint_fixture_is_the_reference_s(tmp_path, name):
    """The committed checkpoint files hold the words (and the meta) that
    abc_tpu writes for the recipe now."""
    write_checkpoint(str(tmp_path))
    fresh = _arrays(os.path.join(str(tmp_path), CHECKPOINT[name]))
    stored = _arrays(os.path.join(os.path.dirname(GOLDEN), CHECKPOINT[name]))
    assert sorted(stored) == sorted(fresh)
    for key in fresh:
        assert stored[key].dtype == fresh[key].dtype, key
        assert np.array_equal(stored[key], fresh[key]), key


def test_checkpoint_fixture_is_small():
    assert sum(os.path.getsize(os.path.join(os.path.dirname(GOLDEN),
                                            CHECKPOINT[name]))
               for name in ("context", "ciphertext")) < 200_000


def test_port_restores_the_fixture_to_its_digests():
    """What chip_smoke.py phase 11 holds on the card, on the CPU: the port
    reads abc_tpu's seeded file to the stored key digests, decrypts the
    stored ciphertext and multiplies it to the golden product."""
    from abc_tpu_torch.ops.modarith import to_host
    from abc_tpu_torch.utils import checkpoint
    g = _stored()["checkpoint_bfv_n1024"]
    here = os.path.dirname(GOLDEN)
    ctx = checkpoint.load_context(os.path.join(here, g["context"]), "cpu")
    ct = checkpoint.load_ciphertext(os.path.join(here, g["ciphertext"]),
                                    "cpu")
    relin, gal = ctx.get_relin_key(), ctx.get_galois_key(g["galois"])
    got = {"s_coeffs": digest(np.asarray(ctx.s_coeffs).astype(np.uint32)),
           "pk_b": digest(to_host(ctx.pk_b_ntt)),
           "pk_a": digest(to_host(ctx.pk_a_ntt)),
           "relin_b": digest(to_host(relin[0])),
           "relin_a": digest(to_host(relin[1])),
           "galois_3_b": digest(to_host(gal[0])),
           "galois_3_a": digest(to_host(gal[1])), "ct": digest(to_host(ct.data))}
    assert got == {k: g[k] for k in got}
    assert ctx.decode(ctx.decrypt(ct))[:4] == g["values"]
    prod = ctx.multiply(ct, ct)
    assert digest(to_host(prod.data)) == g["product"]
    assert ctx.decode(ctx.decrypt(prod))[:4] == g["product_plain"]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    entries = compute()
    entries["checkpoint_bfv_n1024"] = write_checkpoint(
        os.path.dirname(GOLDEN))
    with open(GOLDEN, "w") as f:
        json.dump(entries, f, indent=1)
        f.write("\n")
    print("wrote", GOLDEN, "and the checkpoint fixture beside it")
