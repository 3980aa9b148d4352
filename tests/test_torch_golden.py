"""The golden digests of abc_tpu_torch/testdata/golden.json against abc_tpu.

On a GPU host the port cannot ask abc_tpu for the oracle (it imports nothing
of it), so `chip_smoke.py` holds the card's result words against SHA-256
digests stored in the package. This file recomputes every digest from
abc_tpu's np64 engine and fails if the stored file is stale.

    python tests/test_torch_golden.py      # rewrite golden.json

A digest is the SHA-256 of the array's uint32 words, little-endian, C order.
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


ENTRIES = {"mult_relin_n8192_k1": lambda: _mult_relin(1),
           "mult_relin_n8192_k2": lambda: _mult_relin(2),
           "hamming_n8192": _hamming,
           "ckks_mult_relin_n32768_k2": _ckks_mult_relin}


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
         ("pk_b", "pk_a", "relin_b", "relin_a", "ct_a", "result")]


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


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    with open(GOLDEN, "w") as f:
        json.dump(compute(), f, indent=1)
        f.write("\n")
    print("wrote", GOLDEN)
