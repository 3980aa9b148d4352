"""Checkpoint / resume: compiled circuits, keys and ciphertexts in files
(port of abc_tpu/utils/checkpoint.py, in its file format).

  * the compiled circuit: the JSON AST and the input types;
  * a BFV or CKKS context: its parameters and keys, numpy `.npz` with a JSON
    `__meta__` entry; the arrays are the reference's uint32 words under the
    reference's names (`s_coeffs`, `pk_b_ntt`, `pk_a_ntt`, `relin_b`,
    `relin_a`, `galois_<g>_b`, `galois_<g>_a`);
  * a ciphertext: its uint32 words (`.npy`; CKKS: `.npz` with the
    `(level, scale)` sidecar).

A file written by either package loads in the other with the same words.
The port holds residues as int32 on its device; they are below 2^30, so the
words are the same and only the dtype changes on the way out and in.

`seeded=True` leaves out the uniform `a` halves of the public and switching
keys; they are the counter-PRNG draws at (public seed, stream), which a load
regenerates on the device (`RlweKeys.install_keys`). That is how a client
hands a server its evaluation keys at half the bytes.

Two deliberate differences from the reference, both on files it writes
wrong (a first round trip and everything the reference computes right give
the same words):

  * a file saved without the secret key carries `"seed": null`. The
    reference writes the master seed, from which its loader regenerates the
    very secret the file left out. A context loaded from such a file holds
    no secret: decrypt and key builds raise, so a server never builds a
    key from a secret it does not have;
  * a loaded context keeps the file's public seed, so that a second seeded
    save regenerates the same `a` halves (the reference's loader draws a
    fresh one when `params.seed` is None, and its second save stores it).
    Every file carries the public seed, and a seeded save of keys whose
    halves that seed does not regenerate raises.

Load builds a fresh context first, as the reference does (a keygen from the
file's master seed), and then installs the restored keys: a seeded load
leaves the secret generator where the reference's is, so the next
encryption draws the same words in both packages. `load_context` and
`load_ckks_context` put the context on `device`, the card unless the caller
says otherwise; without one they raise.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from abc_tpu_torch.ops.modarith import as_residues, to_host
from abc_tpu_torch.utils.errors import RuntimeExecutionError


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available")
    return dev


def save_circuit(compiled, path: str) -> None:
    """Persist a CompiledProgram's circuit + input types as JSON."""
    payload = {
        "ast": compiled.ast.to_json(),
        "input_types": {k: str(v) for k, v in compiled.input_types.items()},
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_circuit(path: str):
    """The circuit re-typechecked into a CompiledProgram (aux=None: nothing
    at run time reads the vectorizer's packing report)."""
    from abc_tpu_torch.ast_ir.json_serde import from_json
    from abc_tpu_torch.passes.pipeline import CompiledProgram
    from abc_tpu_torch.passes.type_checking import run_type_checking
    from abc_tpu_torch.utils.datatype import Datatype

    with open(path) as f:
        payload = json.load(f)
    ast = from_json(payload["ast"])
    input_types = {}
    for k, v in payload["input_types"].items():
        secret = v.startswith("secret ")
        input_types[k] = Datatype.from_string(
            v[len("secret "):] if secret else v, secret)
    tcv = run_type_checking(ast, input_types)
    return CompiledProgram(ast=ast, tcv=tcv, input_types=input_types)


def _key_arrays(ctx, include_secret_key: bool, seeded: bool
                ) -> Dict[str, np.ndarray]:
    """The key arrays of a context under the reference's names."""
    if seeded and not ctx.uniform_halves_from_public_seed():
        raise RuntimeExecutionError(
            "seeded save: the public key's uniform half is not the one this "
            "context's public seed regenerates (keys restored from a file "
            "that did not carry its public seed); save it with seeded=False")
    arrays: Dict[str, np.ndarray] = {"pk_b_ntt": to_host(ctx.pk_b_ntt)}
    if not seeded:
        arrays["pk_a_ntt"] = to_host(ctx.pk_a_ntt)
    if include_secret_key:
        ctx._secret()
        arrays["s_coeffs"] = np.asarray(ctx.s_coeffs, dtype=np.int64)
    for key_id, (ksk_b, ksk_a) in ctx._keys.items():
        arrays[f"{key_id}_b"] = to_host(ksk_b)
        if not seeded:
            arrays[f"{key_id}_a"] = to_host(ksk_a)
    return arrays


def _save(ctx, path: str, include_secret_key: bool, seeded: bool,
          meta: dict) -> None:
    arrays = _key_arrays(ctx, include_secret_key, seeded)
    meta.update(seed=ctx.params.seed if include_secret_key else None,
                error_std=ctx.params.error_std,
                ks_digits=ctx.params.ks_digits, public_seed=ctx.public_seed)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def _restore(ctx, data, meta) -> None:
    """Install a file's keys into a freshly built context; halves a seeded
    file left out are regenerated on the context's device."""
    keys = {}
    for name in data.files:
        if name.endswith("_b") and (name == "relin_b"
                                    or name.startswith("galois_")):
            key_id = name[:-len("_b")]
            a_name = f"{key_id}_a"
            keys[key_id] = (data[name],
                            data[a_name] if a_name in data.files else None)
    ctx.install_keys(
        data["s_coeffs"] if "s_coeffs" in data.files else None,
        data["pk_b_ntt"],
        data["pk_a_ntt"] if "pk_a_ntt" in data.files else None,
        keys, public_seed=meta.get("public_seed"))


def save_context(ctx, path: str, include_secret_key: bool = True,
                 seeded: bool = False) -> None:
    """Persist a BFV context: params + keys (npz). seeded=True leaves out
    the uniform `a` halves (regenerated from the public seed on load): about
    half the bytes, and safe to publish, since the secret and error draws
    come from the other seed domain. include_secret_key=False leaves out
    the secret and the master seed it is drawn from."""
    p = ctx.params
    _save(ctx, path, include_secret_key, seeded,
          dict(n=p.n, coeff_modulus=p.coeff_modulus,
               plain_modulus=p.plain_modulus, engine=p.engine))


def load_context(path: str, device="cuda"):
    """A BFV context on `device` with the file's exact keys."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    from abc_tpu_torch.crypto.params import BfvParams

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    params = BfvParams(n=meta["n"],
                       coeff_modulus=list(meta["coeff_modulus"]),
                       plain_modulus=meta["plain_modulus"],
                       seed=meta["seed"], error_std=meta["error_std"],
                       ks_digits=meta.get("ks_digits", 1))
    ctx = BfvContext(params, device)
    _restore(ctx, data, meta)
    return ctx


def save_ciphertext(ct, path: str) -> None:
    """A BFV ciphertext's words, uint32 [k, L, n] (.npy)."""
    np.save(path, to_host(ct.data))


def load_ciphertext(path: str, device="cuda"):
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    return BfvCiphertext(as_residues(np.load(path), _device(device)))


# --------------------------------------------------------------------- CKKS

def save_ckks_context(ctx, path: str, include_secret_key: bool = True,
                      seeded: bool = False) -> None:
    """Persist a CKKS context: params + keys (npz), as save_context."""
    p = ctx.params
    _save(ctx, path, include_secret_key, seeded,
          dict(n=p.n, coeff_modulus=p.coeff_modulus, scale=p.scale,
               engine=p.engine))


def load_ckks_context(path: str, device="cuda"):
    """A CKKS context on `device` with the file's exact keys."""
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    params = CkksParams(n=meta["n"],
                        coeff_modulus=list(meta["coeff_modulus"]),
                        scale=meta["scale"], seed=meta["seed"],
                        error_std=meta["error_std"],
                        ks_digits=meta.get("ks_digits", 1))
    ctx = CkksContext(params, device)
    _restore(ctx, data, meta)
    return ctx


def save_ckks_ciphertext(ct, path: str) -> None:
    """CKKS ciphertext = RNS words + (level, scale) sidecar (.npz)."""
    np.savez_compressed(path, data=to_host(ct.data),
                        level=np.int64(ct.level), scale=np.float64(ct.scale))


def load_ckks_ciphertext(path: str, device="cuda"):
    from abc_tpu_torch.crypto.ckks import CkksCiphertext
    z = np.load(path)
    return CkksCiphertext(as_residues(z["data"], _device(device)),
                          int(z["level"]),
                          float(z["scale"]))
