"""Carry a reference BFV or CKKS context's state into the port.

`context_from_reference` is the FHE counterpart of converting a model's
weights: it takes the state of an `abc_tpu` BFV context as numpy arrays and
plain values — never the live object — and returns the port's `BfvContext`
holding that state on a torch device: the same secret and public key, the
switching keys built so far, the master seed (so keys built later are the
reference's too) and the position of the secret generator (so the next
encryption draws what the reference's next encryption draws). Both sides
then compute the same words, which is how the tests hold the port's
evaluation against the reference even for contexts made without a seed.
`ckks_context_from_reference` does the same for a CKKS context.
"""

from __future__ import annotations

from typing import Mapping

from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.params import BfvParams

STATE_KEYS = ("params", "master_seed", "rng_state", "s_coeffs", "s_ntt_full",
              "pk_b_ntt", "pk_a_ntt", "switching_keys")
PARAM_KEYS = ("n", "coeff_modulus", "plain_modulus", "seed", "error_std",
              "ks_digits")
CKKS_PARAM_KEYS = ("n", "coeff_modulus", "scale", "seed", "error_std",
                   "ks_digits")


def _check(state: Mapping, param_keys) -> None:
    missing = [k for k in STATE_KEYS if k not in state]
    missing += [f"params.{k}" for k in param_keys
                if k not in state.get("params", {})]
    if missing:
        raise ValueError(f"reference state lacks {missing}")


def context_from_reference(state: Mapping, device) -> BfvContext:
    """The port's BfvContext on `device` holding a reference context's state.

    state:
      params          {n, coeff_modulus, plain_modulus, seed, error_std,
                       ks_digits} (plain values)
      master_seed     int, the seed both randomness domains derive from
      rng_state       the secret generator's `bit_generator.state` dict
      s_coeffs        [n] signed secret coefficients
      s_ntt_full      [L+k, n] uint32, the secret in NTT form over q∪P
      pk_b_ntt, pk_a_ntt   [L, n] uint32, the public key in NTT form
      switching_keys  {"relin" | "galois_<g>": (ksk_b, ksk_a)}, each
                      [α, L+k, n] uint32
    """
    _check(state, PARAM_KEYS)
    p = state["params"]
    params = BfvParams(n=int(p["n"]),
                       coeff_modulus=[int(q) for q in p["coeff_modulus"]],
                       plain_modulus=int(p["plain_modulus"]), seed=p["seed"],
                       error_std=float(p["error_std"]),
                       ks_digits=int(p["ks_digits"]))
    return BfvContext(params, device, state=state)


def ckks_context_from_reference(state: Mapping, device) -> CkksContext:
    """The port's CkksContext on `device` holding a reference CKKS context's
    state: the layout of `context_from_reference`, with params {n,
    coeff_modulus, scale, seed, error_std, ks_digits} (the data primes
    first, the ks_digits special primes last)."""
    _check(state, CKKS_PARAM_KEYS)
    p = state["params"]
    params = CkksParams(n=int(p["n"]),
                        coeff_modulus=[int(q) for q in p["coeff_modulus"]],
                        scale=float(p["scale"]), seed=p["seed"],
                        error_std=float(p["error_std"]),
                        ks_digits=int(p["ks_digits"]))
    return CkksContext(params, device, state=state)
