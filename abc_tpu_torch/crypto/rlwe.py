"""What the two RLWE schemes of the port share (crypto/bfv.py, crypto/ckks.py):
the randomness design, key generation, the switching-key composition, the
Galois permutation tables and the identity-keyed cache.

The reference says it of its own two contexts: CKKS reuses BFV's batched key
composition verbatim, so that a key is a function of (master seed, key id)
alone in either scheme. Here that is one class both contexts derive from.

A context that derives from `RlweKeys` provides, before it calls
`_init_keys`:

  params          n, coeff_modulus, L, ks_digits, num_ks_digits, error_std,
                  seed
  device          the torch device everything key-sized lives on
  full            L + k, the size of the extended base q∪P
  ntt_qp, ntt_q   NttContext over q∪P and over the data primes q
  q_q             [L, 1] column of the data primes
  _tab            device tables with "q_full" [L+k, 1] and "ks_factors"
                  [α, L+k, 1] (P·W_j mod every modulus)
  counters        dict of operation counts (`_cached` moves two of them)

Randomness follows the reference draw for draw:

* small draws (ternary secret, Gaussian errors) are numpy Generator draws on
  the host, in the reference's order: the context's `rng` (SECRET domain of
  the master seed) gives s, e_pk, then (u, e0, e1) per encryption; each
  switching key's errors come from a generator keyed by (secret seed,
  "<key id>/e"), as float32 ziggurat normals;
* every uniform polynomial comes from the counter PRNG at (PUBLIC-domain
  seed, stream): "pk", "<key id>/d<i>" (crypto/prng.py), generated on the
  device.

A switching key toward a target secret s2 is the hybrid construction with
digit size k = params.ks_digits: ksk_j = (−(a_j·s + e_j) + P·W_j·s2, a_j)
over q∪P, W_j the CRT basis element of digit Q_j.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from abc_tpu_torch.crypto.ntt import eval_perm_tables
from abc_tpu_torch.crypto.prng import (derive_key, seeded_rng, split_domain,
                                       uniform_rns)
from abc_tpu_torch.ops.modarith import as_residues, t64
from abc_tpu_torch.utils.errors import RuntimeExecutionError

_CACHE_CAP = 8


class RlweKeys:
    """Secret, public key and switching keys of one parameter set on one
    device (see the module note for what the deriving context provides)."""

    def _init_keys(self, state: Optional[Mapping]) -> None:
        """Seeds, the secret generator and the keys: generated from
        params.seed (or OS entropy), or taken from `state` (a reference
        context's, see convert.py), in which case nothing is drawn."""
        params, dev = self.params, self.device
        self._perm_dev: Dict = {}
        # switching keys by id ("relin" / "galois_<g>") → device (b, a)
        self._keys: Dict[str, Tuple] = {}
        self._master_seed = int(
            state["master_seed"] if state is not None else
            params.seed if params.seed is not None else
            np.random.default_rng().integers(0, 2 ** 63))
        self._prng_seed = split_domain(self._master_seed, "public")
        self._sec_seed = split_domain(self._master_seed, "secret")
        self.rng = np.random.default_rng(self._sec_seed)
        if state is None:
            self._keygen()
            return
        self.rng.bit_generator.state = state["rng_state"]
        self.s_coeffs = np.asarray(state["s_coeffs"], dtype=np.int64)
        self.s_ntt_full = as_residues(state["s_ntt_full"], dev)
        self.pk_b_ntt = as_residues(state["pk_b_ntt"], dev)
        self.pk_a_ntt = as_residues(state["pk_a_ntt"], dev)
        for key_id, (ksk_b, ksk_a) in state["switching_keys"].items():
            self._keys[key_id] = (as_residues(ksk_b, dev),
                                  as_residues(ksk_a, dev))

    # -------------------------------------------------------------- sampling
    def _sample_ternary(self) -> np.ndarray:
        return self.rng.integers(-1, 2, size=self.params.n).astype(np.int64)

    def _sample_error(self) -> np.ndarray:
        e = np.rint(self.rng.normal(0.0, self.params.error_std,
                                    self.params.n))
        return np.clip(e, -19, 19).astype(np.int64)

    def _lift_signed(self, coeffs: np.ndarray, q_col: torch.Tensor
                     ) -> torch.Tensor:
        """Small signed host coefficients [..., n] (|v| ≤ 127) → residues
        [..., L', n] on the device, L' the rows of q_col. Only the int8
        samples cross to the device."""
        v = torch.from_numpy(np.ascontiguousarray(coeffs, dtype=np.int8)
                             ).to(self.device).to(torch.int64)
        return torch.remainder(v[..., None, :],
                               q_col.to(torch.int64)).to(torch.int32)

    @property
    def public_seed(self) -> int:
        """The PUBLIC-domain seed: regenerates every uniform `a` component
        (public key, switching-key digits) and reveals nothing about the
        secret and error draws, which are keyed from the other domain."""
        return self._prng_seed

    def _uniform_rns(self, num_limbs: int, streams) -> torch.Tensor:
        """Uniform residues over the first num_limbs moduli on the device,
        from the counter PRNG at (public seed, stream): [L', n] for one
        stream label, [len(streams), L', n] for a list of them."""
        single = isinstance(streams, str)
        keys = [derive_key(self._prng_seed, s)
                for s in ([streams] if single else streams)]
        k0, k1 = [k[0] for k in keys], [k[1] for k in keys]
        if single:
            k0, k1 = k0[0], k1[0]
        return uniform_rns(k0, k1, self.params.coeff_modulus[:num_limbs],
                           self.params.n, self.device)

    # ---------------------------------------------------------------- keygen
    def _keygen(self) -> None:
        """Secret key (NTT form over q∪P) and public key over q, NTT domain:
        (b = −(a·s + e), a), computed on the device."""
        L = self.params.L
        self.s_coeffs = self._sample_ternary()
        e_pk = self._sample_error()
        self.s_ntt_full = self.ntt_qp.fwd(
            self._lift_signed(self.s_coeffs, self._tab["q_full"]))
        a_ntt = self._uniform_rns(L, "pk")   # uniform is uniform in NTT form
        e_ntt = self.ntt_q.fwd(self._lift_signed(e_pk, self.q_q))
        as_ntt = t64.mul(a_ntt, self.s_ntt_full[:L], self.q_q)
        self.pk_b_ntt = t64.sub(t64.neg(as_ntt, self.q_q), e_ntt, self.q_q)
        self.pk_a_ntt = a_ntt

    def _ksk_errors(self, stream: str) -> np.ndarray:
        """[α, n] Gaussian errors for one switching key, from a generator
        keyed by (secret seed, stream): order-independent, so repeated
        builds give the same key. float32 ziggurat normals drawn with numpy,
        as the reference draws them."""
        rng_e = seeded_rng(self._sec_seed, f"{stream}/e")
        e = np.rint(rng_e.standard_normal(
            (self.params.num_ks_digits, self.params.n), dtype=np.float32)
            * np.float32(self.params.error_std))
        return np.clip(e, -19, 19).astype(np.int64)

    def _secret(self) -> torch.Tensor:
        """The secret in NTT form over q∪P; raises where the context holds
        none (restored from a file saved without it): decryption and key
        builds need it, encryption and evaluation with the held keys do
        not."""
        if self.s_ntt_full is None:
            raise RuntimeExecutionError(
                "this context holds no secret key (it was restored from a "
                "file saved without one): it encrypts and evaluates with the "
                "keys it holds, and cannot decrypt or build a switching key")
        return self.s_ntt_full

    def _ksk_target(self, key_id: str) -> torch.Tensor:
        """NTT-domain target secret for a key id: s² for "relin", τ_g(s) for
        "galois_<g>", the latter as the evaluation-domain permutation."""
        s = self._secret()
        if key_id == "relin":
            return t64.mul(s, s, self._tab["q_full"])
        g = int(key_id[len("galois_"):])
        return s.index_select(-1, self._galois_perm_eval(g))

    def _build_key(self, key_id: str) -> Tuple:
        """One switching key toward the target secret of `key_id`, on the
        device: (ksk_b, ksk_a), each [α, L+k, n]. All α digits in one
        batch: one Threefry call, one forward NTT of α·(L+k) rows. The
        stream label is the key id, so any engine regenerates the same key
        from (seed, id) alone."""
        q_full = self._tab["q_full"]
        target = self._ksk_target(key_id)
        a = self._ksk_uniform(key_id)
        e_ntt = self.ntt_qp.fwd(
            self._lift_signed(self._ksk_errors(key_id), q_full))
        term = t64.mul(target[None], self._tab["ks_factors"], q_full)
        a_s = t64.mul(a, self.s_ntt_full[None], q_full)
        b = t64.add(t64.sub(t64.neg(a_s, q_full), e_ntt, q_full), term,
                    q_full)
        return b, a

    def _ksk_uniform(self, key_id: str) -> torch.Tensor:
        """The uniform halves [α, L+k, n] of a switching key: one stream
        "<key id>/d<i>" per digit at the public seed."""
        return self._uniform_rns(
            self.full,
            [f"{key_id}/d{i}" for i in range(self.params.num_ks_digits)])

    def materialize_keys(self, key_ids: Sequence[str]) -> Dict[str, Tuple]:
        """Device key pairs for a set of key ids ("relin" / "galois_<g>"),
        building each missing one once."""
        for key_id in key_ids:
            if key_id not in self._keys:
                self._keys[key_id] = self._build_key(key_id)
        return {key_id: self._keys[key_id] for key_id in key_ids}

    def get_relin_key(self) -> Tuple:
        return self.materialize_keys(["relin"])["relin"]

    def get_galois_key(self, galois_elt: int) -> Tuple:
        key_id = f"galois_{galois_elt}"
        return self.materialize_keys([key_id])[key_id]

    # --------------------------------------------------------- restored keys
    def install_keys(self, s_coeffs: Optional[np.ndarray], pk_b_ntt,
                     pk_a_ntt, switching_keys: Mapping,
                     public_seed: Optional[int] = None) -> None:
        """Replace the keys of this context by restored ones (a checkpoint's,
        utils/checkpoint.py): the counterpart of the reference's
        sync_device_keys after its loader overwrote the constructor's keys.
        The secret generator is left as the constructor's keygen left it, so
        a context built from the file's master seed draws, encryption for
        encryption, what the reference's restored context draws.

        s_coeffs None: the context holds no secret from here on (decrypt and
        key builds raise). public_seed: the seed the file's uniform halves
        come from; it becomes this context's public seed, so that keys built
        later and a second seeded save agree with the restored keys. An `a`
        half given as None (pk_a_ntt, or the second of a switching key's
        pair) is regenerated on the device from that seed."""
        dev = self.device
        if public_seed is not None:
            self._prng_seed = int(public_seed)
        elif pk_a_ntt is None or any(a is None for _, a in
                                     switching_keys.values()):
            raise ValueError("uniform key halves to regenerate, but no "
                             "public seed to regenerate them from")
        if s_coeffs is None:
            self.s_coeffs = self.s_ntt_full = None
        else:
            self.s_coeffs = np.asarray(s_coeffs, dtype=np.int64)
            self.s_ntt_full = self.ntt_qp.fwd(
                self._lift_signed(self.s_coeffs, self._tab["q_full"]))
        self.pk_b_ntt = as_residues(pk_b_ntt, dev)
        self.pk_a_ntt = (self._uniform_rns(self.params.L, "pk")
                         if pk_a_ntt is None else as_residues(pk_a_ntt, dev))
        self._keys = {
            key_id: (as_residues(ksk_b, dev),
                     self._ksk_uniform(key_id) if ksk_a is None
                     else as_residues(ksk_a, dev))
            for key_id, (ksk_b, ksk_a) in switching_keys.items()}
        self._forget_key_tables()

    def _forget_key_tables(self) -> None:
        """Empty every table derived from the keys (the identity-keyed
        caches; a context with per-key tables of its own extends this)."""
        with self.fresh_caches():
            pass

    def uniform_halves_from_public_seed(self) -> bool:
        """Whether the public key's uniform half is the one this context's
        public seed regenerates: what a seeded save relies on."""
        return torch.equal(self._uniform_rns(self.params.L, "pk"),
                           self.pk_a_ntt)

    # ------------------------------------------------------- Galois tables
    def _galois_perm(self, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coefficient-domain gather indices + keep-sign mask for x → x^g,
        on the device, cached per g."""
        if g not in self._perm_dev:
            n = self.params.n
            j = np.arange(n, dtype=np.int64)
            jg = (j * g) % (2 * n)
            wrap = jg >= n
            idx = np.where(wrap, jg - n, jg)
            gather = np.empty(n, dtype=np.int64)
            sign_pos = np.empty(n, dtype=bool)
            gather[idx] = j
            sign_pos[idx] = ~wrap
            self._perm_dev[g] = (torch.from_numpy(gather).to(self.device),
                                 torch.from_numpy(sign_pos).to(self.device))
        return self._perm_dev[g]

    def _galois_perm_eval(self, g: int) -> torch.Tensor:
        """Evaluation-domain gather indices for x → x^g, on the device,
        cached per g: position p holds the evaluation at ψ^e_p with e_p =
        2·brv(p)+1, and the automorphism is the pure permutation out[p] =
        in[pos(e_p·g mod 2n)], with no signs. This is what lets a
        decomposition be permuted after its forward NTTs (hoisting)."""
        key = ("eval", g)
        if key not in self._perm_dev:
            n = self.params.n
            e, pos_of_exp = eval_perm_tables(n)
            self._perm_dev[key] = torch.from_numpy(
                pos_of_exp[(e * g) % (2 * n)]).to(self.device)
        return self._perm_dev[key]

    # ------------------------------------------------- identity-keyed cache
    def _cached(self, cache: OrderedDict, ct_data, counter: str, make):
        """Identity-keyed LRU lookup (verified with `is`: ids recycle)."""
        key = id(ct_data)
        hit = cache.get(key)
        if hit is not None and hit[0] is ct_data:
            cache.move_to_end(key)
            self.counters[counter + "_hit"] += 1
            return hit[1]
        self.counters[counter] += 1
        value = make()
        cache[key] = (ct_data, value)
        while len(cache) > _CACHE_CAP:
            cache.popitem(last=False)
        return value
