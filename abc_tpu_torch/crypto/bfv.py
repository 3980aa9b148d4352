"""RNS-BFV evaluation on torch tensors (port of the evaluation half of
abc_tpu/crypto/bfv.py).

A `BfvContext` here wraps a reference np64 `abc_tpu.crypto.bfv.BfvContext`
(the host half: keygen, switching-key construction, encode/decode,
encryption and decryption, noise budget) and carries its keys and tables on
a torch device. Everything on the evaluation path — add/sub/negate, plain
ops, BEHZ ct·ct multiply, relinearization, hybrid key switching (k = 1 and
k ≥ 2), Galois rotations with hoisting — runs on int32 device tensors
through the torch engine and the NTT kernels, and produces the reference's
words exactly. Ciphertexts are the reference's `BfvCiphertext` dataclass
holding a [k, L, n] int32 tensor.

Build one with `abc_tpu_torch.convert.context_from_reference`. The
reference context is only ever asked for host work, never handed a tensor.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from abc_tpu.crypto.behz import BehzContext as RefBehzContext
from abc_tpu.crypto.bfv import BfvCiphertext, Plaintext
from abc_tpu.utils.errors import RuntimeExecutionError
from abc_tpu_torch.crypto.behz import BehzContext
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops.modarith import as_residues, t64, to_host

_CACHE_CAP = 8


class BfvContext:
    """Device keys + tables for one BFV parameter set (see module doc)."""

    def __init__(self, ref, device):
        self.ref = ref
        self.params = params = ref.params
        self.device = dev = torch.device(device)
        self.counters: Dict[str, int] = {
            "relin": 0, "galois": 0, "decomp": 0, "decomp_hit": 0,
            "mult": 0, "op_ntt": 0, "op_ntt_hit": 0}
        n, L = params.n, params.L
        self.full = ref.full
        self.ntt_q = NttContext(n, params.data_primes, dev)
        self.ntt_qp = NttContext(n, params.coeff_modulus, dev)
        self._tab = {k: as_residues(v, dev) for k, v in ref._host.items()}
        self.q_q = self._tab["q_full"][:L]                 # [L, 1]
        self._msd_half = list(ref._msd_half)
        if params.ks_digits > 1:
            self._dec_gather = torch.from_numpy(
                ref._dec_gather.reshape(-1)).to(dev)
        self.s_ntt_full = as_residues(ref.s_ntt_full, dev)
        self.pk_b_ntt = as_residues(ref.pk_b_ntt, dev)
        self.pk_a_ntt = as_residues(ref.pk_a_ntt, dev)
        # switching keys: host key id → host pair (built by the reference's
        # host path) and host pair → device pair (identity-keyed)
        self._host_keys: Dict[str, Tuple] = {}
        self._ksk_dev_cache: Dict[int, Tuple] = {}
        for key in [ref.relin_key, *ref.galois_keys.values()]:
            if key is not None:
                self._ksk_device(key)
        if ref.relin_key is not None:
            self._host_keys["relin"] = ref.relin_key
        for g, key in ref.galois_keys.items():
            self._host_keys[f"galois_{g}"] = key
        self._perm_dev: Dict = {}
        self._op_cache: OrderedDict = OrderedDict()
        self._dec_cache: OrderedDict = OrderedDict()
        self._behz = None

    # ------------------------------------------------------------- host half
    def encode(self, values: Sequence[int]) -> Plaintext:
        return self.ref.encode(values)

    def decode(self, pt: Plaintext, signed: bool = True) -> List[int]:
        return self.ref.decode(pt, signed)

    def encrypt(self, pt: Plaintext) -> BfvCiphertext:
        return self.encrypt_many([pt])[0]

    def encrypt_many(self, pts: Sequence[Plaintext]) -> List[BfvCiphertext]:
        """Encrypt on the host (the reference's draw order per ciphertext:
        u, e0, e1) and move the ciphertexts to the device."""
        return [BfvCiphertext(as_residues(ct.data, self.device))
                for ct in self.ref.encrypt_many(pts)]

    def to_reference(self, ct: BfvCiphertext) -> BfvCiphertext:
        """The host (np64) form of a device ciphertext."""
        return BfvCiphertext(to_host(ct.data))

    def decrypt(self, ct: BfvCiphertext) -> Plaintext:
        return self.ref.decrypt(self.to_reference(ct))

    def noise_budget(self, ct: BfvCiphertext) -> int:
        return self.ref.noise_budget(self.to_reference(ct))

    # ------------------------------------------------------------------ keys
    def _get_key(self, key_id: str) -> Tuple:
        """Host switching key for "relin" / "galois_<g>", built once by the
        reference's host key path (same seed → same key)."""
        key = self._host_keys.get(key_id)
        if key is None:
            key = self.ref._build_keys_batch([key_id])[key_id]
            self._host_keys[key_id] = key
        return key

    def get_relin_key(self) -> Tuple:
        return self._get_key("relin")

    def get_galois_key(self, galois_elt: int) -> Tuple:
        return self._get_key(f"galois_{galois_elt}")

    def _ksk_device(self, ksk) -> Tuple:
        """Device copies of a host switching key, cached by identity (ids
        recycle, so a hit is verified with `is`)."""
        ksk_b, ksk_a = ksk
        hit = self._ksk_dev_cache.get(id(ksk_b))
        if hit is not None and hit[0] is ksk_b:
            return hit[1]
        dev = (as_residues(ksk_b, self.device),
               as_residues(ksk_a, self.device))
        self._ksk_dev_cache[id(ksk_b)] = (ksk_b, dev)
        return dev

    # --------------------------------------------------------- homomorphic ops
    def _get_behz(self) -> BehzContext:
        if self._behz is None:
            ref_behz = RefBehzContext(self.params, ntt_q=self.ref.ntt_q)
            self._behz = BehzContext(ref_behz, self.ntt_q)
        return self._behz

    def add(self, a: BfvCiphertext, b: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(t64.add(a.data, b.data, self.q_q))

    def sub(self, a: BfvCiphertext, b: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(t64.sub(a.data, b.data, self.q_q))

    def negate(self, a: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(t64.neg(a.data, self.q_q))

    def _plain_m(self, pt: Plaintext) -> torch.Tensor:
        """Plaintext coefficients broadcast over the L limbs, [L, n] (they
        are below t, hence below every q_j)."""
        m = torch.from_numpy(pt.coeffs.astype(np.int32)).to(self.device)
        return m.expand(self.params.L, -1)

    def _plain_dm(self, pt: Plaintext) -> torch.Tensor:
        """Δ·m in RNS on the device, [L, n]."""
        return t64.mul(self._plain_m(pt), self._tab["delta_mod_q"], self.q_q)

    def add_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        c0 = t64.add(a.data[0], self._plain_dm(pt), self.q_q)
        return BfvCiphertext(_set0(a.data, c0))

    def sub_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        c0 = t64.sub(a.data[0], self._plain_dm(pt), self.q_q)
        return BfvCiphertext(_set0(a.data, c0))

    def sub_from_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        """Δ·m − ct (plain minus ciphertext, non-commutative case)."""
        neg = t64.neg(a.data, self.q_q)
        c0 = t64.add(neg[0], self._plain_dm(pt), self.q_q)
        return BfvCiphertext(_set0(neg, c0))

    def multiply_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        m_ntt = self.ntt_q.fwd(self._plain_m(pt))
        prod = t64.mul(self.ntt_q.fwd(a.data), m_ntt, self.q_q)
        return BfvCiphertext(self.ntt_q.inv(prod))

    def multiply(self, a: BfvCiphertext, b: BfvCiphertext,
                 relinearize: bool = True) -> BfvCiphertext:
        """ct·ct multiply via BEHZ, then (optionally) relinearization."""
        if a.size != 2 or b.size != 2:
            raise RuntimeExecutionError("multiply expects size-2 ciphertexts")
        self.counters["mult"] += 1
        a_pre = self._operand_cached(a.data)
        b_pre = a_pre if b.data is a.data else self._operand_cached(b.data)
        ct3 = BfvCiphertext(self._get_behz().multiply(a_pre, b_pre))
        return self.relinearize(ct3) if relinearize else ct3

    def _operand_cached(self, ct_data):
        """Operand NTT forms (over q and Bsk) with an identity-keyed cache:
        a ciphertext multiplied repeatedly is lifted and transformed once."""
        behz = self._get_behz()
        return self._cached(self._op_cache, ct_data, "op_ntt",
                            lambda: behz.precompute_operand(ct_data))

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

    def relinearize(self, ct: BfvCiphertext) -> BfvCiphertext:
        """Size-3 → size-2 via key switching of the s² component."""
        if ct.size == 2:
            return ct
        if ct.size != 3:
            raise RuntimeExecutionError(f"cannot relinearize size-{ct.size}")
        self.counters["relin"] += 1
        k0, k1 = self._key_switch(ct.data[2], self.get_relin_key())
        c0 = t64.add(ct.data[0], k0, self.q_q)
        c1 = t64.add(ct.data[1], k1, self.q_q)
        return BfvCiphertext(torch.stack([c0, c1]))

    # ----------------------------------------------------------- key switching
    def _decompose_ntt(self, d):
        """RNS-decompose d ([L, n] coeff domain over q) into α hybrid digits
        lifted to the full base q∪P in NTT domain: D [α, L+k, n]."""
        L, full, n = self.params.L, self.full, self.params.n
        k, alpha = self.params.ks_digits, self.params.num_ks_digits
        q_full = self._tab["q_full"].reshape(1, full, 1)
        if k == 1:
            # single-limb digits: the lift is a conditional subtract
            # (uniform 30-bit primes)
            lifted = d[:, None, :].expand(L, full, n)
            return self.ntt_qp.fwd(
                torch.where(lifted >= q_full, lifted - q_full, lifted))
        # k ≥ 2: fast base conversion of each digit [d]_{Q_j} to q∪P
        T = self._tab
        y_src = d[self._dec_gather].reshape(alpha, k, n)
        y = t64.mul(y_src, T["dec_inv_qhat"], T["dec_q_src"])
        D = None
        for i in range(k):
            term = t64.mul(y[:, i:i + 1, :], T["dec_qhat_full"][:, i], q_full)
            D = term if D is None else t64.add(D, term, q_full)
        return self.ntt_qp.fwd(D)

    def _ks_inner(self, D, ksk_b, ksk_a) -> Tuple:
        """Inner product of a decomposition D with a switching key, then
        mod-switch down: the cheap half of a key switch."""
        q_full = self._tab["q_full"]
        q3 = q_full.reshape(1, self.full, 1)
        acc_b = t64.sum_mod(t64.mul(D, ksk_b, q3), q_full)
        acc_a = t64.sum_mod(t64.mul(D, ksk_a, q3), q_full)
        acc = self.ntt_qp.inv(torch.stack([acc_b, acc_a]))
        return self._mod_switch_down(acc[0]), self._mod_switch_down(acc[1])

    def _key_switch(self, d, ksk) -> Tuple:
        """d: [L, n] coeff-domain poly over q → (k0, k1) over q with
        k0 + k1·s ≈ d·s2 (both coeff domain)."""
        ksk_b, ksk_a = self._ksk_device(ksk)
        return self._ks_inner(self._decompose_ntt(d), ksk_b, ksk_a)

    def _mod_switch_down(self, x):
        """[L+k, n] over q∪P → [L, n] over q: k successive exact centered
        divisions (x − centered([x]_{p_s}))·p_s^{-1}, last special first."""
        L, k = self.params.L, self.params.ks_digits
        for s in reversed(range(k)):
            rest = L + s
            x_rest, x_p = x[:rest], x[rest]
            qv = self._tab["q_full"][:rest]
            x_p_red = torch.where(x_p >= qv, x_p - qv, x_p)
            corr = torch.where(x_p > self._msd_half[s],
                               t64.sub(x_p_red, self._tab[f"msd_p_mod_{s}"],
                                       qv),
                               x_p_red)
            diff = t64.sub(x_rest, corr, qv)
            x = t64.mul(diff, self._tab[f"msd_p_inv_{s}"], qv)
        return x

    # --------------------------------------------------------------- rotations
    def _galois_perm(self, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coefficient-domain gather indices + keep-sign mask for x → x^g,
        on the device (host tables from the reference, cached per g)."""
        if g not in self._perm_dev:
            gather, sign_pos = self.ref._galois_perm(g)
            self._perm_dev[g] = (torch.from_numpy(gather).to(self.device),
                                 torch.from_numpy(sign_pos).to(self.device))
        return self._perm_dev[g]

    def _galois_perm_eval(self, g: int) -> torch.Tensor:
        """Evaluation-domain gather indices for x → x^g (a pure
        permutation), on the device, cached per g."""
        key = ("eval", g)
        if key not in self._perm_dev:
            self._perm_dev[key] = torch.from_numpy(
                self.ref._galois_perm_eval(g)).to(self.device)
        return self._perm_dev[key]

    def _decompose_cached(self, ct_data):
        """Key-switch decomposition of ct_data[1] with an identity-keyed
        cache: rotations of the same ciphertext share the α·(L+k) forward
        NTT rows."""
        return self._cached(self._dec_cache, ct_data, "decomp",
                            lambda: self._decompose_ntt(ct_data[1]))

    def _rotate_with(self, ct: BfvCiphertext, D, g: int) -> BfvCiphertext:
        """Galois automorphism g of ct given c1's decomposition D: permute D
        in the NTT domain, key-switch, and apply the signed coefficient
        gather to c0."""
        ksk_b, ksk_a = self._ksk_device(self.get_galois_key(g))
        k0, k1 = self._ks_inner(D.index_select(-1, self._galois_perm_eval(g)),
                                ksk_b, ksk_a)
        gather, sign_pos = self._galois_perm(g)
        c0g = ct.data[0].index_select(-1, gather)
        c0g = torch.where(sign_pos, c0g, t64.neg(c0g, self.q_q))
        return BfvCiphertext(torch.stack([t64.add(c0g, k0, self.q_q), k1]))

    def apply_galois(self, ct: BfvCiphertext, g: int) -> BfvCiphertext:
        """Galois automorphism + key switch, in the hoisted formulation."""
        if ct.size != 2:
            raise RuntimeExecutionError("relinearize before applying Galois")
        self.counters["galois"] += 1
        return self._rotate_with(ct, self._decompose_cached(ct.data), g)

    def hoisted_rotations(self, ct: BfvCiphertext,
                          steps_list: Sequence[int]) -> List[BfvCiphertext]:
        """Rotate ONE ciphertext by MANY step counts, sharing the key-switch
        decomposition."""
        if ct.size != 2:
            raise RuntimeExecutionError("relinearize before rotating")
        n = self.params.n
        D = self._decompose_cached(ct.data)
        out = []
        for steps in steps_list:
            s = steps % (n // 2)
            if s == 0:
                out.append(BfvCiphertext(ct.data))
                continue
            self.counters["galois"] += 1
            out.append(self._rotate_with(ct, D, pow(3, s, 2 * n)))
        return out

    def rotate_rows(self, ct: BfvCiphertext, steps: int) -> BfvCiphertext:
        """Rotate each batching row by `steps` (positive = left)."""
        n = self.params.n
        steps = steps % (n // 2)
        if steps == 0:
            return ct
        return self.apply_galois(ct, pow(3, steps, 2 * n))

    def rotate_columns(self, ct: BfvCiphertext) -> BfvCiphertext:
        """Swap the two batching rows (galois element 2n−1)."""
        return self.apply_galois(ct, 2 * self.params.n - 1)


def _set0(data, c0):
    return torch.cat([c0[None], data[1:]], dim=0)
