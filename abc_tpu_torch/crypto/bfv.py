"""RNS-BFV on torch tensors (port of abc_tpu/crypto/bfv.py): keygen,
switching keys, batching encoder, encryption, decryption and the
homomorphic evaluation (add/sub/negate, plain ops, BEHZ ct·ct multiply,
relinearization, hybrid key switching for k = 1 and k ≥ 2, Galois rotations
with hoisting).

Everything key- or ciphertext-sized is computed on the context's device
through the port's kernels (ops/*_kernels.py: CUDA kernels on the card,
their plain torch versions on the CPU), the NTT's and those of keys,
encryption and decryption (ops/rlwe_kernels.py) among them: only n-sized
samples cross from the host. The scalar tables are host bigint
precomputation, as in the reference.

Keys are the shared part of the two RLWE schemes (crypto/rlwe.py: the
randomness design, keygen, the hybrid switching-key composition with digit
size k = params.ks_digits, the Galois tables), so that a context built from
the same seed holds the same words (keys, ciphertexts, results) as an
abc_tpu np64 or jx32 context.

Whole-program capture (runtime/jit_executor.py) records the evaluation into a
CUDA graph, which holds device pointers. Three things follow here:

* keys are not arguments of the captured program: the graph reads the key
  tensors this context owns, so the reference's record_key_requests /
  set_key_overrides / _fake_ksk (keys as executable arguments under jax.jit)
  have no counterpart; nor have precompute_mult_operand and
  multiply(a_pre=, b_pre=), the hand-hoisting of an operand's transforms:
  _operand_cached hoists a reused operand and nothing in the port asks for
  more;
* whatever the evaluation builds lazily from host data (the BEHZ context, the
  Galois permutation tables, a switching key) is built by an eager run before
  the capture, since a host-to-device copy is illegal inside one;
  ensure_eval_ready builds what does not depend on the program;
* the identity-keyed caches (_op_cache, _dec_cache) must not carry an entry
  across the boundary of a capture: fresh_caches() empties them on the way in
  and on the way out.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from abc_tpu_torch.crypto.behz import BehzContext
from abc_tpu_torch.crypto.ntt import NttContext, _bit_reverse_vec
from abc_tpu_torch.crypto.numthy import modinv
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.crypto.rlwe import RlweKeys
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops import rlwe_kernels as rk
from abc_tpu_torch.ops.modarith import as_residues, in_chain, to_host
from abc_tpu_torch.utils.errors import RuntimeExecutionError
from abc_tpu_torch.utils.profiling import span

_SLOT_MAP_CACHE: Dict[int, np.ndarray] = {}


@dataclass
class Plaintext:
    """Batched plaintext: polynomial coefficients mod t, an [n] int32 tensor
    on the context's device. `scalar` is c where every one of the n slots
    holds the residue c (set by `encode`, from the host values): the
    polynomial is then the constant c, and a product by it needs no
    transform (`multiply_plain`)."""
    coeffs: torch.Tensor
    scalar: Optional[int] = None


@dataclass
class BfvCiphertext:
    """data: [k, L, n] int32 tensor, coefficient domain, k = 2 (or 3
    before relinearization). The evaluation half (add/sub/negate, the plain
    ops, multiply, relinearize, the rotations) also takes a batch of
    independent ciphertexts [..., k, L, n] and gives, row for row, the words
    of separate calls; encrypt and decrypt take one ciphertext."""
    data: torch.Tensor

    @property
    def size(self) -> int:
        return self.data.shape[-3]


class BfvContext(RlweKeys):
    """Keys + precomputed tables for one BFV parameter set on one device."""

    def __init__(self, params: BfvParams, device,
                 state: Optional[Mapping] = None):
        """Generates keys from params.seed (or OS entropy). With `state`
        (see convert.context_from_reference) the context holds the given
        keys and generator state instead and draws nothing."""
        self.params = params
        self.device = dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is available")
        self.counters: Dict[str, int] = {
            "relin": 0, "galois": 0, "decomp": 0, "decomp_hit": 0,
            "mult": 0, "op_ntt": 0, "op_ntt_hit": 0,
            "plain_scalar": 0, "plain_product": 0}
        n, moduli = params.n, params.coeff_modulus
        if len({q.bit_length() for q in moduli}) != 1:
            raise ValueError("uniform coeff-prime sizes required "
                             "(single-subtract limb lifting)")
        L, k = params.L, params.ks_digits
        self.full = L + k                      # size of the extended base q∪P
        self.ntt_q = NttContext(n, params.data_primes, dev)
        self.ntt_qp = NttContext(n, moduli, dev)
        self.ntt_t = NttContext(n, [params.plain_modulus], dev)

        host = self._scalar_tables()
        self._tab = {name: as_residues(v, dev) for name, v in host.items()}
        self.q_q = self._tab["q_full"][:L]                 # [L, 1]
        # the key switch's tables (ops/keyswitch_kernels.py): the k >= 2
        # digit lift's fast base conversion, and the mod switch down, the
        # division by the k special primes (last first)
        self._digits = None if k == 1 else kk.Digits(
            params.data_primes, params.digit_groups, moduli, k, dev)
        self._division = kk.Division(moduli, k, dev)
        # encryption's Δ mod q_j with its Shoup companions, and the
        # decryption's scale-and-round (ops/rlwe_kernels.py)
        self._delta = rk.shoup_pairs(host["delta_mod_q"], params.data_primes,
                                     dev)
        self._dec_round = rk.DecRound(params.data_primes,
                                      params.plain_modulus, dev)
        self._slot_to_pos = torch.from_numpy(_build_slot_map(n)).to(dev)
        self._op_cache: OrderedDict = OrderedDict()
        self._dec_cache: OrderedDict = OrderedDict()
        self._behz = None
        self._init_keys(state)

    # ---------------------------------------------------------------- tables
    def _scalar_tables(self) -> Dict[str, np.ndarray]:
        """Host bigints → uint32 tables, the reference's words."""
        params = self.params
        moduli, qs = params.coeff_modulus, params.data_primes
        P, q_big, t = params.special_prime, params.q, params.plain_modulus
        alpha = params.num_ks_digits
        host: Dict[str, np.ndarray] = {}

        def col(values):
            return np.asarray(values, dtype=np.uint64).astype(
                np.uint32).reshape(-1, 1)

        host["q_full"] = col(moduli)
        host["delta_mod_q"] = col([(q_big // t) % q for q in qs])
        # P·W_j mod every modulus for the ksk construction (module note)
        factors = np.zeros((alpha, self.full, 1), dtype=np.uint32)
        for j, grp in enumerate(params.digit_groups):
            Qj = 1
            for i in grp:
                Qj *= qs[i]
            qhat = q_big // Qj
            w = qhat * modinv(qhat % Qj, Qj)          # ≡ δ_{jm} (mod Q_m)
            for r, qr in enumerate(moduli):
                factors[j, r, 0] = (P * w) % qr
        host["ks_factors"] = factors
        return host

    # -------------------------------------------------------------- encoding
    def encode(self, values: Sequence[int]) -> Plaintext:
        """Batch-encode up to n integers into slots (zero-padded here;
        last-element padding is applied by the runtime factory layer). The
        plaintext is marked `scalar` where every slot holds one residue:
        n values of one residue, or none but zeros."""
        n, t = self.params.n, self.params.plain_modulus
        if len(values) > n:
            raise RuntimeExecutionError(
                f"too many values to encode: {len(values)}")
        res = [int(v) % t for v in values]
        slots = torch.zeros(n, dtype=torch.int32, device=self.device)
        if res:
            vals = torch.tensor(res, dtype=torch.int32, device=self.device)
            slots[self._slot_to_pos[:len(res)]] = vals
        return Plaintext(self.ntt_t.inv(slots.reshape(1, n))[0],
                         _constant_residue(res, n))

    def decode(self, pt: Plaintext, signed: bool = True) -> List[int]:
        n, t = self.params.n, self.params.plain_modulus
        slots_eval = self.ntt_t.fwd(pt.coeffs.reshape(1, n))[0]
        out = slots_eval[self._slot_to_pos].to(torch.int64)
        if signed:
            out = torch.where(out > t // 2, out - t, out)
        return out.tolist()

    # --------------------------------------------------------------- encrypt
    def encrypt(self, pt: Plaintext) -> BfvCiphertext:
        return self.encrypt_many([pt])[0]

    def encrypt_many(self, pts: Sequence[Plaintext]) -> List[BfvCiphertext]:
        """Encrypt a batch in one pass on the device: u lifted (rlwe_lift)
        and transformed, u·pk as one contraction of one digit with the
        public key's two halves (ks_contract), one inverse NTT of [B, 2, L,
        n], then c0 = ci0 + e0 + Δ·m and c1 = ci1 + e1 in one rlwe_lift.
        The generator is drawn per ciphertext in the order u, e0, e1 (the
        span `draws`; the rest is the span `device_pass`)."""
        if not pts:
            return []
        with span("draws", rows=len(pts)):
            samples = [(self._sample_ternary(), self._sample_error(),
                        self._sample_error()) for _ in pts]
        with span("device_pass"):
            u = self._lift_signed(np.stack([s[0] for s in samples]),
                                  self.q_q)
            e = self._small(np.stack([s[1:] for s in samples]))  # [B, 2, n]
            u_ntt = self.ntt_q.fwd(u)                            # [B, L, n]
            pre = kk.contract(u_ntt[:, None], self.pk_b_ntt[None],
                              self.pk_a_ntt[None], self.q_q,
                              self.ntt_q.ratio)
            ci = self.ntt_q.inv(pre)                         # [B, 2, L, n]
            m = torch.stack([pt.coeffs for pt in pts])           # [B, n]
            data = rk.rlwe_lift(e, self.q_q, base=ci, msg=m,
                                delta=self._delta)
        return [BfvCiphertext(data[i]) for i in range(len(pts))]

    # --------------------------------------------------------------- decrypt
    def _dot_secret(self, ct: BfvCiphertext) -> torch.Tensor:
        """v = Σ_k c_k·s^k mod q, [L, n] coefficient-domain residues
        (size-3 ciphertexts before relinearization included): one
        contraction of the components' transforms with the rows [1, s,
        s²] (ks_contract, one half)."""
        if ct.size not in (2, 3):
            raise RuntimeExecutionError(f"cannot decrypt size-{ct.size}")
        L = self.params.L
        c_ntt = self.ntt_q.fwd(ct.data)
        acc = kk.contract(c_ntt[None], self._secret_powers(L, ct.size), None,
                          self.q_q, self.ntt_q.ratio)
        return self.ntt_q.inv(acc[0, 0])

    def decrypt(self, ct: BfvCiphertext) -> Plaintext:
        """Dot product with the secret and exact fixed-point CRT
        scale-and-round on the device (bfv_dec_round): the fractional parts
        of y_l·θ_l are summed exactly in 2^-32 units. A coefficient within
        4096·2^-32 of the rounding boundary (noise at capacity) sets the
        kernel's flag and sends the whole ciphertext to the exact bigint
        path."""
        v = self._dot_secret(ct)
        m, flag = rk.bfv_dec_round(v, self._dec_round)
        if flag.cpu().any():
            return self._decrypt_exact(to_host(v))[0]
        return Plaintext(m)

    def _crt_compose_host(self, v: np.ndarray) -> np.ndarray:
        """[L, n] residues → object array of exact bigints in [0, q)."""
        q_big = self.params.q
        acc = np.zeros(self.params.n, dtype=object)
        for l, ql in enumerate(self.params.data_primes):
            qhat = q_big // ql
            c = qhat * modinv(qhat % ql, ql)
            acc = (acc + v[l].astype(object) * c) % q_big
        return acc

    def _decrypt_exact(self, v: np.ndarray) -> Tuple[Plaintext, int]:
        """(plaintext, invariant-noise budget in bits) from v = [c(s)]_q on
        the host, with exact bigints."""
        q_big, t = self.params.q, self.params.plain_modulus
        big = self._crt_compose_host(v)
        coeffs = np.zeros(self.params.n, dtype=np.uint32)
        max_resid = 0
        for j in range(self.params.n):
            m_j, resid = divmod(int(big[j]) * t, q_big)
            if resid > q_big // 2:
                m_j += 1
                resid -= q_big
            coeffs[j] = m_j % t
            max_resid = max(max_resid, abs(resid))
        if max_resid == 0:
            budget = q_big.bit_length()
        else:
            budget = max(0, q_big.bit_length() - 1 - max_resid.bit_length())
        return Plaintext(as_residues(coeffs, self.device)), budget

    def noise_budget(self, ct: BfvCiphertext) -> int:
        """Invariant-noise budget in bits (exact)."""
        return self._decrypt_exact(to_host(self._dot_secret(ct)))[1]

    # --------------------------------------------------------- homomorphic ops
    def _get_behz(self) -> BehzContext:
        if self._behz is None:
            self._behz = BehzContext(self.params, self.ntt_q)
        return self._behz

    def ensure_eval_ready(self) -> None:
        """Build everything the evaluation path needs that does not depend on
        the program, outside any timed phase or graph capture: the BEHZ
        multiply context (its auxiliary primes and twiddle tables; the three
        NTT contexts of this context got theirs in the constructor) and, on
        a CUDA device, the kernel library (nvcc build at first use, then the
        load). A failed build raises."""
        self._get_behz()
        if self.device.type == "cuda":
            from abc_tpu_torch.ops import _build
            _build.load()

    @contextmanager
    def fresh_caches(self):
        """Run a block with the identity-keyed caches (operand NTT forms,
        key-switch decompositions) empty at its start and emptied again at
        its end. A whole-program run is such a block: its input tensors keep
        their identity from run to run while their contents change, so an
        entry made by one run would hand the next one the transforms of old
        data; and entries made while a CUDA graph is captured point into the
        graph's memory pool, which no eager code may read."""
        self._op_cache.clear()
        self._dec_cache.clear()
        try:
            yield
        finally:
            self._op_cache.clear()
            self._dec_cache.clear()

    # The ciphertext and plaintext arithmetic is one launch of the RNS
    # elementwise kernel each on the card (ops/elementwise_kernels.py), its
    # plain t64 chain on the CPU.
    def add(self, a: BfvCiphertext, b: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(ew.add(a.data, b.data, self.q_q,
                                    self.ntt_q.ratio))

    def sub(self, a: BfvCiphertext, b: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(ew.sub(a.data, b.data, self.q_q,
                                    self.ntt_q.ratio))

    def negate(self, a: BfvCiphertext) -> BfvCiphertext:
        return BfvCiphertext(ew.neg(a.data, self.q_q))

    def _plain_m(self, pt: Plaintext) -> torch.Tensor:
        """Plaintext coefficients broadcast over the L limbs, [L, n] (they
        are below t, hence below every q_j)."""
        return pt.coeffs.expand(self.params.L, -1)

    def add_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        """c0 + Δ·m (Δ mod q_j times the plaintext's coefficients)."""
        return BfvCiphertext(ew.add(a.data, self._plain_m(pt), self.q_q,
                                    self.ntt_q.ratio,
                                    w=self._tab["delta_mod_q"], first=True))

    def sub_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        return BfvCiphertext(ew.sub(a.data, self._plain_m(pt), self.q_q,
                                    self.ntt_q.ratio,
                                    w=self._tab["delta_mod_q"], first=True))

    def sub_from_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        """Δ·m − ct (plain minus ciphertext, non-commutative case): −ct with
        Δ·m added to c0."""
        return BfvCiphertext(ew.neg(a.data, self.q_q, self.ntt_q.ratio,
                                    b=self._plain_m(pt),
                                    w=self._tab["delta_mod_q"]))

    def multiply_plain(self, a: BfvCiphertext, pt: Plaintext) -> BfvCiphertext:
        """a·m. By a scalar plaintext (its polynomial the constant c < t <
        q_j, held in coeffs[0]) one product of every word by c, the [1]
        view read as a column; otherwise a product of the transforms. The
        words are the same either way (the negacyclic product is exact)."""
        if pt.scalar is not None:
            self.counters["plain_scalar"] += 1
            return BfvCiphertext(ew.mul(a.data, pt.coeffs[:1], self.q_q,
                                        self.ntt_q.ratio))
        self.counters["plain_product"] += 1
        m_ntt = self.ntt_q.fwd(self._plain_m(pt))
        prod = ew.mul(self.ntt_q.fwd(a.data), m_ntt, self.q_q,
                      self.ntt_q.ratio)
        return BfvCiphertext(self.ntt_q.inv(prod))

    def multiply(self, a: BfvCiphertext, b: BfvCiphertext,
                 relinearize: bool = True) -> BfvCiphertext:
        """ct·ct multiply via BEHZ, then (optionally) relinearization. The
        per-operand lift and transforms come from `_operand_cached`, so an
        operand reused across multiplies is transformed once."""
        if a.size != 2 or b.size != 2:
            raise RuntimeExecutionError("multiply expects size-2 ciphertexts")
        self.counters["mult"] += 1
        a_pre = self._operand_cached(a.data)
        b_pre = a_pre if b.data is a.data else self._operand_cached(b.data)
        ct3 = BfvCiphertext(self._get_behz().multiply(a_pre, b_pre))
        return self.relinearize(ct3) if relinearize else ct3

    def square(self, a: BfvCiphertext, relinearize: bool = True
               ) -> BfvCiphertext:
        """a·a with one operand transform (the factory lowers `x *** x` to
        this)."""
        return self.multiply(a, a, relinearize=relinearize)

    def _operand_cached(self, ct_data):
        """Operand NTT forms (over q and Bsk) with an identity-keyed cache:
        a ciphertext multiplied repeatedly is lifted and transformed once."""
        behz = self._get_behz()
        return self._cached(self._op_cache, ct_data, "op_ntt",
                            lambda: behz.precompute_operand(ct_data))

    def relinearize(self, ct: BfvCiphertext) -> BfvCiphertext:
        """Size-3 → size-2 via key switching of the s² component; the adds
        of c0 and c1 run in the mod switch down's launch (relin tail)."""
        if ct.size == 2:
            return ct
        if ct.size != 3:
            raise RuntimeExecutionError(f"cannot relinearize size-{ct.size}")
        self.counters["relin"] += 1
        d = ct.data
        return BfvCiphertext(self._key_switch(
            d[..., 2, :, :], self.get_relin_key(), kk.Tail("relin", d)))

    # ----------------------------------------------------------- key switching
    # --------------------------------------------- mesh (limb-sharded) mode
    #
    # With a "limb" axis set (runtime/jit_executor.py mesh mode,
    # parallel/sharding.py), the key-switch contraction Σ_i D_i ⊙ ksk_i is
    # sharded over that axis: each shard decomposes and transforms only its
    # α/limb digit rows against its rows of the switching key, and one
    # modular psum over the axis combines the [..., L+k, n] accumulators.
    # The shards are laid out as parallel/mesh.py says: under LocalComm a
    # shard axis in front of the digit rows, on a rank its own rows. It
    # applies to every key switch the context performs (relinearization,
    # rotations, hoisted rotations).

    _limb_axis: Optional[str] = None
    _limb_size: int = 1
    _limb_mesh = None

    def set_limb_sharding(self, axis_name: Optional[str], size: int = 1,
                          mesh=None) -> None:
        """Enable (axis_name, its size, the mesh that has it) or disable
        (None) limb-sharded key switching. Requires ks_digits == 1 (one digit
        per limb) and size | L."""
        if axis_name is not None:
            if self.params.ks_digits != 1:
                raise RuntimeExecutionError(
                    "limb-sharded execution implements the ks_digits=1 "
                    "layout; build the context with ks_digits=1")
            if self.params.L % size:
                raise RuntimeExecutionError(
                    f"limb mesh axis ({size}) must divide L "
                    f"({self.params.L})")
            if mesh is None or mesh.shape.get(axis_name) != size:
                raise RuntimeExecutionError(
                    f"limb sharding over {axis_name!r} of size {size} needs "
                    "the mesh that has that axis")
            from abc_tpu_torch.parallel.mesh import same_device
            if not same_device(mesh.device, self.device):
                raise RuntimeExecutionError(
                    f"the mesh's shards are on {mesh.device}, the context "
                    f"on {self.device}")
        self._limb_axis = axis_name
        self._limb_size = size if axis_name is not None else 1
        self._limb_mesh = mesh if axis_name is not None else None
        # a cached decomposition has the other mode's layout
        self._dec_cache.clear()

    def shard_keys(self, mesh, axis: str = "limb") -> None:
        """Keep only this rank's digit rows of every switching key held:
        the per-card memory saving of limb sharding for a DistComm rank
        (under LocalComm every shard's rows live in one process anyway).
        From here on the context key-switches only limb-sharded over
        `axis` of `mesh`; a key built later is whole, and cut at each key
        switch."""
        self._keys = {
            key_id: tuple(mesh.scatter(h, axis, dim=-3).clone() for h in ksk)
            for key_id, ksk in self._keys.items()}

    @contextmanager
    def limb_sharded(self, mesh, axis: str = "limb"):
        """A block in which every key switch is limb-sharded over `axis` of
        `mesh`."""
        self.set_limb_sharding(axis, mesh.shape[axis], mesh)
        try:
            yield
        finally:
            self.set_limb_sharding(None)

    # The key switch's three chains are the kernels of csrc/keyswitch.cu on
    # the card and their plain versions on the CPU (ops/keyswitch_kernels.py
    # routes by the tensor's device).
    def _lift_ntt(self, d):
        """k = 1 digits d ([..., Lk, n] coefficient domain) lifted to the
        full base q∪P by a conditional subtract (uniform 30-bit primes) and
        transformed: [..., Lk, L+k, n]."""
        ntt = self.ntt_qp
        return ntt.fwd(kk.decompose(d, ntt.q_col, ntt.ratio))

    @in_chain("decompose")
    def _decompose_ntt(self, d):
        """RNS-decompose d ([..., L, n] coeff domain over q) into α hybrid
        digits lifted to the full base q∪P in NTT domain: D [..., α, L+k,
        n]. Limb-sharded: this process's shards of the digit rows only."""
        if self._limb_axis is not None:
            # this process's rows, copied once: under LocalComm the shard
            # axis splits a batch's component at two strides, which the
            # kernel does not take
            d = self._limb_mesh.scatter(d, self._limb_axis,
                                        dim=-2).contiguous()
        # k = 1 (no digit tables): the lift of _lift_ntt; k ≥ 2: the fast
        # base conversion of each digit [d]_{Q_j} to q∪P
        ntt = self.ntt_qp
        return ntt.fwd(kk.decompose(d, ntt.q_col, ntt.ratio, self._digits))

    def _ks_partials(self, D, ksk_b, ksk_a, perm=None):
        """Σ_i D_i ⊙ ksk_i over the digit rows D and the key hold, both
        halves in one [..., 2, L+k, n] tensor; with `perm`, D's columns
        permuted first (a hoisted rotation). Limb-sharded, a shard's partial
        accumulators before the psum."""
        ntt = self.ntt_qp
        return kk.contract(D, ksk_b, ksk_a, ntt.q_col, ntt.ratio, perm)

    @in_chain("ks_inner")
    def _ks_inner(self, D, ksk_b, ksk_a, perm=None, tail=None):
        """Inner product of a decomposition D (its columns permuted by
        `perm`, if given) with a switching key, then mod-switch down: the
        cheap half of a key switch, (k0, k1); with a keyswitch_kernels.Tail,
        the finished ciphertext [..., 2, L, n] of a relinearization or a
        rotation instead. Limb-sharded, a whole key is cut to this
        process's digit rows (a key of shard_keys already holds only them)
        and the shards' partial contractions are combined by one modular
        psum each, before the tail."""
        mesh, axis = self._limb_mesh, self._limb_axis
        alpha = self.params.num_ks_digits
        if axis is None and ksk_b.shape[-3] != alpha:
            raise RuntimeExecutionError(
                "this context's switching keys hold one rank's limb rows "
                "(shard_keys): it key-switches only under that sharding")
        if axis is not None and ksk_b.shape[-3] == alpha:
            ksk_b = mesh.scatter(ksk_b, axis, dim=-3)
            ksk_a = mesh.scatter(ksk_a, axis, dim=-3)
        acc = self._ks_partials(D, ksk_b, ksk_a, perm)
        if axis is not None:
            # each half's psum writes its rows of the summed [..., 2, L+k,
            # n] (a LocalComm acc holds the shard axis in front of the
            # halves)
            q_full = self._tab["q_full"]
            summed = torch.empty(
                acc.shape[:-4] + acc.shape[-3:] if mesh.is_local else
                acc.shape, dtype=torch.int32, device=acc.device)
            for h in (0, 1):
                mesh.psum_mod(acc[..., h, :, :], q_full, axis,
                              out=summed[..., h, :, :],
                              ratio=self.ntt_qp.ratio)
            acc = summed
        out = self._mod_switch_down(self.ntt_qp.inv(acc), tail)
        return out if tail is not None else (out[..., 0, :, :],
                                             out[..., 1, :, :])

    def _key_switch(self, d, ksk, tail=None):
        """d: [..., L, n] coeff-domain poly over q → (k0, k1) over q with
        k0 + k1·s ≈ d·s2 (both coeff domain); with a tail, the ciphertext
        it finishes (_ks_inner)."""
        return self._ks_inner(self._decompose_ntt(d), *ksk, tail=tail)

    @in_chain("mod_switch_down")
    def _mod_switch_down(self, x, tail=None):
        """[..., L+k, n] over q∪P → [..., L, n] over q: k successive exact
        centered divisions (x − centered([x]_{p_s}))·p_s^{-1}, last special
        first; with a tail, in the same launch."""
        return kk.mod_down(x, self._division, tail)

    # --------------------------------------------------------------- rotations
    def _decompose_cached(self, ct_data):
        """Key-switch decomposition of ct_data[1] with an identity-keyed
        cache: rotations of the same ciphertext share the α·(L+k) forward
        NTT rows."""
        return self._cached(self._dec_cache, ct_data, "decomp",
                            lambda: self._decompose_ntt(
                                ct_data[..., 1, :, :]))

    def _rotate_with(self, ct: BfvCiphertext, D, g: int,
                     ksk: Optional[Tuple] = None) -> BfvCiphertext:
        """Galois automorphism g of ct given c1's decomposition D: permute D
        in the NTT domain, key-switch (with the context's key for g, or
        `ksk`), and add the signed coefficient gather of c0 to k0 in the
        mod switch down's launch (rotate tail)."""
        tail = kk.Tail("rotate", ct.data[..., 0, :, :], self._galois_inv(g))
        return BfvCiphertext(self._ks_inner(
            D, *(ksk or self.get_galois_key(g)),
            perm=self._galois_perm_eval(g), tail=tail))

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


def _build_slot_map(n: int) -> np.ndarray:
    """slot index → NTT-output position, per the SEAL-compatible 2×(n/2)
    matrix batching layout: slot (r, i) sits at evaluation point
    ψ^(±3^i mod 2n); forward-NTT position p evaluates at ψ^(2·brv(p)+1).
    A pure function of n, memoised."""
    if n in _SLOT_MAP_CACHE:
        return _SLOT_MAP_CACHE[n]
    m = 2 * n
    brv = _bit_reverse_vec(n, n.bit_length() - 1)
    pos = np.empty(n, dtype=np.int64)
    g = 1
    for i in range(n // 2):
        pos[i] = brv[(g - 1) // 2]                # row 0: exponent 3^i
        pos[n // 2 + i] = brv[(m - g - 1) // 2]   # row 1: exponent -3^i
        g = g * 3 % m
    _SLOT_MAP_CACHE[n] = pos
    return pos


def _constant_residue(res: Sequence[int], n: int) -> Optional[int]:
    """c where all n slots of an encoding of the residues `res` (slots past
    them zero) hold c, else None; stops at the first slot that differs."""
    c = res[0] if len(res) == n else 0
    for r in res:
        if r != c:
            return None
    return c
