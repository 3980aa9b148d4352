"""RNS-CKKS on torch tensors (port of abc_tpu/crypto/ckks.py): approximate
arithmetic over real/complex slot vectors.

Leveled RNS ciphertexts [2, l, n] int32, NTT tensor products, hybrid key
switching with digit size k = ks_digits (the construction of crypto/bfv.py,
leveled: full-level keys over α = ⌈L/k⌉ digits stay valid at every level
because the partial digit's sub-product still recombines exactly, see the
factor-table comment in _scalar_tables), and EXACT RNS rescaling (drop the
last data prime by centered division; no floats on the evaluation path).

Encoding is the canonical embedding via FFT with the same slot→evaluation
ordering as the BFV batch encoder (exponents ±3^i mod 2n), so slot rotations
are the same automorphism machinery (x → x^(3^k)). Encode and decode are host
numpy with exact Python integers, as in the reference: a product-scale
plaintext exceeds int64, so only the [level, n] residues cross to the device.

Scale management is standard CKKS: the scale multiplies under ct·ct multiply
and divides by the dropped prime at rescale; decode uses the tracked scale.
Levels and scales are Python values: every branch of the level/scale
alignment is decided on the host, which for a captured program means while
it is captured.

Keys are the shared part of the two RLWE schemes (crypto/rlwe.py), so a
context built from the same seed holds the same words (keys, ciphertexts,
results) as an abc_tpu np64 or jx32 CkksContext.

What whole-program capture (runtime/jit_executor.py) asks of this context is
what it asks of BfvContext (see the module note there): keys are the
context's own tensors, not arguments; every leveled NTT view and every
per-level table is built by the constructor, the per-level slices of a key
and the integer-lift columns by the eager warm-up run (they are cached by
key id and level, by multiplier and level: values, not identities);
fresh_caches() empties the one identity-keyed cache (_dec_cache) around a
run. The reference's record_key_requests / set_key_overrides /
sync_device_keys have no counterpart for the same reason as in BFV.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.crypto.numthy import centered, gen_ntt_primes, modinv
from abc_tpu_torch.crypto.rlwe import RlweKeys
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops import rlwe_kernels as rk
from abc_tpu_torch.ops.behz_kernels import behz_tensor
from abc_tpu_torch.ops.modarith import (as_residues, chain_range, in_chain,
                                          to_host)
from abc_tpu_torch.utils.errors import RuntimeExecutionError


@dataclass
class CkksParams:
    n: int
    coeff_modulus: List[int]          # data primes + ks_digits special primes (last)
    scale: float = float(1 << 25)
    engine: str = "np64"              # the reference's field; the port does
                                      # not read it (the device goes to the
                                      # context)
    seed: Optional[int] = None
    error_std: float = 3.2
    ks_digits: int = 1                # hybrid key-switch digit size k = number
                                      # of special primes; digits = ceil(l/k)
                                      # at ciphertext level l (see BfvParams)

    def __post_init__(self):
        if not 1 <= self.ks_digits < len(self.coeff_modulus):
            raise ValueError(
                f"ks_digits={self.ks_digits} must satisfy 1 <= ks_digits < "
                f"len(coeff_modulus)={len(self.coeff_modulus)} (there must "
                f"be at least one data prime)")

    @property
    def data_primes(self) -> List[int]:
        return self.coeff_modulus[:self.L]

    @property
    def special_primes(self) -> List[int]:
        """The k key-switching special primes (trailing moduli)."""
        return self.coeff_modulus[self.L:]

    @property
    def special_prime(self) -> int:
        """P = product of the special primes (the key-switch scaling factor)."""
        out = 1
        for p in self.special_primes:
            out *= p
        return out

    @property
    def L(self) -> int:
        return len(self.coeff_modulus) - self.ks_digits

    @property
    def num_ks_digits(self) -> int:
        """α = number of key-switch digits at FULL level."""
        return -(-self.L // self.ks_digits)

    @property
    def digit_groups(self) -> List[List[int]]:
        """Data-prime index groups per key-switch digit (size ≤ k each)."""
        k = self.ks_digits
        return [list(range(j * k, min((j + 1) * k, self.L)))
                for j in range(self.num_ks_digits)]

    @property
    def slot_count(self) -> int:
        return self.n // 2

    @staticmethod
    def create(n: int, levels: int = 3, engine: str = "np64",
               seed: Optional[int] = None, scale_bits: int = 25,
               ks_digits: int = 1) -> "CkksParams":
        """Preset with 30-bit primes. Precision note: after a rescale the
        scale drops to 2^(2·scale_bits − 30), and rotation/relin noise is
        ~2^17 absolute (n·B_err): at the default scale_bits=25 a
        post-rescale ciphertext carries only ~2^20 scale, so rotations on
        it see ~10-15%% relative error. Workloads that rotate AFTER
        rescaling should use scale_bits≈29 so the scale is roughly
        prime-sized and stays put across rescales (the SEAL/Lattigo
        convention); the default keeps headroom for multiply-heavy,
        rotate-early circuits."""
        from abc_tpu_torch.crypto.params import check_modulus_budget
        if ks_digits < 1 or ks_digits > levels:
            raise ValueError(f"ks_digits must be in [1, levels={levels}]")
        primes = gen_ntt_primes(30, levels + ks_digits, n)
        # 30·(levels+ks_digits) total bits must fit the HE-standard budget
        # for n (same guard as the BFV presets, crypto/params.py); warns on
        # dev-grade over-budget sets instead of refusing them.
        check_modulus_budget(n, primes, what=f"CkksParams(n={n}, levels={levels})")
        return CkksParams(n=n, coeff_modulus=primes, scale=float(1 << scale_bits),
                          engine=engine, seed=seed, ks_digits=ks_digits)


@dataclass
class CkksCiphertext:
    data: torch.Tensor      # [k, level, n] int32, coefficient domain
    level: int              # number of active data limbs
    scale: float

    @property
    def size(self) -> int:
        return self.data.shape[0]


@dataclass
class CkksPlaintext:
    """coeffs_rns: [level, n] host uint32 residues of round(scale·m), as
    encode and decrypt make them and decode reads them."""
    coeffs_rns: np.ndarray
    level: int
    scale: float


class CkksContext(RlweKeys):
    """Keys + tables for one CKKS parameter set on one device."""

    def __init__(self, params: CkksParams, device,
                 state: Optional[Mapping] = None):
        """Generates keys from params.seed (or OS entropy). With `state`
        (see convert.ckks_context_from_reference) the context holds the
        given keys and generator state instead and draws nothing."""
        self.params = params
        self.device = dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is available")
        # operation counters (same schema as BfvContext.counters)
        self.counters: Dict[str, int] = {
            "relin": 0, "galois": 0, "decomp": 0, "decomp_hit": 0, "mult": 0}
        n, moduli = params.n, params.coeff_modulus
        if len({q.bit_length() for q in moduli}) != 1:
            raise ValueError("uniform coeff-prime sizes required "
                             "(single-subtract limb lifting)")
        L, k = params.L, params.ks_digits
        self.full = L + k                  # size of the full extended base q∪P
        self.ntt_qp = NttContext(n, moduli, dev)
        # Every leveled view, here and not at first use: a view made while a
        # CUDA graph is captured would gather its tables into the graph's
        # pool. `level` rows for the tensor products, `level + k` rows
        # (active data ∪ specials) for the key switch.
        self._ntt_level = {lv: self.ntt_qp.subset(range(lv))
                           for lv in range(1, L + 1)}
        self._ntt_cols = {lv: self.ntt_qp.subset(self._ks_cols(lv))
                          for lv in range(1, L + 1)}
        self.ntt_q = self._ntt_level[L]

        host = self._scalar_tables()
        self._tab = {name: as_residues(v, dev) for name, v in host.items()}
        self.q_q = self._tab["q_full"][:L]                 # [L, 1]
        self._level_tables()

        self._slot_exponents = np.empty(n // 2, dtype=np.int64)
        g = 1
        for i in range(n // 2):
            self._slot_exponents[i] = g
            g = g * 3 % (2 * n)

        self._dec_cache: OrderedDict = OrderedDict()
        self._ksk_dev_cache: Dict[Tuple[str, int], Tuple] = {}
        self._lift_cache: Dict[Tuple[int, int], torch.Tensor] = {}
        self._init_keys(state)

    # ---------------------------------------------------------------- tables
    def _scalar_tables(self) -> Dict[str, np.ndarray]:
        """Host bigints → uint32 tables over the full base, the reference's
        words (rows are absolute limb indices: data primes 0..L-1, specials
        L..L+k-1)."""
        params = self.params
        moduli, qs = params.coeff_modulus, params.data_primes
        P = params.special_prime
        host: Dict[str, np.ndarray] = {}
        host["q_full"] = np.asarray(moduli, dtype=np.uint32).reshape(-1, 1)

        # hybrid key-switch factors at FULL level: P·W_j mod every modulus,
        # W_j = Q̂_j·[Q̂_j^{-1}]_{Q_j} over the full data modulus Q (same
        # construction as BfvContext). The keys stay valid at every lower
        # level l because mod an ACTIVE prime q_r: W_j ≡ 1 if r ∈ digit j
        # (W_j ≡ 1 mod Q_j and q_r | Q_j regardless of which other digit
        # primes are dropped), W_j ≡ 0 otherwise — so the level-restricted
        # digit decomposition (digit products over active primes only)
        # recombines to d mod q^{(l)} exactly, Lattigo-style.
        alpha = params.num_ks_digits
        q_big = 1
        for q in qs:
            q_big *= q
        fac = np.zeros((alpha, self.full, 1), dtype=np.uint32)
        for j, grp in enumerate(params.digit_groups):
            Qj = 1
            for i in grp:
                Qj *= qs[i]
            qhat = q_big // Qj
            w = qhat * modinv(qhat % Qj, Qj)
            for r, qr in enumerate(moduli):
                fac[j, r, 0] = (P * w) % qr
        host["ks_factors"] = fac
        return host

    def _level_tables(self) -> None:
        """Per-level device tables, all built here: the q columns of the
        extended base at each level; the mod switch down (the division of
        active data ∪ specials by the k specials, last first) and the
        rescale (the division of the active data by the last of them); and
        for k ≥ 2 the digit fast-base-conversion tables (digit groups
        intersected with the active limbs; short or partial digits pad with
        inv_qhat = 0 rows, which contribute exactly 0; base = active ∪
        specials). ops/keyswitch_kernels.py: Division, Digits."""
        params, dev = self.params, self.device
        qs, k = params.data_primes, params.ks_digits
        self._q_cols: Dict[int, torch.Tensor] = {}
        self._msd: Dict[int, kk.Division] = {}
        self._rescale_div: Dict[int, kk.Division] = {}
        self._dec_tabs: Dict[int, kk.Digits] = {}
        for level in range(1, params.L + 1):
            cols = qs[:level] + params.special_primes
            self._q_cols[level] = self._ntt_cols[level].q_col   # [level+k, 1]
            self._msd[level] = kk.Division(cols, k, dev)
            if level > 1:
                self._rescale_div[level] = kk.Division(qs[:level], 1, dev)
            if k > 1:
                groups = [[i for i in grp if i < level]
                          for grp in params.digit_groups]
                self._dec_tabs[level] = kk.Digits(
                    qs, [g for g in groups if g], cols, k, dev)

    # -------------------------------------------------------------- encoding
    def _lift_host(self, coeffs, level: int) -> np.ndarray:
        """Signed host coefficients (exact Python integers for a plaintext)
        → [level, n] uint32 residues, on the host."""
        out = np.empty((level, self.params.n), dtype=np.uint32)
        for j, qj in enumerate(self.params.coeff_modulus[:level]):
            out[j] = np.mod(coeffs, qj).astype(np.uint32)
        return out

    def encode(self, values: Sequence[complex], level: Optional[int] = None,
               scale: Optional[float] = None) -> CkksPlaintext:
        """Canonical-embedding encode of ≤ n/2 complex (or real) values."""
        n = self.params.n
        level = level if level is not None else self.params.L
        scale = scale if scale is not None else self.params.scale
        half = n // 2
        if len(values) > half:
            raise RuntimeExecutionError(f"too many values: {len(values)} > {half}")
        z = np.zeros(half, dtype=np.complex128)
        z[:len(values)] = np.asarray(values, dtype=np.complex128)
        # full evaluation vector over exponents 2k+1: A[(e-1)/2] = value
        A = np.zeros(n, dtype=np.complex128)
        for i in range(half):
            e = self._slot_exponents[i]
            A[(e - 1) // 2] = z[i]
            A[(2 * n - e - 1) // 2] = np.conj(z[i])
        # A = n·ifft(m ⊙ ψ⁺)  ⇒  m = (fft(A)/n) ⊙ ψ⁻,  ψ± = e^{±iπj/n}
        psi = np.exp(-1j * np.pi * np.arange(n) / n)
        m = np.fft.fft(A) / n * psi
        m_real = np.real(m) * scale
        coeffs = np.rint(m_real).astype(object)
        return CkksPlaintext(self._lift_host(coeffs, level), level, scale)

    def decode(self, pt: CkksPlaintext) -> np.ndarray:
        """Decode to n/2 complex values (host, exact CRT + float)."""
        n = self.params.n
        half = n // 2
        qs = self.params.data_primes[:pt.level]
        q_big = 1
        for q in qs:
            q_big *= q
        acc = np.zeros(n, dtype=object)
        for l, ql in enumerate(qs):
            qhat = q_big // ql
            c = qhat * modinv(qhat % ql, ql)
            acc = (acc + pt.coeffs_rns[l].astype(object) * c) % q_big
        m = np.array([centered(int(v), q_big) for v in acc], dtype=np.float64)
        m /= pt.scale
        psi_plus = np.exp(1j * np.pi * np.arange(n) / n)
        A = np.fft.ifft(m * psi_plus) * n
        z = np.empty(half, dtype=np.complex128)
        for i in range(half):
            e = self._slot_exponents[i]
            z[i] = A[(e - 1) // 2]
        return z

    def _plain_dev(self, pt: CkksPlaintext, level: int) -> torch.Tensor:
        """The first `level` residue rows of a plaintext on the device."""
        return as_residues(pt.coeffs_rns[:level], self.device)

    # --------------------------------------------------------------- encrypt
    def encrypt(self, pt: CkksPlaintext) -> CkksCiphertext:
        """The generator is drawn in the order u, e0, e1: u lifted
        (rlwe_lift) and transformed, u·pk as one contraction of one digit
        with the public key's two halves (ks_contract), one inverse NTT,
        then c0 = ci0 + e0 + m and c1 = ci1 + e1 in one rlwe_lift."""
        L = self.params.L
        if pt.level != L:
            raise RuntimeExecutionError("encrypt expects a full-level plaintext")
        q = self.q_q
        u = self._sample_ternary()
        e0, e1 = self._sample_error(), self._sample_error()
        u_ntt = self.ntt_q.fwd(self._lift_signed(u, q))
        pre = kk.contract(u_ntt[None, None], self.pk_b_ntt[None],
                          self.pk_a_ntt[None], q, self.ntt_q.ratio)
        ci = self.ntt_q.inv(pre[0])                              # [2, L, n]
        data = rk.rlwe_lift(self._small(np.stack([e0, e1])), q, base=ci,
                            msg=self._plain_dev(pt, L))
        return CkksCiphertext(data, L, pt.scale)

    def decrypt(self, ct: CkksCiphertext) -> CkksPlaintext:
        """c₀ + c₁·s (+ c₂·s² …): one contraction of the components'
        transforms with the rows [1, s, s², ...] at the ciphertext's level
        (ks_contract, one half) and the inverse transform on the device;
        only the [level, n] coefficient residues cross to the host, where
        decode (exact CRT + float embedding) reads them."""
        level = ct.level
        ntt = self._ntt_at(level)
        f = ntt.fwd(ct.data)
        v = kk.contract(f[None], self._secret_powers(level, ct.size), None,
                        ntt.q_col, ntt.ratio)
        return CkksPlaintext(to_host(ntt.inv(v[0, 0])), level, ct.scale)

    # --------------------------------------------------------- homomorphic ops
    def _ntt_at(self, level: int) -> NttContext:
        return self._ntt_level[level]

    def _q_at(self, level: int) -> torch.Tensor:
        return self._tab["q_full"][:level]

    def ensure_eval_ready(self) -> None:
        """Build what the evaluation path needs that does not depend on the
        program, outside any timed phase or graph capture. The leveled views
        and tables are the constructor's; what is left is, on a CUDA device,
        the kernel library (nvcc build at first use, then the load). A
        failed build raises."""
        if self.device.type == "cuda":
            from abc_tpu_torch.ops import _build
            _build.load()

    @contextmanager
    def fresh_caches(self):
        """Run a block with the identity-keyed cache of key-switch
        decompositions empty at its start and emptied again at its end; see
        BfvContext.fresh_caches for why a whole-program run is such a
        block."""
        self._dec_cache.clear()
        try:
            yield
        finally:
            self._dec_cache.clear()

    def _forget_key_tables(self) -> None:
        """The identity-keyed cache and the per-level slices of the keys."""
        super()._forget_key_tables()
        self._ksk_dev_cache.clear()

    # The ciphertext arithmetic is one launch of the RNS elementwise kernel
    # each on the card (ops/elementwise_kernels.py), its plain t64 chain on
    # the CPU.
    def add(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        return CkksCiphertext(ew.add(a.data, b.data, self._q_at(a.level),
                                     self._ntt_at(a.level).ratio),
                              a.level, a.scale)

    def sub(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        return CkksCiphertext(ew.sub(a.data, b.data, self._q_at(a.level),
                                     self._ntt_at(a.level).ratio),
                              a.level, a.scale)

    def _align(self, a: CkksCiphertext, b: CkksCiphertext,
               match_scale: bool = True):
        """Level AND scale alignment for add/sub:

        1. A side carrying a raw-product scale (≥1.5× both the other side
           and the base scale) is rescaled down — never past the other
           side's scale (over-rescaling drives the scales further apart).
        2. A larger-scale side that sits at a HIGHER level than the other
           is bridged DOWN through one of the levels the alignment is
           about to drop anyway: ct · round(target·q_drop/scale) then
           rescale — so the common scale is the SMALLER one. Lifting the
           small side up instead can exceed the few limbs left at the
           common level: at one 30-bit limb a 2^28-lifted sum leaves <2
           bits of coefficient headroom, the DC coefficient wraps q0 and
           every slot shifts by q0/scale.
        3. Levels are aligned by exact modulus reduction (mod_drop_to).
        4. A remaining ≥1.5× ratio (scale drift from prime≠2^scale_bits
           accumulating per rescale) is closed by an exact integer lift of
           the smaller-scale side: ct·m with scale·m — message AND noise
           scale together, so relative precision is unchanged.
        5. Residual sub-10% drift is absorbed by relabeling to the common
           scale — the standard approximate-arithmetic resolution; beyond
           10% we raise rather than silently distort.

        Equal-scale pairs (in particular two lazy un-rescaled products —
        the deferred-rescale fast path) are untouched."""
        if match_scale and not (2 / 3 < a.scale / b.scale < 1.5):
            base = self.params.scale
            while a.scale >= 1.5 * max(b.scale, base) and a.level > 1:
                a = self.rescale(a)
            while b.scale >= 1.5 * max(a.scale, base) and b.level > 1:
                b = self.rescale(b)
        if match_scale:
            a, b = self._bridge_down(a, b)
            b, a = self._bridge_down(b, a)
        if a.level != b.level:
            target = min(a.level, b.level)
            a = self.mod_drop_to(a, target)
            b = self.mod_drop_to(b, target)
        if match_scale and a.scale != b.scale:
            r = a.scale / b.scale
            if r >= 1.5:
                b = self._scale_lift(b, round(r))
            elif r <= 2 / 3:
                a = self._scale_lift(a, round(1.0 / r))
            r = a.scale / b.scale
            if not (0.9 < r < 1.1):
                raise RuntimeExecutionError(
                    f"unresolvable scale mismatch: {a.scale} vs {b.scale} "
                    f"(ratio {r:.3g})")
            b = CkksCiphertext(b.data, b.level, a.scale)
        return a, b

    def _bridge_down(self, hi: CkksCiphertext, lo: CkksCiphertext):
        """_align step 2: when `hi` carries ≥1.5× `lo`'s scale AND a spare
        level that the coming level-alignment would drop regardless, lower
        hi's scale to ≈lo.scale by an exact integer multiply through that
        level: hi · round(lo.scale·q_drop/hi.scale), rescale. Returns the
        (possibly bridged) pair in the original order."""
        while (hi.scale >= 1.5 * lo.scale and hi.level > lo.level
               and hi.level > 1):
            q_drop = self.params.data_primes[hi.level - 1]
            m = round(lo.scale * q_drop / hi.scale)
            if m < 2:       # scales too far apart for one bridge level —
                break       # fall back to the step-4 lift
            hi = self.rescale(self._scale_lift(hi, m))
        return hi, lo

    def _scale_lift(self, ct: CkksCiphertext, m: int) -> CkksCiphertext:
        """Exact multiplication by the integer m ≥ 1: every RNS component
        times m mod q_j, scale·m. Message and noise both scale by m, so the
        ciphertext's relative precision is preserved — the cheap half of
        scale alignment (no level consumed). The column of m mod q_j is made
        on the host with exact integers and kept per (m, level): m follows
        from the scales, so a captured run finds what the warm-up made."""
        if m <= 1:
            return ct
        level = ct.level
        mv = self._lift_cache.get((m, level))
        if mv is None:
            mv = self._lift_cache[(m, level)] = as_residues(
                np.asarray([m % int(p) for p in
                            self.params.data_primes[:level]],
                           dtype=np.uint32).reshape(-1, 1), self.device)
        return CkksCiphertext(ew.mul(ct.data, mv, self._q_at(level),
                                     self._ntt_at(level).ratio), level,
                              ct.scale * m)

    def mod_drop_to(self, ct: CkksCiphertext, level: int) -> CkksCiphertext:
        """Drop limbs WITHOUT scaling (modulus reduction, exact)."""
        if level == ct.level:
            return ct
        if level > ct.level:
            raise RuntimeExecutionError("cannot raise a ciphertext's level")
        return CkksCiphertext(ct.data[:, :level], level, ct.scale)

    def multiply(self, a: CkksCiphertext, b: CkksCiphertext,
                 relinearize: bool = True, rescale: bool = True) -> CkksCiphertext:
        # multiplication composes scales; only levels need aligning
        a, b = self._align(a, b, match_scale=False)
        level = a.level
        ntt = self._ntt_at(level)
        self.counters["mult"] += 1
        fa, fb = ntt.fwd(a.data), ntt.fwd(b.data)
        with chain_range("tensor"):
            d, = behz_tensor((fa, fb, ntt.q_col, ntt.ratio))
        data = ntt.inv(d)
        ct = CkksCiphertext(data, level, a.scale * b.scale)
        if relinearize:
            ct = self.relinearize(ct)
        if rescale:
            ct = self.rescale(ct)
        return ct

    def multiply_plain(self, ct: CkksCiphertext,
                       pt: CkksPlaintext) -> CkksCiphertext:
        """ct × plaintext: pointwise NTT product of every component with the
        encoded coefficients — no relinearization needed (size preserved),
        scale composes. The plaintext half of the BSGS matvec
        (crypto/linalg.matvec_bsgs_ckks)."""
        level = min(ct.level, pt.level)
        ct = self.mod_drop_to(ct, level)
        ntt, q = self._ntt_at(level), self._q_at(level)
        m = self._plain_dev(pt, level)
        prod = ew.mul(ntt.fwd(ct.data), ntt.fwd(m), q, ntt.ratio)
        return CkksCiphertext(ntt.inv(prod), level, ct.scale * pt.scale)

    def relinearize(self, ct: CkksCiphertext) -> CkksCiphertext:
        """Size-3 → size-2; the adds of c0 and c1 run in the mod switch
        down's launch (relin tail)."""
        if ct.size == 2:
            return ct
        self.counters["relin"] += 1
        return CkksCiphertext(
            self._key_switch(ct.data[2], "relin", ct.level,
                             kk.Tail("relin", ct.data)), ct.level, ct.scale)

    @in_chain("rescale")
    def rescale(self, ct: CkksCiphertext) -> CkksCiphertext:
        """Exact RNS rescale: drop the last data limb and divide by its prime
        (centered), scale /= q_dropped."""
        level = ct.level
        if level <= 1:
            raise RuntimeExecutionError("no level left to rescale into")
        drop = level - 1
        q_drop = self.params.data_primes[drop]
        out = kk.mod_down(ct.data, self._rescale_div[level])
        return CkksCiphertext(out, drop, ct.scale / q_drop)

    # ----------------------------------------------------------- key switching
    def _ksk_device(self, key_id: str, level: int) -> Tuple:
        """Per-level slices of a switching key (the first α(level) digit
        rows, limb columns {0..level-1} ∪ specials), cached by (key id,
        level). At full level they are the key itself; below, one
        concatenation, made once."""
        ck = (key_id, level)
        hit = self._ksk_dev_cache.get(ck)
        if hit is not None:
            return hit
        L, k = self.params.L, self.params.ks_digits
        alpha = self._alpha_at(level)

        def cut(key):
            if level == L:
                return key
            return torch.cat([key[:alpha, :level], key[:alpha, L:L + k]],
                             dim=1)

        ksk_b, ksk_a = self.materialize_keys([key_id])[key_id]
        self._ksk_dev_cache[ck] = out = (cut(ksk_b), cut(ksk_a))
        return out

    def _ks_cols(self, level: int) -> List[int]:
        """Extended-base limb indices at `level`: active data ∪ all specials."""
        L, k = self.params.L, self.params.ks_digits
        return list(range(level)) + list(range(L, L + k))

    def _alpha_at(self, level: int) -> int:
        """Number of hybrid digits intersecting the active limbs."""
        return -(-level // self.params.ks_digits)

    @in_chain("decompose")
    def _decompose_ntt(self, d: torch.Tensor, level: int) -> torch.Tensor:
        """RNS-decompose d ([level, n]) into α(level) = ⌈level/k⌉ hybrid
        digits and lift each to base q^(level)∪P in NTT domain:
        [α, level+k, n]. The expensive half of a key switch —
        hoisted_rotations computes it once per ciphertext."""
        ntt = self._ntt_cols[level]
        return ntt.fwd(kk.decompose(d, ntt.q_col, ntt.ratio,
                                    self._dec_tabs.get(level)))

    @in_chain("ks_inner")
    def _ks_inner(self, D: torch.Tensor, ksk_b, ksk_a, level: int,
                  perm=None, tail=None):
        """Inner product of a decomposition D (its columns permuted by
        `perm`, if given) with a switching key's per-level slices, both
        halves in one tensor, one batched inverse NTT, then one mod switch
        down of both: (k0, k1), or with a keyswitch_kernels.Tail the
        ciphertext it finishes."""
        ntt = self._ntt_cols[level]
        acc = ntt.inv(kk.contract(D, ksk_b, ksk_a, ntt.q_col, ntt.ratio,
                                  perm))
        out = self._mod_switch_down(acc, level, tail)
        return out if tail is not None else (out[..., 0, :, :],
                                             out[..., 1, :, :])

    def _key_switch(self, d: torch.Tensor, key_id: str, level: int,
                    tail=None):
        """Hybrid key switch at `level`: α(level) digit rows, limbs
        {0..level-1} ∪ specials."""
        ksk_b, ksk_a = self._ksk_device(key_id, level)
        return self._ks_inner(self._decompose_ntt(d, level), ksk_b, ksk_a,
                              level, tail=tail)

    @in_chain("mod_switch_down")
    def _mod_switch_down(self, x: torch.Tensor, level: int,
                         tail=None) -> torch.Tensor:
        """[..., level+k, n] over q^(level)∪P → [..., level, n]: k
        successive exact centered divisions (x − centered([x]_{p_s}))·
        p_s^{-1}, last special first (rows ordered [active data...,
        specials...]); with a tail, in the same launch."""
        return kk.mod_down(x, self._msd[level], tail)

    # --------------------------------------------------------------- rotations
    def _decompose_cached(self, ct_data: torch.Tensor, level: int):
        """Key-switch decomposition of ct_data[1] with an identity-keyed
        cache: repeated rotations of the SAME ciphertext share the forward
        NTTs. The level is the tensor's own (its limb rows), so identity
        settles it."""
        return self._cached(self._dec_cache, ct_data, "decomp",
                            lambda: self._decompose_ntt(ct_data[1], level))

    def _rotate_with(self, ct: CkksCiphertext, D, g: int) -> CkksCiphertext:
        """Galois automorphism g of ct given c1's decomposition D: permute D
        in the NTT domain, key-switch, and add the signed coefficient gather
        of c0 to k0 in the mod switch down's launch (rotate tail)."""
        level = ct.level
        ksk_b, ksk_a = self._ksk_device(f"galois_{g}", level)
        tail = kk.Tail("rotate", ct.data[0], self._galois_inv(g))
        return CkksCiphertext(
            self._ks_inner(D, ksk_b, ksk_a, level,
                           perm=self._galois_perm_eval(g), tail=tail),
            level, ct.scale)

    def hoisted_rotations(self, ct: CkksCiphertext,
                          steps_list: Sequence[int]) -> List[CkksCiphertext]:
        """Rotate ONE ciphertext by MANY step counts sharing the key-switch
        decomposition (its forward NTTs run once); see
        BfvContext.hoisted_rotations."""
        n = self.params.n
        D = self._decompose_cached(ct.data, ct.level)
        out = []
        for steps in steps_list:
            s = steps % (n // 2)
            if s == 0:
                out.append(CkksCiphertext(ct.data, ct.level, ct.scale))
                continue
            self.counters["galois"] += 1
            # same slot generator as rotate()
            out.append(self._rotate_with(ct, D, pow(3, s, 2 * n)))
        return out

    def rotate(self, ct: CkksCiphertext, steps: int) -> CkksCiphertext:
        """Rotate the n/2 complex slots by `steps` (positive = left), in
        the HOISTED formulation: decompose the untouched c1 (cacheable
        across rotations of the same ciphertext), permute the decomposition
        in the NTT domain — mirrors BfvContext.apply_galois."""
        n = self.params.n
        steps = steps % (n // 2)
        if steps == 0:
            return ct
        self.counters["galois"] += 1
        D = self._decompose_cached(ct.data, ct.level)
        return self._rotate_with(ct, D, pow(3, steps, 2 * n))
