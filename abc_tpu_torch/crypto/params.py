"""FHE parameter sets.

Replaces SEAL's EncryptionParameters/SEALContext (reference:
SealCiphertextFactory::setupSealContext, SealCiphertextFactory.cpp:72-100:
BFV, poly_modulus_degree = slot count, CoeffModulus::BFVDefault, 20-bit
batching plain modulus). The reference has no config system (SURVEY.md §5);
this Params dataclass is the explicit version.

Prime budget: all coefficient-modulus primes are < 2^30 so the TPU uint32
engine (ops/modarith.jx32) applies. Total coeff-modulus bits stay within the
HE-standard budget for each n (109/218/438 bits at n = 4096/8192/16384); the
LAST prime in coeff_modulus is the key-switching special prime and does not
carry ciphertext data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce
from typing import List, Optional

from abc_tpu_torch.crypto.numthy import gen_ntt_primes

# bit sizes per n: (data primes, special prime) — all 30-bit or smaller,
# chosen to fit the HE-standard 128-bit-security modulus budget
# Note: with a 20-bit plain modulus, one plaintext/ciphertext multiply grows
# the noise by ~t·n ≈ 2^30-2^33 (a DENSE plaintext, e.g. a slot mask; a
# slot-constant plaintext is a single small coefficient and costs far less),
# so ≥5 data limbs are needed for ct·ct multiply + masked-write depth. The
# n ≤ 4096 presets therefore trade the strict 128-bit-security modulus budget
# (109 bits at n=4096) for usability and carry no security claim —
# production sizes are 8192+.
# HE-standard (homomorphicencryption.org) max total coeff-modulus bits for
# 128-bit classical security per ring dimension n.
HE_STANDARD_BUDGET_BITS = {
    1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881,
}


def check_modulus_budget(n: int, coeff_modulus: List[int],
                         what: str = "parameter set") -> None:
    """Warn when the total coefficient-modulus bits exceed the HE-standard
    128-bit-security budget for ring dimension n. A warning, not an error:
    dev/test sizes (n ≤ 4096) intentionally trade security margin for
    usable multiplicative depth and carry no security claim."""
    import warnings
    total = sum(q.bit_length() for q in coeff_modulus)
    budget = HE_STANDARD_BUDGET_BITS.get(n)
    if budget is not None and total > budget:
        warnings.warn(
            f"{what}: total coeff-modulus {total} bits exceeds the "
            f"HE-standard 128-bit-security budget of {budget} bits at "
            f"n={n}; this parameter set carries NO security claim",
            stacklevel=3)


_DEFAULT_CHAIN = {
    1024: ([30] * 5, 30),      # dev/test size
    2048: ([30] * 5, 30),      # dev/test size
    4096: ([30] * 5, 30),      # dev-grade (180 bits > 109-bit 128-sec budget)
    8192: ([30] * 6, 30),      # 210 ≤ 218
    16384: ([30] * 13, 30),    # 420 ≤ 438
    32768: ([30] * 27, 30),    # 840 ≤ 881
}


@dataclass
class BfvParams:
    """Parameters for one BFV scheme instance."""

    n: int
    coeff_modulus: List[int]          # data primes + ks_digits special primes (last)
    plain_modulus: int                # t, prime ≡ 1 (mod 2n) for batching
    engine: str = "np64"              # modarith engine: np64 (CPU) | jx32 (TPU)
    seed: Optional[int] = None        # deterministic keygen/encryption for tests
    error_std: float = 3.2            # discrete gaussian σ (SEAL default)
    ks_digits: int = 1                # hybrid key-switch digit size k = number
                                      # of special primes; digits = ceil(L/k)

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
        return reduce(lambda a, b: a * b, self.special_primes, 1)

    @property
    def L(self) -> int:
        """Number of data limbs (excludes the special primes)."""
        return len(self.coeff_modulus) - self.ks_digits

    @property
    def num_ks_digits(self) -> int:
        """α = number of key-switch decomposition digits."""
        return -(-self.L // self.ks_digits)

    @property
    def digit_groups(self) -> List[List[int]]:
        """Data-prime index groups per key-switch digit (size ≤ k each)."""
        k = self.ks_digits
        return [list(range(j * k, min((j + 1) * k, self.L)))
                for j in range(self.num_ks_digits)]

    @property
    def q(self) -> int:
        """Product of the data primes (the ciphertext modulus)."""
        return reduce(lambda a, b: a * b, self.data_primes, 1)

    @property
    def qp(self) -> int:
        return self.q * self.special_prime

    @property
    def slot_count(self) -> int:
        return self.n

    @staticmethod
    def create(n: int, engine: str = "np64", plain_bits: int = 20,
               seed: Optional[int] = None, ks_digits: int = 1) -> "BfvParams":
        """BFVDefault-style preset (ref: SealCiphertextFactory.cpp:72-100).

        ks_digits=k > 1 selects hybrid key switching with digit size k
        (k special primes): the key-switch decomposition shrinks from
        L·(L+1) to ceil(L/k)·(L+k) NTT rows at the cost of k−1 extra
        30-bit moduli against the HE-standard budget (a warning is emitted
        if the total goes over)."""
        if n not in _DEFAULT_CHAIN:
            raise ValueError(f"no default parameter chain for n={n}")
        sizes, special_bits = _DEFAULT_CHAIN[n]
        assert all(b == special_bits for b in sizes), "presets use uniform primes"
        if ks_digits < 1 or ks_digits > len(sizes):
            raise ValueError(f"ks_digits must be in [1, L={len(sizes)}]")
        t = gen_ntt_primes(plain_bits, 1, n)[0]
        primes = gen_ntt_primes(special_bits, len(sizes) + ks_digits, n,
                                exclude=[t])
        if n >= 8192:   # dev presets (n ≤ 4096) are documented as insecure
            check_modulus_budget(
                n, primes, what=f"BfvParams(n={n}, ks_digits={ks_digits})")
        return BfvParams(n=n, coeff_modulus=primes, plain_modulus=t,
                         engine=engine, seed=seed, ks_digits=ks_digits)
