"""Host-side number theory (exact Python bigints): primality, NTT-friendly
prime generation, primitive roots, modular inverses, CRT.

Replaces the number-theoretic machinery inside Microsoft SEAL
(reference links against SEAL 3.6, CMakeLists.txt:211-217); nothing here is
performance-critical — all outputs become precomputed uint32 tables shipped
to the TPU kernels.
"""

from __future__ import annotations

from typing import List, Sequence


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(bits: int, count: int, n: int,
                   exclude: Sequence[int] = ()) -> List[int]:
    """Generate `count` distinct primes of `bits` bits with q ≡ 1 (mod 2n),
    descending from the top of the bit range (mirrors SEAL's
    CoeffModulus::Create)."""
    m = 2 * n
    found: List[int] = []
    # largest candidate of the requested size congruent to 1 mod 2n
    candidate = ((1 << bits) - 1) // m * m + 1
    excluded = set(exclude)
    while len(found) < count:
        if candidate < (1 << (bits - 1)):
            raise ValueError(f"not enough {bits}-bit NTT primes for n={n}")
        if candidate not in excluded and is_prime(candidate):
            found.append(candidate)
            excluded.add(candidate)
        candidate -= m
    return found


def modinv(a: int, m: int) -> int:
    return pow(a, -1, m)


def find_primitive_root(modulus: int) -> int:
    """Smallest primitive root of a prime modulus."""
    if modulus == 2:
        return 1
    factors = _factorize(modulus - 1)
    for g in range(2, modulus):
        if all(pow(g, (modulus - 1) // f, modulus) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root found for {modulus}")


_MINIMAL_ROOT_CACHE: dict = {}


def find_minimal_2nth_root(n: int, modulus: int) -> int:
    """A primitive 2n-th root of unity mod a prime q ≡ 1 (mod 2n).

    Chooses the SMALLEST such root so the table generation is deterministic
    across runs/hosts (checkpoint compatibility). Module-memoized and
    numpy-vectorized: the former per-call Python coset scan (n−1 big-int
    multiplies) cost ~1.6 ms × ~55 calls per n=16384 context build — the
    largest single item in the measured factory-ctor profile."""
    key = (n, modulus)
    hit = _MINIMAL_ROOT_CACHE.get(key)
    if hit is not None:
        return hit
    import numpy as np

    order = 2 * n
    if (modulus - 1) % order != 0:
        raise ValueError(f"modulus {modulus} does not support 2n-th roots, n={n}")
    g = find_primitive_root(modulus)
    root = pow(g, (modulus - 1) // order, modulus)
    # scan the coset root·(root²)^k for the minimal primitive 2n-th root.
    # uint64 is exact: products of 30-bit residues stay under 2^60.
    q = np.uint64(modulus)
    odd_step = pow(root, 2, modulus)
    powers = np.empty(n, dtype=np.uint64)
    powers[0] = 1
    filled = 1
    step = np.uint64(odd_step % modulus)
    while filled < n:                      # doubling fill of odd_step^k
        m = min(filled, n - filled)
        powers[filled:filled + m] = powers[:m] * step % q
        step = np.uint64(int(step) * pow(odd_step, filled, modulus) % modulus)
        filled += m
    best = int((powers * np.uint64(root) % q).min())
    assert pow(best, order, modulus) == 1 and pow(best, n, modulus) == modulus - 1
    _MINIMAL_ROOT_CACHE[key] = best
    return best


def _factorize(n: int) -> List[int]:
    factors = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return factors


def crt_compose(residues: Sequence[int], moduli: Sequence[int]) -> int:
    """CRT-reconstruct x in [0, Πq_i) from its residues."""
    q = 1
    for m in moduli:
        q *= m
    x = 0
    for r, m in zip(residues, moduli):
        qi_hat = q // m
        x = (x + r * qi_hat * modinv(qi_hat % m, m)) % q
    return x


def centered(x: int, modulus: int) -> int:
    """Map x mod m into the centered interval (-m/2, m/2]."""
    x %= modulus
    return x - modulus if x > modulus // 2 else x
