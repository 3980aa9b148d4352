"""Counter-based PRNG (Threefry-2x32) for key and encryption randomness
(port of abc_tpu/crypto/prng.py).

The uniform components of keys (the `a` polynomial of every RLWE sample)
are the bulk of key material: [α, L+k, n] words per switching key. They are
a pure function of (seed, stream label, counter), so the port generates
them on the context's device and nothing key-sized crosses from the host.
Streams are strings ("pk", "relin/d0", "galois_3/d2") compressed into the
two key words through SHA-256 and one Threefry block; a context's master
seed is split into a PUBLIC domain (the uniform streams) and a SECRET domain
(ternary secrets, Gaussian errors) by `split_domain`.

Two implementations of the same cipher, word for word:

* numpy, for scalars on the host: `derive_key`, `split_domain` and
  `seeded_rng` (a numpy Generator for the small secret draws);
* torch, for polynomials on any device: `threefry2x32`, `uniform_rns`.
  CPU torch has no add or shift on uint32, so 32-bit words are carried in
  int64 and masked with 0xFFFFFFFF after every add and shift, on both
  devices. In the reference this path is jitted array code, not a kernel,
  so plain torch is its counterpart.

The secret draws go through numpy's PCG64 (`seeded_rng`), which is not a
CSPRNG, and auto-generated master seeds carry 63 bits of OS entropy: the
contract is reproducibility against the reference, not hardening.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ host words

def _threefry2x32_np(k0, k1, c0, c1):
    """One Threefry-2x32 block per counter element on numpy uint32 (20
    rounds: 5 groups of 4, key injection after each group)."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    k0, k1 = np.uint32(k0), np.uint32(k1)
    with np.errstate(over="ignore"):       # u32 wraparound is the cipher
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
        x0 = c0.astype(np.uint32) + ks[0]
        x1 = c1.astype(np.uint32) + ks[1]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r)
                x1 = x1 ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def derive_key(seed: int, stream: str) -> Tuple[int, int]:
    """(k0, k1) words for a (seed, stream) pair: 128 bits of the label's
    SHA-256 compressed through one Threefry block keyed by the seed (two
    hash words as the counter, two XORed into the output)."""
    h0, h1, h2, h3 = struct.unpack(
        "<4I", hashlib.sha256(stream.encode()).digest()[:16])
    x0, x1 = _threefry2x32_np(seed & _M32, (seed >> 32) & _M32,
                              np.uint32(h0).reshape(()),
                              np.uint32(h1).reshape(()))
    return int(x0) ^ h2, int(x1) ^ h3


def random_bits_np(seed: int, stream: str, shape: Tuple[int, ...]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Two uint32 planes of the given shape (the hi/lo words of a 64-bit
    draw per element), host numpy."""
    k0, k1 = derive_key(seed, stream)
    total = int(np.prod(shape)) if shape else 1
    ctr = np.arange(total, dtype=np.uint32)
    hi, lo = _threefry2x32_np(k0, k1, ctr, np.zeros_like(ctr))
    return hi.reshape(shape), lo.reshape(shape)


def split_domain(master_seed: int, domain: str) -> int:
    """63-bit sub-seed for a named domain of a master seed. Both domains
    are Threefry outputs of the master, so one does not reveal the other
    (or the master) without a key recovery."""
    hi, lo = random_bits_np(master_seed, f"seed-domain/{domain}", ())
    return ((int(hi) << 32) | int(lo)) & 0x7FFFFFFFFFFFFFFF


def seeded_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy Generator for the small host-side draws (ternary secrets,
    Gaussian errors) keyed by the same (seed, stream) space."""
    k0, k1 = derive_key(seed, stream)
    return np.random.default_rng((k0 << 32) | k1)


# ---------------------------------------------------------------- torch words

def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0: torch.Tensor,
                 c1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Threefry-2x32 block per counter element: (c0, c1) → (y0, y1).
    All operands are int64 tensors holding 32-bit words in [0, 2^32); the
    key words broadcast against the counters (one pair per digit row)."""
    def rotl(x, r):
        return ((x << r) & _M32) | (x >> (32 - r))

    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def uniform_rns(k0, k1, moduli: Sequence[int], n: int, device
                ) -> torch.Tensor:
    """Uniform RNS polynomials from key words, generated on `device`: row l
    holds the 64-bit draws hi·2^32+lo at counters l·n .. l·n+n-1, reduced mod
    moduli[l] (bias 2^-34), word for word the reference's `uniform_rns_np`
    of the stream the words came from.

    k0/k1: Python ints → [L, n] int32; int sequences of length α → [α, L, n]
    where row j uses the pair (k0[j], k1[j]): one call draws every digit of
    a switching key (any leading shape works: [K, α] → [K, α, L, n]).

    An unsigned 64-bit draw does not fit int64, so hi·2^32+lo is reduced
    through its base-2^16 digits w3..w0 and the residues of 2^16, 2^32,
    2^48: w3·p48 + w2·p32 + w1·p16 + w0 < 2^48 is exact in int64."""
    L = len(moduli)
    k0 = torch.as_tensor(np.asarray(k0, dtype=np.int64), device=device)
    k1 = torch.as_tensor(np.asarray(k1, dtype=np.int64), device=device)
    ctr = torch.arange(L * n, dtype=torch.int64, device=device).reshape(L, n)
    hi, lo = threefry2x32(k0[..., None, None], k1[..., None, None], ctr,
                          torch.zeros_like(ctr))

    def col(values):
        return torch.tensor(values, dtype=torch.int64,
                            device=device).reshape(L, 1)

    q = col(list(moduli))
    p16, p32, p48 = (col([(1 << s) % m for m in moduli])
                     for s in (16, 32, 48))
    acc = (hi >> 16) * p48 + (hi & 0xFFFF) * p32 + (lo >> 16) * p16 \
        + (lo & 0xFFFF)
    return torch.remainder(acc, q).to(torch.int32)
