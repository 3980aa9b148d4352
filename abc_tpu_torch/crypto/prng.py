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

The cipher here is the numpy one, for words on the host: `derive_key` /
`derive_keys`, `split_domain` and `seeded_rng` (a numpy Generator for the
small secret draws). Polynomials are drawn from the key words on the
context's device by ops/rlwe_kernels.rns_uniform: on the card the
`rns_uniform` kernel of csrc/rlwe.cu, on the CPU its plain torch version,
word for word this module's cipher with the rotations and parity below.

The secret draws go through numpy's PCG64 (`seeded_rng`), which is not a
CSPRNG, and auto-generated master seeds carry 63 bits of OS entropy: the
contract is reproducibility against the reference, not hardening.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence, Tuple

import numpy as np

# Threefry-2x32's rotations (groups of four rounds, in turn) and the key
# schedule's parity word
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ host words

def _threefry2x32_np(k0, k1, c0, c1):
    """One Threefry-2x32 block per counter element on numpy uint32 (20
    rounds: 5 groups of 4, key injection after each group)."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    k0, k1 = np.uint32(k0), np.uint32(k1)
    with np.errstate(over="ignore"):       # u32 wraparound is the cipher
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(PARITY))
        x0 = c0.astype(np.uint32) + ks[0]
        x1 = c1.astype(np.uint32) + ks[1]
        for g in range(5):
            for r in ROTATIONS[g % 2]:
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
    k0, k1 = derive_keys(seed, [stream])[0]
    return int(k0), int(k1)


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


def derive_keys(seed: int, streams: Sequence[str]) -> np.ndarray:
    """The key words of many streams at once: uint32 [len(streams), 2], row
    i the (k0, k1) of streams[i] (derive_key), the Threefry blocks of all
    streams in one vectorised numpy call."""
    h = np.asarray([struct.unpack("<4I", hashlib.sha256(
        stream.encode()).digest()[:16]) for stream in streams],
        dtype=np.uint32).reshape(-1, 4)
    x0, x1 = _threefry2x32_np(seed & _M32, (seed >> 32) & _M32, h[:, 0],
                              h[:, 1])
    return np.stack([x0 ^ h[:, 2], x1 ^ h[:, 3]], axis=-1)
