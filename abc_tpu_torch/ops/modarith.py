"""Elementwise RNS arithmetic on torch tensors (port of ops/modarith.py).

Residues are stored as `torch.int32` in [0, q) with q < 2^30, so they are
never negative. Every operation widens to int64, where a product of two
residues (< 2^60) is exact, and returns int32 in [0, q). The engine `t64`
has the method set of the reference engines `np64`/`jx32`; its results are
the same canonical words, so all three are bit-identical.

Moduli arguments (`q`) broadcast against the data, as in the reference:
typically a `[L, 1]` column of an `[..., L, n]` polynomial.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CHAIN_PREFIX = "chain::"


def chain_range(name: str):
    """A named torch.profiler range around one elementwise chain (a BEHZ
    conversion, the tensor product, the digit lift, the key-switch inner
    product, a mod switch, a rescale): `with chain_range("to_bsk"): ...`.
    An eager profile then sums device time per chain (the kernels themselves
    are anonymous elementwise kernels). It launches nothing and records
    nothing while no profiler runs."""
    return torch.profiler.record_function(CHAIN_PREFIX + name)


def in_chain(name: str):
    """Decorator: the whole call runs inside chain_range(name). Transform
    launches made inside it are told apart by their kernels' names."""
    def decorate(fn):
        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with chain_range(name):
                return fn(*args, **kwargs)
        return ranged
    return decorate


def barrett_mu(q: int) -> int:
    """mu = floor(2^60 / q), the Barrett constant the reference's u32 engine
    carries in its tables (`mu_full`, `dec_mu_src`). Fits 32 bits only for q
    in [2^29, 2^30); smaller moduli (the 20-bit plain modulus) get the
    placeholder 0. The torch engine's products are exact and read no mu; the
    tables keep the words so that a context's state matches the reference's."""
    if q < (1 << 29):
        return 0
    if q >= (1 << 30):
        raise ValueError("primes must be below 2^30")
    return (1 << 60) // q


def shoup(w: int, q: int) -> int:
    """Companion word floor(w·2^32/q) for Shoup multiplication (read by the
    CUDA NTT kernels)."""
    return (w << 32) // q


def barrett_ratio(q: int) -> int:
    """floor(2^64 / q), the 64-bit constant with which csrc/behz.cu's
    reduce64 reduces any 64-bit value mod q."""
    return (1 << 64) // q


def ratio_table(moduli, device) -> torch.Tensor:
    """[len(moduli)] int64 tensor of barrett_ratio words, bit for bit (the
    kernels read them as uint64)."""
    words = np.asarray([barrett_ratio(int(q)) for q in moduli],
                       dtype=np.uint64)
    return torch.from_numpy(words.view(np.int64)).to(device)


def as_residues(arr, device) -> torch.Tensor:
    """Host 32-bit words → int32 tensor on `device`, bit for bit. Residues
    (< 2^30) keep their value; full 32-bit words such as Shoup companions
    keep their bits, which the CUDA kernels read back as uint32. Integer
    scalars become 0-d tensors."""
    host = np.ascontiguousarray(np.asarray(arr).astype(np.uint32))
    return torch.from_numpy(host.view(np.int32)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """int32 tensor → host uint32 array (the reference's dtype), bit for
    bit."""
    return t.detach().cpu().numpy().view(np.uint32)


def _w(x):
    return x.to(torch.int64)


class t64:
    """Torch engine: int32 storage, exact int64 arithmetic inside."""

    @staticmethod
    def add(a, b, q):
        q = _w(q)
        r = _w(a) + _w(b)
        return torch.where(r >= q, r - q, r).to(torch.int32)

    @staticmethod
    def sub(a, b, q):
        r = _w(a) - _w(b)
        return torch.where(r < 0, r + _w(q), r).to(torch.int32)

    @staticmethod
    def neg(a, q):
        a = _w(a)
        return torch.where(a == 0, a, _w(q) - a).to(torch.int32)

    @staticmethod
    def mul(a, b, q, mu=None):
        """a·b mod q. The int64 product is exact, so the remainder needs no
        Barrett constant; `mu` is accepted for the reference engines' call
        signature and not read."""
        return torch.remainder(_w(a) * _w(b), _w(q)).to(torch.int32)

    @staticmethod
    def mul_shoup(a, w, w_shoup, q):
        """a·w mod q for a fixed operand w. The reference's Shoup product
        relies on u32 wraparound; here the exact int64 product gives the
        same canonical word, so the companion `w_shoup` is not read."""
        return torch.remainder(_w(a) * _w(w), _w(q)).to(torch.int32)

    @staticmethod
    def sum_mod(terms, q, dim=0):
        """Σ over `dim` of residues, reduced mod q (terms < 2^30, so up to
        2^33 terms fit in int64)."""
        return torch.remainder(_w(terms).sum(dim=dim), _w(q)).to(torch.int32)
