"""Negacyclic NTT over RNS limbs (port of abc_tpu/crypto/ntt.py).

Polynomials are int32 tensors [..., L, n] with any number of leading batch
dims; each limb transforms independently. The twiddle tables (ψ^brv powers
with their Shoup companions, host numpy, memoised per (n, q)) are computed
here and move to the device once per context. Transforms go through
ops/ntt_kernels.py: a CUDA tensor runs the hand-written kernels, a CPU
tensor the plain torch stage loop. Output order and values are the
reference's: forward position p holds the evaluation at ψ^(2·brv(p)+1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from abc_tpu_torch.crypto.numthy import find_minimal_2nth_root, modinv
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops.modarith import as_residues, ratio_table, shoup
from abc_tpu_torch.ops.ntt_kernels import ntt_fwd, ntt_inv


def _bit_reverse_vec(n: int, bits: int) -> np.ndarray:
    """[n] int64: the `bits`-bit reversal of every k < n."""
    k = np.arange(n, dtype=np.uint64)
    r = np.zeros(n, dtype=np.uint64)
    for _ in range(bits):
        r = (r << np.uint64(1)) | (k & np.uint64(1))
        k >>= np.uint64(1)
    return r.astype(np.int64)


_EVAL_PERM_TABLES: dict = {}


def eval_perm_tables(n: int):
    """(e, pos_of_exp) for evaluation-domain Galois permutations: forward-NTT
    position p holds the evaluation at ψ^e[p] with e[p] = 2·brv(p)+1, and
    pos_of_exp inverts that map over the odd exponents mod 2n. A pure
    function of n, memoised."""
    if n not in _EVAL_PERM_TABLES:
        e = 2 * _bit_reverse_vec(n, n.bit_length() - 1) + 1
        pos_of_exp = np.empty(2 * n, dtype=np.int64)
        pos_of_exp[e] = np.arange(n)
        _EVAL_PERM_TABLES[n] = (e, pos_of_exp)
    return _EVAL_PERM_TABLES[n]


def _power_table(base: int, n: int, q: int) -> np.ndarray:
    """[n] uint64: base^i mod q by iterative doubling (q < 2^32, so the
    products stay inside uint64)."""
    out = np.empty(n, dtype=np.uint64)
    out[0] = 1
    filled = 1
    step = base % q
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = out[:take] * np.uint64(step) % np.uint64(q)
        step = step * step % q
        filled += take
    return out


_LIMB_TABLE_CACHE: dict = {}


def _limb_tables(n: int, q: int):
    """(psi, fwd, fwd_sh, inv, inv_sh, ninv, ninv_sh) for one (n, modulus)
    pair: ψ the minimal primitive 2n-th root, fwd[k] = ψ^brv(k), inv[k] =
    ψ^-brv(k), each with its Shoup companion floor(w·2^32/q), and n⁻¹.
    A pure function of (n, q), memoised."""
    key = (n, q)
    hit = _LIMB_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    brv = _bit_reverse_vec(n, n.bit_length() - 1)
    psi = find_minimal_2nth_root(n, q)
    qv = np.uint64(q)
    fwd_p = _power_table(psi, n, q)[brv]
    inv_p = _power_table(modinv(psi, q), n, q)[brv]
    ninv = modinv(n, q)
    out = (psi,
           fwd_p.astype(np.uint32),
           # w < 2^30, so w << 32 < 2^62
           ((fwd_p << np.uint64(32)) // qv).astype(np.uint32),
           inv_p.astype(np.uint32),
           ((inv_p << np.uint64(32)) // qv).astype(np.uint32),
           ninv, shoup(ninv, q))
    _LIMB_TABLE_CACHE[key] = out
    return out


class NttContext:
    """Device twiddle tables for one (n, moduli) pair."""

    def __init__(self, n: int, moduli: Sequence[int], device):
        if n & (n - 1):
            raise ValueError("n must be a power of two")
        self.n = n
        self.moduli = list(moduli)
        self.device = torch.device(device)
        tabs = [_limb_tables(n, q) for q in self.moduli]
        # _limb_tables: (psi, fwd, fwd_sh, inv, inv_sh, ninv, ninv_sh)
        self.fwd_tw, self.fwd_tw_sh, self.inv_tw, self.inv_tw_sh = (
            as_residues(np.stack([t[i] for t in tabs]), self.device)
            for i in (1, 2, 3, 4))
        self.n_inv, self.n_inv_sh = (
            as_residues(np.asarray([t[i] for t in tabs]), self.device)
            for i in (5, 6))
        self.q = as_residues(np.asarray(self.moduli), self.device)    # [L]
        self.q_col = self.q.reshape(-1, 1)                           # [L, 1]
        # floor(2^64 / q) per modulus, read by the BEHZ tensor kernel
        self.ratio = ratio_table(self.moduli, self.device)            # [L]
        self._subsets: dict = {}

    def subset(self, indices: Sequence[int]) -> "NttContext":
        """A view of this context restricted to the given limb rows, with no
        recomputation of the tables: CKKS leveled operations use the rows
        {0..level-1}, and {0..level-1} ∪ specials for a key switch. Cached
        per index tuple. The kernels want q [L'] and contiguous [L', n]
        tables for the view's own L' (they read the limb as row % L'), so a
        prefix of the rows is a zero-copy slice and any other index set is
        one row gather, made here once. Make every view a program needs
        before a CUDA graph is captured: a gather inside a capture would
        allocate from the graph's pool."""
        key = tuple(int(i) for i in indices)
        hit = self._subsets.get(key)
        if hit is not None:
            return hit
        view = object.__new__(NttContext)
        view.n, view.device = self.n, self.device
        view.moduli = [self.moduli[i] for i in key]
        names = ("fwd_tw", "fwd_tw_sh", "inv_tw", "inv_tw_sh", "n_inv",
                 "n_inv_sh", "q", "ratio")
        if key == tuple(range(len(key))):
            for name in names:
                setattr(view, name, getattr(self, name)[:len(key)])
        else:
            idx = torch.tensor(key, dtype=torch.int64, device=self.device)
            for name in names:
                setattr(view, name, getattr(self, name).index_select(0, idx))
        view.q_col = view.q.reshape(-1, 1)
        view._subsets = {}
        self._subsets[key] = view
        return view

    # --- transforms ----------------------------------------------------------
    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        """Forward negacyclic NTT along the last axis ([..., L, n])."""
        return ntt_fwd(a.contiguous(), self.q, self.fwd_tw, self.fwd_tw_sh)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse negacyclic NTT along the last axis (inverse of fwd)."""
        return ntt_inv(a.contiguous(), self.q, self.inv_tw, self.inv_tw_sh,
                       self.n_inv, self.n_inv_sh)

    # --- pointwise helpers (the RNS elementwise kernel) ----------------------
    def pointwise_mul(self, a, b):
        return ew.mul(a, b, self.q_col, self.ratio)

    def add(self, a, b):
        return ew.add(a, b, self.q_col, self.ratio)

    def sub(self, a, b):
        return ew.sub(a, b, self.q_col, self.ratio)

    def neg(self, a):
        return ew.neg(a, self.q_col)

    def negacyclic_mul(self, a, b):
        """Full polynomial product in R_q = Z_q[x]/(x^n+1) via NTT."""
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))
