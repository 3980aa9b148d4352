"""Negacyclic NTT over RNS limbs (port of abc_tpu/crypto/ntt.py).

Polynomials are int32 tensors [..., L, n] with any number of leading batch
dims; each limb transforms independently. The twiddle tables are the
reference's (abc_tpu.crypto.ntt._limb_tables, host numpy, memoised per
(n, q)) and move to the device once per context. Transforms go through
ops/ntt_kernels.py: a CUDA tensor runs the hand-written kernels, a CPU
tensor the plain torch stage loop. Output order and values are the
reference's: forward position p holds the evaluation at ψ^(2·brv(p)+1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from abc_tpu.crypto.ntt import _limb_tables
from abc_tpu_torch.ops.modarith import as_residues, t64
from abc_tpu_torch.ops.ntt_kernels import ntt_fwd, ntt_inv


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

    # --- transforms ----------------------------------------------------------
    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        """Forward negacyclic NTT along the last axis ([..., L, n])."""
        return ntt_fwd(a.contiguous(), self.q, self.fwd_tw, self.fwd_tw_sh)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse negacyclic NTT along the last axis (inverse of fwd)."""
        return ntt_inv(a.contiguous(), self.q, self.inv_tw, self.inv_tw_sh,
                       self.n_inv, self.n_inv_sh)

    # --- pointwise helpers ---------------------------------------------------
    def pointwise_mul(self, a, b):
        return t64.mul(a, b, self.q_col)

    def add(self, a, b):
        return t64.add(a, b, self.q_col)

    def sub(self, a, b):
        return t64.sub(a, b, self.q_col)

    def neg(self, a):
        return t64.neg(a, self.q_col)

    def negacyclic_mul(self, a, b):
        """Full polynomial product in R_q = Z_q[x]/(x^n+1) via NTT."""
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))
