"""BEHZ full-RNS BFV ct·ct multiplication (port of abc_tpu/crypto/behz.py).

Same pipeline as the reference (lift q → Bsk ∪ {m̃} with the small Montgomery
correction, tensor product in NTT form per base, fast floor in Bsk,
Shenoy-Kumaresan back to q). The auxiliary primes and every constant table
come from a reference np64 `BehzContext` (its `.tab` is a host dict), so both
sides compute with identical constants; here they live on the device as
int32 and the arithmetic is the torch engine's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from abc_tpu.crypto.behz import M_TILDE
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops.modarith import as_residues, t64

_MASK = M_TILDE - 1


class BehzContext:
    """Device tables + auxiliary-base NTT for BEHZ multiplication."""

    def __init__(self, ref, ntt_q: NttContext):
        """ref: an abc_tpu np64 BehzContext for the same parameters; ntt_q:
        the port's NttContext over the data primes."""
        dev = ntt_q.device
        self.ntt_q = ntt_q
        self.ntt_bsk = NttContext(ref.params.n, ref.bsk, dev)
        self.tab = {k: as_residues(v, dev) for k, v in ref.tab.items()}
        self.q_cols = as_residues(ref.q_cols, dev)          # [L, 1]
        self.bsk_cols = as_residues(ref.bsk_cols, dev)      # [L+2, 1]
        self.msk_col = as_residues(ref.m_sk, dev).reshape(1, 1)
        self.msk_half = ref.msk_half

    # ----------------------------------------------------------------- helpers
    @staticmethod
    def _fastconv(y, table, dst_q):
        """Σ_i y_i·table[i, d] mod dst_d — the RNS base-conversion contraction.
        y: [..., K, n], table: [K, D] → out [..., D, n]."""
        prod = t64.mul(y[..., :, None, :], table[:, :, None], dst_q[None])
        return t64.sum_mod(prod, dst_q, dim=-3)

    def _to_bsk(self, x):
        """Exact base extension q → Bsk of x ∈ [0,q)^n ([..., L, n])."""
        T = self.tab
        y = t64.mul(x, T["mtilde_qhatinv_mod_q"], self.q_cols)
        conv_b = self._fastconv(y, T["qhat_mod_bsk"], self.bsk_cols)
        # conversion residue mod m̃ = 2^16; the reference's u32 product
        # wraps here, which leaves the low 16 bits unchanged, so the exact
        # int64 product gives the same r
        terms = (y.to(torch.int64) & _MASK) * \
            T["qhat_mod_mtilde"].to(torch.int64)
        conv_mt = (terms & _MASK).sum(dim=-2) & _MASK
        r = (conv_mt * T["neg_qinv_mod_mtilde"].to(torch.int64)) & _MASK
        # centered r: r − m̃ (mod b) when r ≥ m̃/2
        r = r[..., None, :]
        bsk = self.bsk_cols.to(torch.int64)
        r_b = torch.where(r >= (M_TILDE >> 1), r + bsk - M_TILDE, r)
        qr = t64.mul(T["q_mod_bsk"], r_b, self.bsk_cols)
        return t64.mul(t64.add(conv_b, qr, self.bsk_cols),
                       T["mtilde_inv_mod_bsk"], self.bsk_cols)

    def _fast_floor(self, e_q, e_bsk):
        """floor(t·e/q) in base Bsk, inputs in (q, Bsk) coeff domain."""
        T = self.tab
        tq = t64.mul(e_q, T["t_mod_q"], self.q_cols)
        tb = t64.mul(e_bsk, T["t_mod_bsk"], self.bsk_cols)
        y = t64.mul(tq, T["qhatinv_mod_q"], self.q_cols)
        conv = self._fastconv(y, T["qhat_mod_bsk"], self.bsk_cols)
        return t64.mul(t64.sub(tb, conv, self.bsk_cols),
                       T["qinv_mod_bsk"], self.bsk_cols)

    def _from_bsk(self, x_bsk):
        """Exact conversion Bsk → q (Shenoy-Kumaresan with m_sk)."""
        T = self.tab
        xb, x_msk = x_bsk[..., :-1, :], x_bsk[..., -1, :]
        y = t64.mul(xb, T["bhatinv_mod_b"], self.bsk_cols[:-1])
        conv_q = self._fastconv(y, T["bhat_mod_q"], self.q_cols)
        conv_msk = self._fastconv(y, T["bhat_mod_msk"],
                                  self.msk_col)[..., 0, :]
        alpha = t64.mul(t64.sub(conv_msk, x_msk, self.msk_col[0]),
                        T["binv_mod_msk"], self.msk_col[0])
        # centered α, reduced mod each q_j (uniform 30-bit primes)
        a = alpha[..., None, :]
        a_red = torch.where(a >= self.q_cols, a - self.q_cols, a)
        neg = (alpha > self.msk_half)[..., None, :]
        a_cent = torch.where(neg, t64.sub(a_red, T["msk_mod_q"], self.q_cols),
                             a_red)
        corr = t64.mul(T["B_mod_q"], a_cent, self.q_cols)
        return t64.sub(conv_q, corr, self.q_cols)

    # ---------------------------------------------------------------- multiply
    def precompute_operand(self, ct_data) -> Tuple:
        """(fwd-NTT over q, fwd-NTT over Bsk) of a ciphertext — the
        per-operand half of `multiply`."""
        return (self.ntt_q.fwd(ct_data),
                self.ntt_bsk.fwd(self._to_bsk(ct_data)))

    def multiply(self, pre1: Tuple, pre2: Tuple):
        """Tensor product of two ciphertexts given as their precompute_operand
        forms → [3, L, n] coefficient-domain product over q
        (pre-relinearization). A square passes the same forms twice."""
        (f1q, f1b), (f2q, f2b) = pre1, pre2

        def tensor(f1, f2, q):
            e0 = t64.mul(f1[0], f2[0], q)
            e1 = t64.add(t64.mul(f1[0], f2[1], q), t64.mul(f1[1], f2[0], q), q)
            e2 = t64.mul(f1[1], f2[1], q)
            return torch.stack([e0, e1, e2])

        eq = self.ntt_q.inv(tensor(f1q, f2q, self.q_cols))
        eb = self.ntt_bsk.inv(tensor(f1b, f2b, self.bsk_cols))
        return self._from_bsk(self._fast_floor(eq, eb))
