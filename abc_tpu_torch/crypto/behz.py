"""BEHZ full-RNS BFV ct·ct multiplication (port of abc_tpu/crypto/behz.py).

Same pipeline as the reference (lift q → Bsk ∪ {m̃} with the small Montgomery
correction, tensor product in NTT form per base, fast floor in Bsk,
Shenoy-Kumaresan back to q). The auxiliary primes (L+1 B-primes and m_sk,
all 30-bit, disjoint from q ∪ {P, t}) and every constant table are computed
here from host bigints exactly as the reference computes them; they live on
the device as int32. The four chains (`_to_bsk`, `_tensor`, `_fast_floor`,
`_from_bsk`) are the kernels of csrc/behz.cu on a CUDA device and their
plain torch versions on the CPU (the `_plain` methods here, and
ops/behz_kernels.py:tensor_plain).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.crypto.numthy import gen_ntt_primes, modinv
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.ops import behz_kernels as bk
from abc_tpu_torch.ops.behz_kernels import M_TILDE
from abc_tpu_torch.ops.modarith import as_residues, in_chain, t64

_MASK = M_TILDE - 1


class BehzContext:
    """Device tables + auxiliary-base NTT for BEHZ multiplication."""

    def __init__(self, params: BfvParams, ntt_q: NttContext):
        """ntt_q: the NttContext over the data primes; its device is the
        context's."""
        self.params = params
        L, n, t = params.L, params.n, params.plain_modulus
        qs = params.data_primes
        q_big = params.q
        if M_TILDE <= 2 * (L + 2):
            raise ValueError("m_tilde must exceed 2·(base size)")
        dev = ntt_q.device

        aux = gen_ntt_primes(30, L + 2, n, exclude=params.coeff_modulus + [t])
        self.b_primes = aux[:-1]
        self.m_sk = aux[-1]
        self.bsk = self.b_primes + [self.m_sk]          # size L+2
        B_big = 1
        for b in self.b_primes:
            B_big *= b
        self.ntt_q = ntt_q
        self.ntt_bsk = NttContext(n, self.bsk, dev)

        host = {}

        def as_col(v):
            return np.asarray(v, dtype=np.uint32).reshape(-1, 1)

        # step 1: y_i = [x_i · m̃ · (q/q_i)^{-1}]_{q_i}
        qhat = [q_big // qi for qi in qs]
        qhat_inv = [modinv(qh % qi, qi) for qh, qi in zip(qhat, qs)]
        host["mtilde_qhatinv_mod_q"] = as_col(
            [(M_TILDE * hi) % qi for hi, qi in zip(qhat_inv, qs)])
        host["qhatinv_mod_q"] = as_col(qhat_inv)
        # conversion tables  [L, dst]
        host["qhat_mod_bsk"] = np.asarray(
            [[qh % b for b in self.bsk] for qh in qhat], dtype=np.uint32)
        host["qhat_mod_mtilde"] = as_col([qh % M_TILDE for qh in qhat])
        # step 2
        host["neg_qinv_mod_mtilde"] = np.uint32(
            (-modinv(q_big % M_TILDE, M_TILDE)) % M_TILDE)
        host["q_mod_bsk"] = as_col([q_big % b for b in self.bsk])
        host["mtilde_inv_mod_bsk"] = as_col(
            [modinv(M_TILDE, b) for b in self.bsk])
        # step 4
        host["t_mod_q"] = as_col([t % qi for qi in qs])
        host["t_mod_bsk"] = as_col([t % b for b in self.bsk])
        host["qinv_mod_bsk"] = as_col([modinv(q_big % b, b) for b in self.bsk])
        # step 5 (Shenoy-Kumaresan over B with m_sk)
        bhat = [B_big // b for b in self.b_primes]
        host["bhatinv_mod_b"] = as_col(
            [modinv(bh % b, b) for bh, b in zip(bhat, self.b_primes)])
        host["bhat_mod_q"] = np.asarray(
            [[bh % qi for qi in qs] for bh in bhat], dtype=np.uint32)
        host["bhat_mod_msk"] = as_col([bh % self.m_sk for bh in bhat])
        host["binv_mod_msk"] = np.uint32(modinv(B_big % self.m_sk, self.m_sk))
        host["B_mod_q"] = as_col([B_big % qi for qi in qs])
        host["msk_mod_q"] = as_col([self.m_sk % qi for qi in qs])

        self.host_tab = host
        self.tab = {k: as_residues(v, dev) for k, v in host.items()}
        self.q_cols = as_residues(as_col(qs), dev)            # [L, 1]
        self.bsk_cols = as_residues(as_col(self.bsk), dev)    # [L+2, 1]
        self.msk_col = as_residues(self.m_sk, dev).reshape(1, 1)
        self.msk_half = self.m_sk >> 1
        # the kernels' packed tables, on a CUDA device only (no kernel runs
        # on the CPU)
        self.kernel_tab = {} if dev.type == "cpu" else {
            k: as_residues(v, dev) for k, v in self.kernel_words().items()}

    def kernel_words(self, pack=bk) -> dict:
        """The packed uint32 tables of the three conversion kernels
        (ops/behz_kernels.py, csrc/behz.cu "Tables"), from the host tables;
        `pack` is the module of the packing functions (scripts/behz_ab.py
        passes an earlier commit's, for the kernels of that commit)."""
        h, qs = self.host_tab, self.params.data_primes
        return {
            "to_bsk": pack.to_bsk_words(
                qs, self.bsk, h["mtilde_qhatinv_mod_q"], h["qhat_mod_mtilde"],
                h["neg_qinv_mod_mtilde"], h["q_mod_bsk"],
                h["mtilde_inv_mod_bsk"], h["qhat_mod_bsk"]),
            "fast_floor": pack.fast_floor_words(
                qs, self.bsk, h["t_mod_q"], h["qhatinv_mod_q"],
                h["t_mod_bsk"], h["qinv_mod_bsk"], h["qhat_mod_bsk"]),
            "from_bsk": pack.from_bsk_words(
                self.b_primes, self.m_sk, qs, h["bhatinv_mod_b"],
                h["bhat_mod_msk"], h["binv_mod_msk"], h["B_mod_q"],
                h["msk_mod_q"], h["bhat_mod_q"]),
        }

    # ------------------------------------------------------- plain versions
    @staticmethod
    def _fastconv(y, table, dst_q):
        """Σ_i y_i·table[i, d] mod dst_d — the RNS base-conversion contraction.
        y: [..., K, n], table: [K, D] → out [..., D, n]."""
        prod = t64.mul(y[..., :, None, :], table[:, :, None], dst_q[None])
        return t64.sum_mod(prod, dst_q, dim=-3)

    def _to_bsk_plain(self, x):
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

    def _fast_floor_plain(self, e_q, e_bsk):
        """floor(t·e/q) in base Bsk, inputs in (q, Bsk) coeff domain."""
        T = self.tab
        tq = t64.mul(e_q, T["t_mod_q"], self.q_cols)
        tb = t64.mul(e_bsk, T["t_mod_bsk"], self.bsk_cols)
        y = t64.mul(tq, T["qhatinv_mod_q"], self.q_cols)
        conv = self._fastconv(y, T["qhat_mod_bsk"], self.bsk_cols)
        return t64.mul(t64.sub(tb, conv, self.bsk_cols),
                       T["qinv_mod_bsk"], self.bsk_cols)

    def _from_bsk_plain(self, x_bsk):
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

    # ------------------------------------------------------------- the chains
    # Each chain is the plain version above on a CPU tensor and one kernel of
    # csrc/behz.cu on any other (ops/behz_kernels.py checks it: a CUDA
    # tensor, int32, contiguous, on the tables' device); the ranges name them
    # in a profile.
    @in_chain("to_bsk")
    def _to_bsk(self, x):
        """Exact base extension q → Bsk of x ∈ [0,q)^n ([..., L, n])."""
        if x.device.type == "cpu":
            return self._to_bsk_plain(x)
        return bk.behz_to_bsk(x, self.kernel_tab.get("to_bsk"),
                              len(self.bsk))

    @in_chain("tensor")
    def _tensor(self, pre1, pre2):
        """The tensor products of two operands' precompute_operand forms,
        over base q and over Bsk ([..., 3, L, n], [..., 3, L+2, n], NTT
        domain): one launch on the card."""
        (f1q, f1b), (f2q, f2b) = pre1, pre2
        return bk.behz_tensor((f1q, f2q, self.ntt_q.q_col, self.ntt_q.ratio),
                              (f1b, f2b, self.ntt_bsk.q_col,
                               self.ntt_bsk.ratio))

    @in_chain("fast_floor")
    def _fast_floor(self, e_q, e_bsk):
        """floor(t·e/q) in base Bsk, inputs in (q, Bsk) coeff domain."""
        if e_q.device.type == "cpu":
            return self._fast_floor_plain(e_q, e_bsk)
        return bk.behz_fast_floor(e_q, e_bsk,
                                  self.kernel_tab.get("fast_floor"))

    @in_chain("from_bsk")
    def _from_bsk(self, x_bsk):
        """Exact conversion Bsk → q (Shenoy-Kumaresan with m_sk)."""
        if x_bsk.device.type == "cpu":
            return self._from_bsk_plain(x_bsk)
        return bk.behz_from_bsk(x_bsk, self.kernel_tab.get("from_bsk"),
                                len(self.params.data_primes))

    # ---------------------------------------------------------------- multiply
    def precompute_operand(self, ct_data) -> Tuple:
        """(fwd-NTT over q, fwd-NTT over Bsk) of a ciphertext — the
        per-operand half of `multiply`."""
        # the kernels take contiguous operands: a view (a row of a batch, a
        # level's limbs) is copied here once, for both transforms
        ct_data = ct_data.contiguous()
        return (self.ntt_q.fwd(ct_data),
                self.ntt_bsk.fwd(self._to_bsk(ct_data)))

    def multiply(self, pre1: Tuple, pre2: Tuple):
        """Tensor product of two ciphertexts given as their precompute_operand
        forms ([..., 2, L, n] and [..., 2, L+2, n]) → [..., 3, L, n]
        coefficient-domain product over q (pre-relinearization). A square
        passes the same forms twice."""
        eq, eb = self._tensor(pre1, pre2)
        eq, eb = self.ntt_q.inv(eq), self.ntt_bsk.inv(eb)
        return self._from_bsk(self._fast_floor(eq, eb))
