"""Coefficient-sharded CKKS ct-ct multiply + relinearization (port of
abc_tpu/parallel/dist_ckks.py; BASELINE config 5: "CKKS multi-host: limbs +
coeffs sharded, NTT all-to-all").

Composition over a mesh axis carrying polynomial COEFFICIENTS:
  * every NTT (the tensor product in the data base, the key-switch
    decomposition in the extended base q∪P) runs through DistNttContext:
    exchange stages between shards, local stages on the NTT kernels;
  * everything else (the tensor product, the switching-key inner product,
    the digit accumulation, the division by P) is elementwise over the
    coefficients and needs no communication under the same sharding.

The operands are scattered once, the whole op runs on this process's
shards in the layout of parallel/mesh.py, and the product is gathered once.
The words are those of CkksContext.multiply(a, b, rescale=False) on one
device. k = 1 only, as in the reference.
"""

from __future__ import annotations

import torch

from abc_tpu_torch.crypto.ckks import CkksContext
from abc_tpu_torch.ops.modarith import t64
from abc_tpu_torch.parallel.dist_ntt import DistNttContext
from abc_tpu_torch.parallel.mesh import Mesh, same_device


class DistCkksMultiplier:
    """Sharded multiply + relin at the top level of a CkksContext. The relin
    key is sliced to this process's coefficient shards once, here."""

    def __init__(self, ctx: CkksContext, mesh: Mesh, axis: str = "coeff"):
        if ctx.params.ks_digits != 1:
            raise ValueError(
                "DistCkks implements the single-special-prime (k=1) "
                "key-switch layout; build the context with ks_digits=1")
        if not same_device(mesh.device, ctx.device):
            raise ValueError(f"the mesh's shards are on {mesh.device}, the "
                             f"context on {ctx.device}")
        self.ctx, self.mesh, self.axis = ctx, mesh, axis
        L = ctx.params.L
        self.level = L
        D = mesh.shape[axis]
        self.dq = DistNttContext(ctx._ntt_level[L], D)
        self.dqp = DistNttContext(ctx._ntt_cols[L], D)
        self.dq.bind(mesh, axis)
        self.dqp.bind(mesh, axis)
        self.q_l = ctx._q_at(L)                          # [L, 1]
        self.q_cols = ctx._q_cols[L]                     # [L+1, 1]
        # the relin key [L, L+1, n] (its full-level slice), coefficient-
        # sharded: [L, D, L+1, S] under LocalComm, [L, L+1, S] on a rank
        ksk_b, ksk_a = ctx._ksk_device("relin", L)
        self.ksk_b = mesh.scatter(ksk_b, axis, dim=-1).contiguous()
        self.ksk_a = mesh.scatter(ksk_a, axis, dim=-1).contiguous()

    def multiply_local(self, a, b):
        """[2, (D,) L, S] × [2, (D,) L, S] → [2, (D,) L, S]: this process's
        coefficient shards of the relinearized product."""
        mesh, axis, L = self.mesh, self.axis, self.level
        ctx, q = self.ctx, self.q_l
        fa = self.dq.fwd_local(a, mesh, axis)
        fb = self.dq.fwd_local(b, mesh, axis)
        d0 = t64.mul(fa[0], fb[0], q)
        d1 = t64.add(t64.mul(fa[0], fb[1], q), t64.mul(fa[1], fb[0], q), q)
        d2 = t64.mul(fa[1], fb[1], q)
        data = self.dq.inv_local(torch.stack([d0, d1, d2]), mesh, axis)

        # key switch of the s² component: digit l of data[2] lifted over the
        # L+1 columns, [L, (D,) L+1, S] (digit axis first, the shard axis
        # stays at -3)
        digits = data[2].movedim(-2, 0)[..., None, :]
        lifted = digits.expand(tuple(digits.shape[:-2]) +
                               (L + 1, digits.shape[-1]))
        qc = self.q_cols
        Dm = self.dqp.fwd_local(torch.where(lifted >= qc, lifted - qc,
                                            lifted), mesh, axis)
        acc_b = t64.sum_mod(t64.mul(Dm, self.ksk_b, qc), qc, dim=0)
        acc_a = t64.sum_mod(t64.mul(Dm, self.ksk_a, qc), qc, dim=0)
        acc = self.dqp.inv_local(torch.stack([acc_b, acc_a]), mesh, axis)
        k0 = ctx._mod_switch_down(acc[0], L)
        k1 = ctx._mod_switch_down(acc[1], L)
        return torch.stack([t64.add(data[0], k0, q), t64.add(data[1], k1, q)])

    def __call__(self, a_data, b_data):
        """[2, L, n] × [2, L, n] → [2, L, n], relinearized: whole tensors in
        and out, sharded over the coefficients in between."""
        mesh, axis = self.mesh, self.axis
        out = self.multiply_local(mesh.scatter(a_data, axis, dim=-1),
                                  mesh.scatter(b_data, axis, dim=-1))
        return mesh.gather(out, axis, dim=-1)
