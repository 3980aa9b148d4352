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

On the card every step is a hand-written kernel, the single-device op's
own where the layout allows: the tensor product is behz_tensor (K3b), the
digit lift ks_decompose (K4c), the contraction ks_contract (K4a), the
division by P with the relinearization's adds ks_mod_down's relin form
(K9a), the exchanges dist_ntt_combine (K8a). Under LocalComm a shard axis
lies between the components and the limbs, [C, D, L, S]; each kernel reads
it as rows it already takes, with no copy:
  * behz_tensor and ks_contract take the shard axis as more limbs, [C,
    D·L, S] with q tiled D times (DistNttContext.bind's q_col, ratio);
  * the lift writes [D, L, L+1, S] and the distributed NTT reads it with
    the digit axis moved in front of the shards, at its strides;
  * the key is laid out once as [L, D·(L+1), S], the contraction's digit
    axis first;
  * the last exchange of the accumulators' inverse writes them as [D, 2,
    L+1, S], the pairs of halves ks_mod_down's tail takes, which reads the
    product's components [D, 3, L, S] at their strides.
The one copy left is the gather of the result.
"""

from __future__ import annotations

import torch

from abc_tpu_torch.crypto.ckks import CkksContext
from abc_tpu_torch.ops import keyswitch_kernels as kk
from abc_tpu_torch.ops.behz_kernels import behz_tensor
from abc_tpu_torch.ops.modarith import chain_range
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
        self.bq = self.dq.bind(mesh, axis)
        self.bqp = self.dqp.bind(mesh, axis)
        # the relin key [L, L+1, n] (its full-level slice), coefficient-
        # sharded and laid out for ks_contract: [L, D·(L+1), S] under
        # LocalComm (the shards as more columns), [L, L+1, S] on a rank
        ksk_b, ksk_a = ctx._ksk_device("relin", L)
        self.ksk_b, self.ksk_a = (
            self.dqp._flat(mesh.scatter(k, axis, dim=-1), self.bqp)
            .contiguous() for k in (ksk_b, ksk_a))

    def multiply_local(self, a, b):
        """[2, (D,) L, S] × [2, (D,) L, S] → [2, (D,) L, S]: this process's
        coefficient shards of the relinearized product."""
        mesh, axis, L = self.mesh, self.axis, self.level
        bq, bqp = self.bq, self.bqp
        fa = self.dq.fwd_local(a, mesh, axis)
        fb = self.dq.fwd_local(b, mesh, axis)
        with chain_range("tensor"):
            d, = behz_tensor((self.dq._flat(fa, bq), self.dq._flat(fb, bq),
                              bq["q_col"], bq["ratio"]))
        data = self.dq.inv_local(d.reshape((3,) + tuple(fa.shape[1:])),
                                 mesh, axis)

        # key switch of the s² component: digit l of data[2] lifted over the
        # L+1 columns, [(D,) L, L+1, S]; the distributed NTT reads it with
        # the digit axis first and the shard axis at -3
        qp = self.dqp.ctx
        lifted = kk.decompose(data[2], qp.q_col, qp.ratio)
        if mesh.is_local:
            lifted = lifted.movedim(-4, -3)
        Dm = self.dqp.fwd_local(lifted, mesh, axis)      # [L, (D,) L+1, S]
        acc = kk.contract(self.dqp._flat(Dm, bqp), self.ksk_b, self.ksk_a,
                          bqp["q_col"], bqp["ratio"])
        acc = acc.reshape((2,) + tuple(Dm.shape[1:]))    # [2, (D,) L+1, S]
        if mesh.is_local:
            # each shard's two halves side by side, for the tail
            halves = torch.empty((acc.shape[1], 2) + tuple(acc.shape[2:]),
                                 dtype=torch.int32, device=acc.device)
            self.dqp.inv_local(acc, mesh, axis, out=halves.movedim(0, 1))
            c = data.movedim(0, 1)                       # [D, 3, L, S]
        else:
            halves, c = self.dqp.inv_local(acc, mesh, axis), data
        out = self.ctx._mod_switch_down(halves, L, kk.Tail("relin", c))
        return out.movedim(0, 1) if mesh.is_local else out

    def __call__(self, a_data, b_data):
        """[2, L, n] × [2, L, n] → [2, L, n], relinearized: whole tensors in
        and out, sharded over the coefficients in between."""
        mesh, axis = self.mesh, self.axis
        out = self.multiply_local(mesh.scatter(a_data, axis, dim=-1),
                                  mesh.scatter(b_data, axis, dim=-1))
        return mesh.gather(out, axis, dim=-1)
