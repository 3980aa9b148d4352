"""Coefficient-sharded negacyclic NTT over a mesh axis (port of
abc_tpu/parallel/dist_ntt.py).

The degree-n polynomial is cut into D contiguous blocks of S = n/D
coefficients, one per shard, and the NTT's long-stride butterfly stages
become exchanges between shards.

Decomposition (Cooley-Tukey forward, natural → bit-reversed order, the
convention of crypto/ntt.py, so results are the words of the whole
transform):

  * stages with stride t ≥ S (the first log2 D stages): butterfly partners
    sit at the same local offset on shard d ± t/S, and the twiddle is one
    constant per shard. Each stage is one block exchange (ppermute with the
    partner d XOR t/S) and elementwise math: the hypercube ("binary
    exchange") form, log2(D)·S words per shard.
  * stages with stride t < S: local to the shard. For block-contiguous
    sharding the local stage loop of shard d is exactly a size-S NTT stage
    loop whose stage-m twiddle block is the global table slice
    w[m·(D+d) : m·(D+d)+m]; packed into the standard layout (stage m at
    [m, 2m)) of a size-S table per shard, it is a size-S forward transform.
    So the local stages run on the port's NTT kernels (ops/ntt_kernels.py:
    ntt_fwd at n = S with the shard's tables), and on their plain versions
    for CPU tensors. Under LocalComm every shard goes in ONE launch: the
    shards are laid out [..., D, L, S] and flattened to D·L rows, with the
    tables stacked to [D·L, S] and q tiled D times (the kernels read limb
    = row % L'). The kernels need S ≥ ntt_kernels.MIN_N on a CUDA device.

The inverse mirrors this (Gentleman-Sande): the local stages first (ntt_inv
at n = S with the shard's inverse tables and a unit scale), then the log2 D
exchange stages, then the n⁻¹ scale, which is elementwise.

Exchange pipelining: an exchange stage's butterfly is elementwise over the
local [L, S] block, so the block splits into `pipeline_chunks` independent
(exchange → combine) chains per stage; every chunk's exchange is started
before any combine, so that under DistComm the combine of one chunk can
overlap the transfer of the next. nc=1 is the sequential schedule. The
words do not depend on it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops.modarith import as_residues, shoup, t64, to_host
from abc_tpu_torch.ops.ntt_kernels import ntt_fwd, ntt_inv
from abc_tpu_torch.parallel.mesh import Mesh


class DistNttContext:
    """Per-shard tables for a coefficient-sharded NTT of one NttContext.

    ctx: an NttContext with n = D·S
    D:   number of shards of the mesh axis that carries the coefficients
    """

    def __init__(self, ctx: NttContext, D: int, pipeline_chunks: int = 2):
        n, L = ctx.n, len(ctx.moduli)
        if n % D or D & (D - 1):
            raise ValueError("D must be a power of two dividing n")
        S = n // D
        if S < 2:
            raise ValueError("a shard must hold at least 2 coefficients")
        if pipeline_chunks < 1 or S % pipeline_chunks:
            raise ValueError("pipeline_chunks must divide the shard length")
        self.ctx = ctx
        self.D, self.S, self.n, self.L = D, S, n, L
        self.logD = D.bit_length() - 1
        self.pipeline_chunks = pipeline_chunks
        dev = ctx.device

        fwd_tw, fwd_sh = to_host(ctx.fwd_tw), to_host(ctx.fwd_tw_sh)
        inv_tw, inv_sh = to_host(ctx.inv_tw), to_host(ctx.inv_tw_sh)

        # cross-stage twiddles: stage s (m = 2^s < D) uses ONE twiddle per
        # shard, w[m + d // (D/m)]
        cross = np.zeros((4, D, self.logD, L), dtype=np.uint32)
        for s in range(self.logD):
            m = 1 << s
            for d in range(D):
                idx = m + d // (D // m)
                for i, tab in enumerate((fwd_tw, fwd_sh, inv_tw, inv_sh)):
                    cross[i, d, s] = tab[:, idx]
        # local-stage tables: shard d's size-S stage loop reads the stage-m
        # block from global indices [m·(D+d), m·(D+d)+m), packed at [m, 2m)
        loc = np.zeros((4, D, L, S), dtype=np.uint32)
        m = 1
        while m < S:
            for d in range(D):
                g0 = m * (D + d)
                for i, tab in enumerate((fwd_tw, fwd_sh, inv_tw, inv_sh)):
                    loc[i, d, :, m:2 * m] = tab[:, g0:g0 + m]
            m *= 2

        self.cross_f, self.cross_fs, self.cross_i, self.cross_is = (
            as_residues(c, dev) for c in cross)          # [D, logD, L]
        self.loc_f, self.loc_fs, self.loc_i, self.loc_is = (
            as_residues(t, dev) for t in loc)            # [D, L, S]
        self.q = ctx.q                                   # [L]
        self.q_col = ctx.q_col                           # [L, 1]
        self.n_inv = ctx.n_inv.reshape(L, 1)
        # the local inverse stages run unscaled: a unit n⁻¹ and its
        # companion floor(2^32 / q)
        self.unit = as_residues(np.ones(L, dtype=np.uint32), dev)
        self.unit_sh = as_residues(
            np.asarray([shoup(1, q) for q in ctx.moduli], dtype=np.uint64),
            dev)
        self._bound: Dict[int, dict] = {}

    # ---------------------------------------------------------------- helpers
    def _pairs(self, t_sh: int):
        """Exchange pairing: shard d ↔ d XOR t_sh (block exchange)."""
        return [(d, d ^ t_sh) for d in range(self.D)]

    def bind(self, mesh: Mesh, axis: str = "coeff") -> dict:
        """The tables as this process's shards use them (cached per mesh):
        per cross stage the [.., L, 1] twiddle columns, and the local-stage
        operands of the kernels (q, tables, unit scale; under LocalComm
        flattened to D·L rows). Made before any capture: a CUDA graph may
        not copy from the host."""
        hit = self._bound.get(id(mesh))     # the entry holds its mesh
        if hit is not None:
            return hit
        if mesh.shape[axis] != self.D:
            raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                             f"shards, the tables {self.D}")
        L, S, D = self.L, self.S, self.D

        def cross(t, s):                       # [D, L, 1] or [L, 1]
            return mesh.shard_table(t[:, s, :, None].contiguous(), axis)

        d = mesh.axis_index(axis)
        b = {"mesh": mesh, "axis": axis,
             "cf": [cross(self.cross_f, s) for s in range(self.logD)],
             "ci": [cross(self.cross_i, s) for s in range(self.logD)],
             # stage s: is this shard the u side (lower half) of its pair
             "is_u": [(d % (2 * t_sh)) < t_sh for t_sh in
                      (D >> (s + 1) for s in range(self.logD))]}
        if mesh.is_local:
            b["q"] = self.q.repeat(D)
            for name in ("loc_f", "loc_fs", "loc_i", "loc_is"):
                b[name] = getattr(self, name).reshape(D * L, S)
            b["unit"], b["unit_sh"] = self.unit.repeat(D), \
                self.unit_sh.repeat(D)
        else:
            b["q"] = self.q
            for name in ("loc_f", "loc_fs", "loc_i", "loc_is"):
                b[name] = mesh.shard_table(getattr(self, name),
                                           axis).contiguous()
            b["unit"], b["unit_sh"] = self.unit, self.unit_sh
        for s in range(self.logD):
            mesh.prepare_permute(axis, self._pairs(D >> (s + 1)))
        self._bound[id(mesh)] = b
        return b

    def _flat(self, x, b):
        """[..., D, L, S] → [..., D·L, S] under LocalComm (one launch for
        every shard); a rank's [..., L, S] as it is."""
        return x.flatten(-3, -2) if b["mesh"].is_local else x

    def _exchange_stages(self, x, b, forward: bool):
        mesh, axis = b["mesh"], b["axis"]
        q = self.q_col
        nc = self.pipeline_chunks
        stages = range(self.logD) if forward else \
            range(self.logD - 1, -1, -1)
        for s in stages:
            t_sh = self.D >> (s + 1)
            w = (b["cf"] if forward else b["ci"])[s]
            is_u = b["is_u"][s]

            def combine(xc, pc):
                # u side: x + w·partner (fwd) / x + partner (inv); v side:
                # partner − w·x (fwd) / (partner − x)·w (inv)
                if isinstance(is_u, bool):        # one shard on this rank
                    if forward:
                        return (t64.add(xc, t64.mul(pc, w, q), q) if is_u
                                else t64.sub(pc, t64.mul(xc, w, q), q))
                    return (t64.add(xc, pc, q) if is_u
                            else t64.mul(t64.sub(pc, xc, q), w, q))
                if forward:
                    wv = t64.mul(torch.where(is_u, pc, xc), w, q)
                    return torch.where(is_u, t64.add(xc, wv, q),
                                       t64.sub(pc, wv, q))
                return torch.where(is_u, t64.add(xc, pc, q),
                                   t64.mul(t64.sub(pc, xc, q), w, q))

            chunks = x.chunk(nc, dim=-1) if nc > 1 else (x,)
            # start every chunk's exchange before any combine
            waits = [mesh.ppermute_start(c, axis, self._pairs(t_sh))
                     for c in chunks]
            parts = [combine(c, wait()) for c, wait in zip(chunks, waits)]
            x = torch.cat(parts, dim=-1) if nc > 1 else parts[0]
        return x

    # --------------------------------------------------------------- transforms
    def fwd_local(self, x: torch.Tensor, mesh: Mesh, axis: str = "coeff"
                  ) -> torch.Tensor:
        """Per-shard forward NTT: x is this process's coefficient blocks
        ([..., D, L, S] under LocalComm, [..., L, S] on a rank; mesh.scatter
        along dim=-1 gives them)."""
        b = self.bind(mesh, axis)
        x = self._exchange_stages(x, b, forward=True)
        y = ntt_fwd(self._flat(x, b).contiguous(), b["q"], b["loc_f"],
                    b["loc_fs"])
        return y.reshape(x.shape)

    def inv_local(self, x: torch.Tensor, mesh: Mesh, axis: str = "coeff"
                  ) -> torch.Tensor:
        """Per-shard inverse NTT (exact inverse of fwd_local)."""
        b = self.bind(mesh, axis)
        y = ntt_inv(self._flat(x, b).contiguous(), b["q"], b["loc_i"],
                    b["loc_is"], b["unit"], b["unit_sh"])
        x = self._exchange_stages(y.reshape(x.shape), b, forward=False)
        return t64.mul(x, self.n_inv, self.q_col)

    # ------------------------------------------------------------ mesh wrappers
    def make_fwd(self, mesh: Mesh, axis: str = "coeff"):
        """Forward NTT of whole [..., L, n] tensors with the coefficients
        sharded over `axis` on the way: scatter, fwd_local, gather. (The
        reference's extra_specs, the leading unsharded axes, need no
        argument here: any leading axes are batch axes.)"""
        self.bind(mesh, axis)
        return lambda x: mesh.gather(
            self.fwd_local(mesh.scatter(x, axis, dim=-1), mesh, axis),
            axis, dim=-1)

    def make_inv(self, mesh: Mesh, axis: str = "coeff"):
        self.bind(mesh, axis)
        return lambda x: mesh.gather(
            self.inv_local(mesh.scatter(x, axis, dim=-1), mesh, axis),
            axis, dim=-1)

    def make_negacyclic_mul(self, mesh: Mesh, axis: str = "coeff"):
        """Distributed full polynomial product in R_q: fwd ⊙ fwd → inv. The
        pointwise multiply is local to each shard."""
        self.bind(mesh, axis)

        def mul(a, b):
            fa = self.fwd_local(mesh.scatter(a, axis, dim=-1), mesh, axis)
            fb = self.fwd_local(mesh.scatter(b, axis, dim=-1), mesh, axis)
            prod = t64.mul(fa, fb, self.q_col)
            return mesh.gather(self.inv_local(prod, mesh, axis), axis, dim=-1)
        return mul

