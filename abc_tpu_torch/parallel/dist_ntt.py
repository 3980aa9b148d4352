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
exchange stages, the last of which also scales by n⁻¹ (its u side times
n⁻¹, its v side's twiddle w·n⁻¹ mod q, made in __init__: the words of a
scale after it, residues being canonical). With D = 1 there is no exchange
stage and ntt_inv scales by n⁻¹ itself.

An exchange stage's combine is one launch of the mesh kernel
(ops/mesh_kernels.py: dist_ntt_combine; its plain version on the CPU).
Under LocalComm the kernel takes a butterfly pair d, d XOR t_sh a thread,
both shards read in place: the exchange is its addressing, one launch
takes every shard, and the pair's one twiddle (both shards' tables hold
it, checked in __init__) makes one product for both outputs. Under
DistComm the partner is the block a batch_isend_irecv received.

Exchange pipelining: an exchange stage's butterfly is elementwise over the
local [L, S] block, so the block splits into `pipeline_chunks` independent
(exchange → combine) chains per stage; every chunk's exchange is started
before any combine, so that under DistComm the combine of one chunk can
overlap the transfer of the next (each chunk's combine writes its columns
of the stage's output in place). Under LocalComm one launch covers every
chunk, and the mesh's census counts the chunks' exchanges as the
reference's schedule makes them. nc=1 is the sequential schedule. The
words do not depend on it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops import elementwise_kernels as ew
from abc_tpu_torch.ops import mesh_kernels as mk
from abc_tpu_torch.ops.modarith import as_residues, shoup, to_host
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
            # the pair d, d ^ t_sh (t_sh = D / 2m < D / m) shares d // (D/m),
            # so its twiddle: the LocalComm combine reads it once a pair
            pos = np.arange(D)
            if not np.array_equal(cross[:, pos, s],
                                  cross[:, pos ^ (D >> (s + 1)), s]):
                raise AssertionError(f"stage {s}: a butterfly pair's shards "
                                     f"hold different twiddles")
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
        # the last inverse stage's twiddles with n⁻¹ folded in: w·n⁻¹ mod q
        # and its companion, [D, 1, L] (stage 0 of the cross layout)
        n_inv = to_host(ctx.n_inv).astype(np.uint64)
        qs = np.asarray(ctx.moduli, dtype=np.uint64)
        w_n = cross[2][:, :1].astype(np.uint64) * n_inv % qs
        self.cross_in = as_residues(w_n, dev)
        self.cross_ins = as_residues(
            [[[shoup(int(v), int(m)) for v, m in zip(row, qs)]
              for row in d] for d in w_n], dev)
        # the local inverse stages run unscaled where an exchange stage
        # scales after them (a unit n⁻¹ and its companion floor(2^32 / q));
        # with D = 1, ntt_inv scales by n⁻¹ itself
        self.unit = as_residues(np.ones(L, dtype=np.uint32), dev)
        self.unit_sh = as_residues(
            np.asarray([shoup(1, q) for q in ctx.moduli], dtype=np.uint64),
            dev)
        self.scale = (self.unit, self.unit_sh) if self.logD else \
            (ctx.n_inv, ctx.n_inv_sh)
        self._bound: Dict[int, dict] = {}

    # ---------------------------------------------------------------- helpers
    def _pairs(self, t_sh: int):
        """Exchange pairing: shard d ↔ d XOR t_sh (block exchange)."""
        return [(d, d ^ t_sh) for d in range(self.D)]

    def bind(self, mesh: Mesh, axis: str = "coeff") -> dict:
        """The tables as this process's shards use them (cached per mesh):
        per cross stage the twiddle columns and their companions ([D, L, 1]
        or a rank's [L, 1]; the inverse's stage 0 with n⁻¹ folded in) and
        n⁻¹ for that stage's u side; the shard's position on the axis (0:
        under LocalComm the kernels read every shard); and the operands of
        the local stages' kernels (q, tables, the inverse's scale; under
        LocalComm flattened to D·L rows), with q as a column and its ratio
        words for the elementwise kernels over the same rows. Made before
        any capture: a CUDA graph may not copy from the host."""
        hit = self._bound.get(id(mesh))     # the entry holds its mesh
        if hit is not None:
            return hit
        if mesh.shape[axis] != self.D:
            raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                             f"shards, the tables {self.D}")
        L, S, D = self.L, self.S, self.D

        def cross(t, s):                       # [D, L, 1] or [L, 1]
            return mesh.shard_table(t[:, s, :, None].contiguous(), axis)

        inv = [(cross(self.cross_i, s), cross(self.cross_is, s))
               for s in range(self.logD)]
        if self.logD:
            inv[0] = (cross(self.cross_in, 0), cross(self.cross_ins, 0))
        b = {"mesh": mesh, "axis": axis,
             "fwd": [(cross(self.cross_f, s), cross(self.cross_fs, s))
                     for s in range(self.logD)],
             "inv": inv,
             "n_inv": (self.ctx.n_inv.reshape(L, 1).contiguous(),
                       self.ctx.n_inv_sh.reshape(L, 1).contiguous()),
             "d0": 0 if mesh.is_local else mesh.axis_index(axis)}
        tile = D if mesh.is_local else 1
        b["q"] = self.q.repeat(tile)
        b["q_col"] = b["q"].reshape(-1, 1)
        b["ratio"] = self.ctx.ratio.repeat(tile)
        b["unit"], b["unit_sh"] = self.unit.repeat(tile), \
            self.unit_sh.repeat(tile)
        b["scale"] = tuple(t.repeat(tile) for t in self.scale)
        for name in ("loc_f", "loc_fs", "loc_i", "loc_is"):
            t = getattr(self, name)
            b[name] = t.reshape(D * L, S) if mesh.is_local else \
                mesh.shard_table(t, axis).contiguous()
        self._bound[id(mesh)] = b
        return b

    def _flat(self, x, b):
        """[..., D, L, S] → [..., D·L, S] under LocalComm (one launch for
        every shard); a rank's [..., L, S] as it is."""
        return x.flatten(-3, -2) if b["mesh"].is_local else x

    def _exchange_stages(self, x, b, forward: bool, out=None):
        """The log2 D exchange stages, each one combine launch (a rank: one
        a chunk, every chunk's exchange started first); the last stage
        writes into `out` where given."""
        mesh, axis = b["mesh"], b["axis"]
        nc = self.pipeline_chunks
        stages = list(range(self.logD)) if forward else \
            list(range(self.logD - 1, -1, -1))
        for i, s in enumerate(stages):
            t_sh = self.D >> (s + 1)
            tw = (b["fwd"] if forward else b["inv"])[s]
            u = None if forward or s else b["n_inv"]
            dst = out if i == len(stages) - 1 else None
            if mesh.is_local:
                mesh.count_permutes(x, axis, nc)
                x = mk.dist_ntt_combine(x, tw, self.q_col, t_sh, forward,
                                        u=u, out=dst)
                continue
            res = torch.empty(x.shape, dtype=torch.int32, device=x.device) \
                if dst is None else dst
            chunks = x.chunk(nc, dim=-1) if nc > 1 else (x,)
            outs = res.chunk(nc, dim=-1) if nc > 1 else (res,)
            # start every chunk's exchange before any combine
            waits = [mesh.ppermute_start(c, axis, self._pairs(t_sh))
                     for c in chunks]
            for c, o, wait in zip(chunks, outs, waits):
                mk.dist_ntt_combine(c, tw, self.q_col, t_sh, forward,
                                    partner=wait(), d0=b["d0"], u=u, out=o)
            x = res
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

    def inv_local(self, x: torch.Tensor, mesh: Mesh, axis: str = "coeff",
                  out=None) -> torch.Tensor:
        """Per-shard inverse NTT (exact inverse of fwd_local); into `out`
        where given (a tensor of x's shape, written at its strides: a layout
        the caller reads next)."""
        b = self.bind(mesh, axis)
        y = ntt_inv(self._flat(x, b).contiguous(), b["q"], b["loc_i"],
                    b["loc_is"], *b["scale"]).reshape(x.shape)
        if not self.logD:
            return y if out is None else out.copy_(y)
        return self._exchange_stages(y, b, forward=False, out=out)

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
            prod = ew.mul(fa, fb, self.q_col, self.ctx.ratio)
            return mesh.gather(self.inv_local(prod, mesh, axis), axis, dim=-1)
        return mul

