"""Mesh kernels (K8: the distributed NTT's exchange combine and the modular
psum over a shard axis): launch wrappers of csrc/mesh.cu and their plain
torch versions.

`dist_ntt_combine` and `rns_psum_mod` route themselves, as
elementwise_kernels does: a CPU tensor goes to the plain version (the t64
chains parallel/dist_ntt.py and parallel/mesh.py ran before the kernels:
the CPU route and the oracle of the tests and of chip_smoke.py), a CUDA
tensor to one launch of the kernel, and any other device raises. The
kernel is built at first use; a failed build, a failed launch or an
operand the kernel does not take raises. `launches` counts kernel launches
per kernel and nothing else.

Operands are read and written where they lie: [..., D, L, C] with the
leading axes collapsing to one stride, the coefficients consecutive, every
row 16-byte aligned and a multiple of 4 words from the next (mesh.scatter's
views, a chunk of a shard's columns, a shard axis moved behind the rows).
The kernels split their indices in 32 bits: an operand of 2^31 quads or
more (x's for a combine, the output's for a psum) is refused.
`launch_info` reads a launch's plan (pairs a thread, shards unrolled) from
the library without launching.
"""

from __future__ import annotations

import numpy as np
import torch

from abc_tpu_torch.ops.modarith import in_chain, t64

launches = {"dist_ntt_combine": 0, "rns_psum_mod": 0}
# abc_mesh_plan's kernel kinds
_PLAN_KIND = {"combine": 0, "combine_rank": 1, "psum": 2, "psum_wide": 3}
# the kernels index quads in 32 bits
INDEX_LIMIT = 1 << 31


# ---------------------------------------------------------- plain versions

def combine_plain(x, w, q, t_sh, forward, partner=None, d0=0, u=None):
    """One exchange stage's butterfly combine, the t64 chain: on the u side
    (bit t_sh of the shard's position clear) x + w·partner (forward) or
    x + partner (inverse, times u where given); on the v side
    partner − w·x or (partner − x)·w. partner None: x holds every shard
    of the axis ([..., D, L, C], w [D, L, 1]) and shard d's partner is
    shard d ^ t_sh (the LocalComm exchange, d0 = 0); else x is one shard at
    position d0 ([..., L, C], w [L, 1]) and `partner` its partner's
    block."""
    if partner is None:
        pos = torch.arange(x.shape[-3], device=x.device)
        partner = x.index_select(-3, pos.bitwise_xor(t_sh))
        is_u = (pos.bitwise_and(t_sh) == 0).reshape(-1, 1, 1)
    else:
        is_u = (d0 & t_sh) == 0
    if isinstance(is_u, bool):                # one shard on this rank
        if forward:
            return (t64.add(x, t64.mul(partner, w, q), q) if is_u
                    else t64.sub(partner, t64.mul(x, w, q), q))
        if is_u:
            s = t64.add(x, partner, q)
            return s if u is None else t64.mul(s, u, q)
        return t64.mul(t64.sub(partner, x, q), w, q)
    if forward:
        wv = t64.mul(torch.where(is_u, partner, x), w, q)
        return torch.where(is_u, t64.add(x, wv, q), t64.sub(partner, wv, q))
    s = t64.add(x, partner, q)
    if u is not None:
        s = t64.mul(s, u, q)
    return torch.where(is_u, s, t64.mul(t64.sub(partner, x, q), w, q))


def psum_plain(x, q):
    """Σ over the shard axis (dim -3) of int32 residues x mod q (q a column
    broadcasting against x's last two dims); int64 words x (the sums an
    all_reduce made, in [0, 2^63): there the kernel's reduction of the
    words as uint64 and torch.remainder agree) reduced mod q."""
    if x.dtype == torch.int64:
        return torch.remainder(x, q.to(torch.int64)).to(torch.int32)
    return t64.sum_mod(x, q, dim=-3)


# ---------------------------------------------------------------- launching

def _view(x, name, lead, shards):
    """(rows, row, shard, limb strides in words) of x read as [rows, D, L,
    C] (`lead` leading axes, then the shard axis where `shards`); raises
    unless the kernel takes x."""
    if x.stride(-1) != 1:
        raise ValueError(f"mesh kernel operand {name}: its coefficients "
                         f"must be consecutive, got strides {x.stride()}")
    axes = [(x.shape[i], x.stride(i)) for i in range(lead) if x.shape[i] != 1]
    if any(outer != inner * size for (_, outer), (size, inner) in
           zip(axes, axes[1:])):
        raise ValueError(f"mesh kernel operand {name}: its leading axes must "
                         f"collapse to one stride, got strides {x.stride()} "
                         f"of {tuple(x.shape)}")
    rows = int(np.prod(x.shape[:lead], dtype=np.int64))
    row = axes[-1][1] if axes else 0
    shard = x.stride(-3) if shards else 0
    limb = x.stride(-2)
    if x.data_ptr() % 16 or row % 4 or shard % 4 or limb % 4:
        raise ValueError(f"mesh kernel operand {name} must be 16-byte "
                         f"aligned with rows, shards and limbs whole quads "
                         f"apart, at {x.data_ptr():#x}, strides {x.stride()}")
    return rows, row, shard, limb


def _table(t, name, device, words, dtype=torch.int32):
    if t is None or t.device != device or t.dtype != dtype or \
            not t.is_contiguous() or t.numel() != words:
        raise ValueError(
            f"mesh kernel table {name} must be a contiguous {dtype} tensor "
            f"of {words} words on {device}, got "
            f"{None if t is None else (t.dtype, tuple(t.shape), t.device)}")


def _cols(C, what):
    if C < 4 or C & (C - 1):
        raise ValueError(f"{what}: the kernel takes shards of a power of two "
                         f">= 4 coefficients, got {C}")
    return C.bit_length() - 1


def _indexed(words, what):
    """Raises unless `words` words are fewer than 2^31 quads."""
    if words // 4 >= INDEX_LIMIT:
        raise ValueError(f"{what}: {words // 4} quads, the kernel indexes "
                         f"fewer than 2^31")


def launch_info(kind: str, rows: int, D: int, L: int, C: int) -> dict:
    """The launch a mesh kernel makes for `rows` rows of [D, L, C] (kind
    "combine": the LocalComm combine over D shards; "combine_rank": a
    rank's, D = 1; "psum": the sum of D shards' residues; "psum_wide": the
    rank form, D = 1) with its theoretical occupancy on the current card:
    arg0 (the combine's butterfly pairs a thread, else 1), arg1 (the
    psum's shards a thread loads before its first add, 0 for chunks of 8;
    else 0), threads a block, blocks, blocks and warps an SM."""
    import ctypes
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    info = (ctypes.c_longlong * 6)()
    err = lib.abc_mesh_plan(_PLAN_KIND[kind], rows, D, L,
                            _cols(C, "launch_info"), info)
    if err != 0:
        raise RuntimeError(f"abc_mesh_plan({kind}): "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm"), info))


def combine_args(x, w, wsh, q, t_sh, forward, partner=None, d0=0,
                 u=None, out=None):
    """(output, a function of the output tensor giving
    abc_dist_ntt_combine's arguments but the stream) of one call; raises
    unless the kernel takes its operands. The host build of the tests calls
    the source with them."""
    dev = x.device
    local = partner is None
    if x.dtype != torch.int32 or x.dim() < (3 if local else 2):
        raise ValueError(f"dist_ntt_combine: x must be int32 [..., "
                         f"{'D, ' if local else ''}L, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    D = x.shape[-3] if local else 1
    L, C = x.shape[-2], x.shape[-1]
    logc = _cols(C, "dist_ntt_combine")
    _indexed(x.numel(), "dist_ntt_combine")
    if local and D % (2 * t_sh):
        raise ValueError(f"dist_ntt_combine: {D} shards do not split into "
                         f"pairs d, d ^ {t_sh}")
    lead = x.dim() - (3 if local else 2)
    if not local and (partner.shape != x.shape or partner.device != dev or
                      partner.dtype != torch.int32):
        raise ValueError(f"dist_ntt_combine: the partner block "
                         f"{tuple(partner.shape)} must be int32 like x "
                         f"{tuple(x.shape)} on {dev}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    elif out.shape != x.shape or out.device != dev or \
            out.dtype != torch.int32:
        raise ValueError(f"dist_ntt_combine: out {tuple(out.shape)} must be "
                         f"int32 like x {tuple(x.shape)} on {dev}")
    vx = _view(x, "x", lead, local)
    vp = vx if local else _view(partner, "partner", lead, False)
    vo = _view(out, "out", lead, local)
    _table(w, "w", dev, D * L)
    _table(wsh, "wsh", dev, D * L)
    _table(q, "q", dev, L)
    if u is not None:
        if forward:
            raise ValueError("dist_ntt_combine: only the inverse scales its "
                             "u side")
        for name, t in zip(("u", "ush"), u):
            _table(t, name, dev, L)
    p = x if local else partner
    return out, lambda o: (
        int(not forward), x.data_ptr(), *vx[1:], p.data_ptr(), *vp[1:],
        t_sh if local else 0, o.data_ptr(), *vo[1:], w.data_ptr(),
        wsh.data_ptr(), L if local else 0,
        None if u is None else u[0].data_ptr(),
        None if u is None else u[1].data_ptr(), q.data_ptr(), vx[0], D, L,
        d0, t_sh, logc)


@in_chain("dist_ntt_combine")
def dist_ntt_combine(x, tw, q, t_sh, forward, partner=None, d0=0, u=None,
                     out=None):
    """One exchange stage of the distributed NTT, over the pairs d ↔
    d ^ t_sh of the mesh axis (combine_plain): x [..., D, L, C] every shard
    of the axis, the partner read in place at shard d ^ t_sh (LocalComm,
    partner None), or one shard at position d0 ([..., L, C]) with the
    block it received (`partner`). tw = (w, wsh): the twiddle column per
    shard ([D, L, 1] / [L, 1]) and its Shoup companion (read by the kernel
    only); q [L, 1]; u = (n⁻¹, companion) [L, 1] multiplies the inverse's
    u side (its last stage). On the card the result goes to `out` where
    given (a view of x's shape, written at its strides), else to a new
    tensor; on the CPU `out` is filled by a copy."""
    w, wsh = tw
    if x.device.type == "cpu":
        r = combine_plain(x, w, q, t_sh, forward, partner, d0,
                          None if u is None else u[0])
        return r if out is None else out.copy_(r)
    if x.device.type != "cuda":
        raise ValueError(f"mesh kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    res, args = combine_args(x, w, wsh, q, t_sh, forward, partner, d0, u,
                             out)
    from abc_tpu_torch.ops import _build
    _build.launch(launches, "dist_ntt_combine", x.device,
                  lambda lib, s: lib.abc_dist_ntt_combine(*args(res), s))
    return res


def psum_args(x, q, out=None, ratio=None):
    """(output, a function of the output tensor giving abc_rns_psum_mod's
    arguments but the stream) of one call; raises unless the kernel takes
    its operands (int64 words need `ratio`). The host build of the tests
    calls the source with them."""
    dev = x.device
    wide = x.dtype == torch.int64
    if x.dtype not in (torch.int32, torch.int64) or \
            x.dim() < (2 if wide else 3):
        raise ValueError(f"rns_psum_mod: x must be int32 [..., D, L, n] or "
                         f"int64 [..., L, n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    shape = tuple(x.shape) if wide else tuple(x.shape[:-3]) + \
        tuple(x.shape[-2:])
    L, n = shape[-2], shape[-1]
    logn = _cols(n, "rns_psum_mod")
    _indexed(int(np.prod(shape, dtype=np.int64)), "rns_psum_mod")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    elif tuple(out.shape) != shape or out.device != dev or \
            out.dtype != torch.int32:
        raise ValueError(f"rns_psum_mod: out {tuple(out.shape)} must be "
                         f"int32 {shape} on {dev}")
    lead = x.dim() - (2 if wide else 3)
    vx = _view(x, "x", lead, not wide)
    vo = _view(out, "out", lead, False)
    _table(q, "q", dev, L)
    if wide:
        _table(ratio, "ratio", dev, L, torch.int64)
    return out, lambda o: (int(wide), x.data_ptr(), *vx[1:], o.data_ptr(),
                           vo[1], vo[3], q.data_ptr(),
                           ratio.data_ptr() if wide else None, vx[0],
                           1 if wide else x.shape[-3], L, logn)


@in_chain("psum_mod")
def rns_psum_mod(x, q, out=None, ratio=None):
    """Σ over the shard axis of residues x [..., D, L, n] (int32) mod q,
    [..., L, n]; or int64 words x [..., L, n], the sums an all_reduce made,
    reduced mod q (q [L, 1]; on the card `ratio`, q's [L] floor(2^64 / q)
    words as NttContext.ratio holds them, is required). The words must lie
    in [0, 2^63), as sums of residues do: there the kernel, which reduces
    them as uint64 by the ratio, and psum_plain (torch.remainder) agree.
    Into `out` where given (a view, written at its strides on the card;
    filled by a copy on the CPU)."""
    if x.device.type == "cpu":
        r = psum_plain(x, q)
        return r if out is None else out.copy_(r)
    if x.device.type != "cuda":
        raise ValueError(f"mesh kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    res, args = psum_args(x, q, out, ratio)
    from abc_tpu_torch.ops import _build
    _build.launch(launches, "rns_psum_mod", x.device,
                  lambda lib, s: lib.abc_rns_psum_mod(*args(res), s))
    return res
