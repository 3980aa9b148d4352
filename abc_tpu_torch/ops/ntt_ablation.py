"""NTT cost-attribution kernels (port of scripts/ntt_ablation.py's Pallas
kernels) and their plain torch versions.

`ablate_ntt(a, ctx, mode)` runs the forward NTT of `[..., L, n]` int32
residues with one class of work removed, chosen by `mode` (one of `MODES`),
with the ψ^brv tables of a crypto/ntt.NttContext. On a CUDA tensor that is
the shipping `ntt_fwd` kernel taken apart (csrc/ntt_ablation.cu on the
skeleton of csrc/ntt_passes.cuh, with ntt_fwd's launch geometry; `full` is
ntt_fwd itself). Every mode writes the words of the TPU kernel's mode,
canonical in [0, q):

    zero                            x
    masks_only                      (x + popcount(p)) mod q, p the position
    rolls_only                      the butterfly with w = 1 on every stage
    muls_only                       x·(1 + ψ^brv[m + p//(2t)]) on every stage
    rolls_sub                       the w = 1 butterfly on stages with
                                    t ≥ 128, x + 1 on the others
    rolls_lane                      the same with the stage sets swapped
    full, reformed, split0, splitk  the forward NTT

An unknown mode raises ValueError; the TPU script computes `full` for any
string it does not know.

`alu_chain(x, kind, iters)` chains `iters` u32 operations per word of an
`[L, R, 128]` int32 tensor whose words carry arbitrary u32 bits: kind "mac"
is x·c + d, kind "shoup" the lazy Shoup product x·w − umulhi(x, wsh)·q, both
in u32 wraparound with the TPU script's constants (`ALU_CONSTANTS`).

Routing follows ops/ntt_kernels.py: a CPU tensor goes to the plain version,
a CUDA tensor to the hand-written kernel of csrc/ntt_ablation.cu (built at
first use) or raises, any other device raises. `launches` counts kernel
launches of this module; they are kept out of `ntt_kernels.launches`.
"""

from __future__ import annotations

import torch

from abc_tpu_torch.ops.ntt_kernels import check_operands, fwd_ntt_plain

MODES = ("zero", "masks_only", "rolls_only", "muls_only", "full", "reformed",
         "rolls_sub", "rolls_lane", "split0", "splitk")
NTT_MODES = ("full", "reformed", "split0", "splitk")
ALU_KINDS = ("mac", "shoup")
# scripts/ntt_ablation.py:_alu_mac_kernel (c, d), _alu_shoup_kernel (w, wsh, q)
ALU_CONSTANTS = {"mac": (2654435761, 40503, 0),
                 "shoup": (536813569, 1073780736, 536903681)}
LANE_LOGT = 7          # rolls_sub exchanges on stages with t ≥ 2^7

launches = {"ablate_ntt": 0, "alu_chain": 0}

_M32 = 0xFFFFFFFF


def _exchanges(mode: str, logt: int) -> bool:
    if mode == "rolls_sub":
        return logt >= LANE_LOGT
    if mode == "rolls_lane":
        return logt < LANE_LOGT
    return mode == "rolls_only"


def ablate_ntt_plain(a: torch.Tensor, q: torch.Tensor, tw: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """The words of `mode` (see the module doc) with exact int64 arithmetic.
    a: [..., L, n] int32; q: [L]; tw: [L, n] forward ψ^brv table."""
    if mode in NTT_MODES:
        return fwd_ntt_plain(a, q, tw)
    if mode == "zero":
        return a.clone()
    n, L, batch = a.shape[-1], a.shape[-2], tuple(a.shape[:-2])
    logn = n.bit_length() - 1
    qc = q.reshape(L, 1).to(torch.int64)
    p = torch.arange(n, device=a.device)
    x = a.to(torch.int64)
    if mode == "masks_only":
        bits = sum((p >> k) & 1 for k in range(logn))
        return torch.remainder(x + bits, qc).to(torch.int32)
    tw64 = tw.to(torch.int64)
    for s in range(logn):
        logt = logn - 1 - s
        if mode == "muls_only":
            w = tw64[:, (1 << s) + (p >> (logt + 1))]              # [L, n]
            x = torch.remainder(x * (1 + w), qc)
        elif _exchanges(mode, logt):
            t = 1 << logt
            x = x.reshape(batch + (L, 1 << s, 2, t))
            u, v = x[..., 0, :], x[..., 1, :]
            qb = qc.reshape(L, 1, 1)
            x = torch.stack([torch.remainder(u + v, qb),
                             torch.remainder(u - v, qb)], dim=-2)
            x = x.reshape(a.shape)
        else:
            x = torch.remainder(x + 1, qc)
    return x.to(torch.int32)


def _mullo(a: torch.Tensor, b: int) -> torch.Tensor:
    """a·b mod 2^32 for int64 a in [0, 2^32) and an integer b < 2^32, by
    16-bit halves of a: no product exceeds 2^48."""
    return ((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b & _M32


def _umulhi(a: torch.Tensor, b: int) -> torch.Tensor:
    """⌊a·b / 2^32⌋ for int64 a in [0, 2^32) and an integer b < 2^32, by
    16-bit halves: every partial sum stays below 2^50."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a1 * b0 + a0 * b1
    return a1 * b1 + (((mid << 16) + a0 * b0) >> 32)


def alu_chain_plain(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """`iters` chained u32 operations per word (see the module doc), in
    int64 holding the u32 value; returns the int32 bits."""
    k0, k1, k2 = ALU_CONSTANTS[kind]
    v = x.to(torch.int64) & _M32
    for _ in range(iters):
        if kind == "mac":
            v = (_mullo(v, k0) + k1) & _M32
        else:
            v = (_mullo(v, k0) - _mullo(_umulhi(v, k1), k2)) & _M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _check(t: torch.Tensor, what: str):
    """Raise unless t is an int32 tensor on the CPU or a CUDA device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 tensors, got {t.dtype}")


def _raise_on(err: int, name: str, lib):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.abc_cuda_error_string(err).decode()}")


def ablate_ntt(a: torch.Tensor, ctx, mode: str) -> torch.Tensor:
    """The ablated forward NTT of [..., L, n] int32 residues with the tables
    of `ctx` (crypto/ntt.NttContext on a's device)."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of {MODES}")
    _check(a, "ablate_ntt")
    if a.device.type == "cpu":
        return ablate_ntt_plain(a, ctx.q, ctx.fwd_tw, mode)
    check_operands(a, ctx.q, {"tw": ctx.fwd_tw, "tw_sh": ctx.fwd_tw_sh})
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(a)
    n = a.shape[-1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.abc_ablate_ntt(a.data_ptr(), out.data_ptr(),
                                 ctx.q.data_ptr(), ctx.fwd_tw.data_ptr(),
                                 ctx.fwd_tw_sh.data_ptr(), a.numel() // n,
                                 a.shape[-2], n.bit_length() - 1,
                                 MODES.index(mode), stream)
    _raise_on(err, "ablate_ntt", lib)
    launches["ablate_ntt"] += 1
    return out


def alu_chain(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """`iters` chained u32 operations of `kind` per word of [L, R, 128]
    int32 x."""
    if kind not in ALU_KINDS:
        raise ValueError(f"unknown ALU chain {kind!r}; one of {ALU_KINDS}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    _check(x, "alu_chain")
    if x.device.type == "cpu":
        return alu_chain_plain(x, kind, iters)
    if x.dim() != 3 or x.shape[-1] != 128 or not x.is_contiguous():
        raise ValueError(f"alu_chain needs a contiguous [L, R, 128] tensor, "
                         f"got {tuple(x.shape)}")
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.abc_alu_chain(x.data_ptr(), out.data_ptr(), x.numel(),
                                ALU_KINDS.index(kind), *ALU_CONSTANTS[kind],
                                iters, stream)
    _raise_on(err, "alu_chain", lib)
    launches["alu_chain"] += 1
    return out
