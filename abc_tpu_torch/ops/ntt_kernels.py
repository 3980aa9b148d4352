"""Negacyclic NTT kernels (port of abc_tpu/ops/pallas_ntt.py) and their plain
torch versions.

`ntt_fwd` / `ntt_inv` transform `[..., L, n]` int32 residues along the last
axis with the ψ^brv twiddle tables of crypto/ntt.py. A tensor on the CPU
goes to the plain version (`fwd_ntt_plain` / `inv_ntt_plain`); a CUDA tensor
goes to the hand-written kernel of csrc/ntt.cu, built at first use, and any
build or launch failure raises. `launches` counts kernel launches per
kernel and nothing else.

The plain versions are a torch port of the reference stage loops
(abc_tpu/crypto/ntt.py:_fwd_stages/_inv_stages) with exact `(a·w) % q` in
int64 (products < 2^60): the reference's Shoup product relies on u32
wraparound and is not carried over. Both give the canonical words.
"""

from __future__ import annotations

import torch

launches = {"ntt_fwd": 0, "ntt_inv": 0}

MIN_N, MAX_N = 1024, 32768


def fwd_ntt_plain(a: torch.Tensor, q: torch.Tensor, tw: torch.Tensor
                  ) -> torch.Tensor:
    """Forward Cooley-Tukey NTT (natural → bit-reversed order).
    a: [..., L, n] int32; q: [L]; tw: [L, n] ψ^brv table."""
    n, L, batch = a.shape[-1], a.shape[-2], tuple(a.shape[:-2])
    qc = q.reshape(L, 1, 1).to(torch.int64)
    x = a.to(torch.int64)
    m = 1
    while m < n:
        t = n // (2 * m)
        x = x.reshape(batch + (L, m, 2, t))
        w = tw[:, m:2 * m].reshape(L, m, 1).to(torch.int64)
        u = x[..., 0, :]
        v = torch.remainder(x[..., 1, :] * w, qc)
        s = u + v
        d = u - v
        x = torch.stack([torch.where(s >= qc, s - qc, s),
                         torch.where(d < 0, d + qc, d)], dim=-2)
        m *= 2
    return x.reshape(a.shape).to(torch.int32)


def inv_ntt_plain(a: torch.Tensor, q: torch.Tensor, tw: torch.Tensor,
                  ninv: torch.Tensor) -> torch.Tensor:
    """Inverse Gentleman-Sande NTT (bit-reversed → natural order), scaled by
    n⁻¹. a: [..., L, n] int32; q, ninv: [L]; tw: [L, n] inverse ψ^brv."""
    n, L, batch = a.shape[-1], a.shape[-2], tuple(a.shape[:-2])
    qc = q.reshape(L, 1, 1).to(torch.int64)
    x = a.to(torch.int64)
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        x = x.reshape(batch + (L, m, 2, t))
        w = tw[:, m:2 * m].reshape(L, m, 1).to(torch.int64)
        u = x[..., 0, :]
        v = x[..., 1, :]
        s = u + v
        d = u - v
        d = torch.where(d < 0, d + qc, d)
        x = torch.stack([torch.where(s >= qc, s - qc, s),
                         torch.remainder(d * w, qc)], dim=-2)
        m //= 2
    x = x.reshape(a.shape)
    out = torch.remainder(x * ninv.reshape(L, 1).to(torch.int64),
                          q.reshape(L, 1).to(torch.int64))
    return out.to(torch.int32)


def check_operands(a, q, tables):
    """Raise unless a CUDA tensor a and its int32 tables fit the NTT kernels
    (n a power of two in [MIN_N, MAX_N], contiguous, on a's device)."""
    if a.device.type != "cuda":
        raise ValueError(f"NTT kernels take CPU or CUDA tensors, got "
                         f"{a.device}")
    n = a.shape[-1] if a.dim() >= 2 else 0
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"NTT kernel needs [..., L, n] with n a power of "
                         f"two in [{MIN_N}, {MAX_N}], got {tuple(a.shape)}")
    L = a.shape[-2]
    if not a.is_contiguous():
        raise ValueError("NTT kernel input must be contiguous")
    expect = {"q": (L,), "tw": (L, n), "tw_sh": (L, n), "ninv": (L,),
              "ninv_sh": (L,)}
    for name, t in [("a", a), ("q", q)] + list(tables.items()):
        if t.dtype != torch.int32:
            raise TypeError(f"NTT kernel operand {name} must be int32, got "
                            f"{t.dtype}")
        if t.device != a.device:
            raise ValueError(f"NTT kernel operand {name} is on {t.device}, "
                             f"input on {a.device}")
        if name != "a" and (tuple(t.shape) != expect[name]
                            or not t.is_contiguous()):
            raise ValueError(f"NTT table {name} must be contiguous "
                             f"{expect[name]} for L={L}, got "
                             f"{tuple(t.shape)}")


def _launch(name, a, args):
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(a)
    rows = a.numel() // a.shape[-1]
    logn = a.shape[-1].bit_length() - 1
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        fn = lib.abc_ntt_fwd if name == "ntt_fwd" else lib.abc_ntt_inv
        err = fn(a.data_ptr(), out.data_ptr(),
                 *[t.data_ptr() for t in args], rows, a.shape[-2], logn,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    launches[name] += 1
    return out


def ntt_fwd(a: torch.Tensor, q: torch.Tensor, tw: torch.Tensor,
            tw_sh: torch.Tensor) -> torch.Tensor:
    """Forward NTT of [..., L, n] int32 residues (tables as in
    crypto/ntt.NttContext: q [L], tw/tw_sh [L, n])."""
    if a.device.type == "cpu":
        return fwd_ntt_plain(a, q, tw)
    check_operands(a, q, {"tw": tw, "tw_sh": tw_sh})
    return _launch("ntt_fwd", a, (q, tw, tw_sh))


def ntt_inv(a: torch.Tensor, q: torch.Tensor, tw: torch.Tensor,
            tw_sh: torch.Tensor, ninv: torch.Tensor, ninv_sh: torch.Tensor
            ) -> torch.Tensor:
    """Inverse NTT of [..., L, n] int32 residues, including the n⁻¹ scale."""
    if a.device.type == "cpu":
        return inv_ntt_plain(a, q, tw, ninv)
    check_operands(a, q, {"tw": tw, "tw_sh": tw_sh, "ninv": ninv,
                          "ninv_sh": ninv_sh})
    return _launch("ntt_inv", a, (q, tw, tw_sh, ninv, ninv_sh))
