"""BEHZ multiply kernels (K3: base extension, tensor product, fast floor,
Shenoy-Kumaresan): launch wrappers of csrc/behz.cu and the tables they read.

`behz_to_bsk`, `behz_fast_floor` and `behz_from_bsk` launch the conversion
kernels on CUDA tensors only: the plain versions are BehzContext's own
methods (crypto/behz.py), which routes a CPU tensor to them and any other to
these wrappers. `behz_tensor` routes itself: CPU tensors go to
`tensor_plain` (int64 torch with exact `%`), one base at a time; CUDA
tensors to one launch of the kernel over every base given (one or two).
The kernels are built at first use and any build or launch failure raises.
`launches` counts kernel launches per kernel and nothing else.

Each conversion reads one packed int32 table (`to_bsk_words`,
`fast_floor_words`, `from_bsk_words`: the layout of csrc/behz.cu,
"Tables"), made from the host bigints of the same constants the plain
versions read, so that the two give the same canonical words.
"""

from __future__ import annotations

import numpy as np
import torch

from abc_tpu_torch.ops.modarith import barrett_ratio, shoup, t64

launches = {"behz_to_bsk": 0, "behz_tensor": 0, "behz_fast_floor": 0,
            "behz_from_bsk": 0}

M_TILDE_BITS = 16
M_TILDE = 1 << M_TILDE_BITS
# the packed table's layout (csrc/behz.cu, "Tables")
HEADER, SRC_WORDS, DST_WORDS = 8, 4, 8


def tensor_plain(f1, f2, q):
    """(a0, a1) ⊗ (b0, b1) → (a0b0, a0b1 + a1b0, a1b1) mod q, pointwise:
    [..., 2, D, n] × [..., 2, D, n] → [..., 3, D, n]."""
    a0, a1 = f1[..., 0, :, :], f1[..., 1, :, :]
    b0, b1 = f2[..., 0, :, :], f2[..., 1, :, :]
    e0 = t64.mul(a0, b0, q)
    e1 = t64.add(t64.mul(a0, b1, q), t64.mul(a1, b0, q), q)
    e2 = t64.mul(a1, b1, q)
    return torch.stack([e0, e1, e2], dim=-3)


# -------------------------------------------------------------------- tables

def _ints(v):
    return [int(w) for w in np.asarray(v).reshape(-1)]


def _dst(q: int, *words) -> list:
    """A destination record: the modulus, its ratio (low, high word), the
    chain's own words, zero-padded to DST_WORDS."""
    r = barrett_ratio(q)
    rec = [q, r & 0xFFFFFFFF, r >> 32, *words]
    return rec + [0] * (DST_WORDS - len(rec))


def _pack(header, src, dst, conv) -> np.ndarray:
    header = list(header) + [0] * (HEADER - len(header))
    src = [list(rec) + [0] * (SRC_WORDS - len(rec)) for rec in src]
    words = header + [w for rec in src for w in rec] + \
        [w for rec in dst for w in rec] + _ints(conv)
    return np.asarray(words, dtype=np.uint64).astype(np.uint32)


def to_bsk_words(qs, bsk, mtilde_qhatinv_q, qhat_mtilde, neg_qinv_mtilde,
                 q_bsk, mtilde_inv_bsk, qhat_bsk) -> np.ndarray:
    """behz_to_bsk's table: header -q^-1 mod m~; per data prime q_i (m~ ·
    qhat_i^-1 mod q_i, its Shoup companion, qhat_i mod m~); per Bsk prime
    b_d (q mod b_d, m~^-1 mod b_d, its companion); T = qhat_i mod b_d."""
    qs, bsk = _ints(qs), _ints(bsk)
    src = [(q, w, shoup(w, q), m) for q, w, m in zip(
        qs, _ints(mtilde_qhatinv_q), _ints(qhat_mtilde))]
    dst = [_dst(b, qb, mi, shoup(mi, b)) for b, qb, mi in zip(
        bsk, _ints(q_bsk), _ints(mtilde_inv_bsk))]
    return _pack([int(neg_qinv_mtilde)], src, dst, qhat_bsk)


def fast_floor_words(qs, bsk, t_q, qhatinv_q, t_bsk, qinv_bsk,
                     qhat_bsk) -> np.ndarray:
    """behz_fast_floor's table: per data prime q_i (t · qhat_i^-1 mod q_i,
    its companion); per Bsk prime b_d (t mod b_d, q^-1 mod b_d, its
    companion); T = -qhat_i mod b_d, so that the kernel's sum with (t mod
    b_d)·e_bsk as one more term is t·e_bsk - conv."""
    qs, bsk = _ints(qs), _ints(bsk)
    src = [(q, c, shoup(c, q)) for q, c in zip(
        qs, [tq * hi % q for q, tq, hi in zip(qs, _ints(t_q),
                                               _ints(qhatinv_q))])]
    dst = [_dst(b, tb, qi, shoup(qi, b)) for b, tb, qi in zip(
        bsk, _ints(t_bsk), _ints(qinv_bsk))]
    neg = [[-v % b for v, b in zip(row, bsk)]
           for row in np.asarray(qhat_bsk, dtype=np.int64).tolist()]
    return _pack([], src, dst, neg)


def from_bsk_words(b_primes, m_sk, qs, bhatinv_b, bhat_msk, binv_msk,
                   B_q, msk_q, bhat_q) -> np.ndarray:
    """behz_from_bsk's table: header (m_sk, its ratio, B^-1 mod m_sk, its
    companion, m_sk >> 1); per B prime b_i (bhat_i^-1 mod b_i, its
    companion, bhat_i mod m_sk); per data prime q_j (B mod q_j, m_sk mod
    q_j); T = bhat_i mod q_j."""
    m_sk, binv = int(m_sk), int(binv_msk)
    src = [(b, bi, shoup(bi, b), bm) for b, bi, bm in zip(
        _ints(b_primes), _ints(bhatinv_b), _ints(bhat_msk))]
    dst = [_dst(q, bq, mq) for q, bq, mq in zip(_ints(qs), _ints(B_q),
                                                _ints(msk_q))]
    return _pack(_dst(m_sk, binv, shoup(binv, m_sk), m_sk >> 1), src, dst,
                 bhat_q)


# ---------------------------------------------------------------- launching

def _shape_of(x, name, limbs):
    """(rows, n) of a CUDA operand [..., limbs, n]; raises unless the kernel
    takes it."""
    if x.device.type != "cuda":
        raise ValueError(f"BEHZ kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"BEHZ operand {name} must be int32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != limbs:
        raise ValueError(f"BEHZ operand {name} must be [..., {limbs}, n], got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"BEHZ operand {name}: n must be a power of two, "
                         f"got {n}")
    if not x.is_contiguous():
        raise ValueError(f"BEHZ operand {name} must be contiguous")
    return x.numel() // (limbs * n), n


def _check_table(t, name, device, words, dtype=torch.int32):
    if t is None or t.device != device:
        raise ValueError(f"BEHZ table {name} is on "
                         f"{None if t is None else t.device}, data on "
                         f"{device}")
    if t.dtype != dtype or not t.is_contiguous() or t.numel() != words:
        raise ValueError(f"BEHZ table {name} must be a contiguous {dtype} "
                         f"tensor of {words} words, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _check_packed(tab, kind, device, K, D):
    if K < 1 or D < 1:
        raise ValueError(f"BEHZ kernel {kind}: {K} source and {D} "
                         "destination limbs")
    _check_table(tab, kind, device,
                 HEADER + SRC_WORDS * K + DST_WORDS * D + K * D)


def _check_quads(x, name, n):
    """Every BEHZ kernel reads and writes 4 coefficients with one 16-byte
    access (csrc/behz.cu)."""
    if n < 4 or x.data_ptr() % 16:
        raise ValueError(f"BEHZ operand {name}: the kernels take n >= 4 "
                         f"and 16-byte aligned rows, got n={n} at "
                         f"{x.data_ptr():#x}")


def _launch(name, device, call):
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = call(lib, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    launches[name] += 1


def behz_to_bsk(x: torch.Tensor, tab: torch.Tensor, D: int) -> torch.Tensor:
    """q → Bsk on the card: [..., K, n] → [..., D, n] (K = L data primes,
    D = L + 2), `tab` the packed `to_bsk_words` on x's device."""
    K = x.shape[-2] if x.dim() >= 2 else 0
    rows, n = _shape_of(x, "x", K)
    _check_quads(x, "x", n)
    _check_packed(tab, "to_bsk", x.device, K, D)
    out = torch.empty(tuple(x.shape[:-2]) + (D, n), dtype=torch.int32,
                      device=x.device)
    _launch("behz_to_bsk", x.device, lambda lib, s: lib.abc_behz_to_bsk(
        x.data_ptr(), out.data_ptr(), tab.data_ptr(), rows, K, D,
        n.bit_length() - 1, s))
    return out


def behz_fast_floor(e_q: torch.Tensor, e_bsk: torch.Tensor,
                    tab: torch.Tensor) -> torch.Tensor:
    """⌊t·e/q⌋ in Bsk on the card: [..., K, n] and [..., D, n] →
    [..., D, n] (K = L, D = L + 2), `tab` the packed `fast_floor_words`."""
    K = e_q.shape[-2] if e_q.dim() >= 2 else 0
    D = e_bsk.shape[-2] if e_bsk.dim() >= 2 else 0
    rows, n = _shape_of(e_q, "e_q", K)
    if _shape_of(e_bsk, "e_bsk", D) != (rows, n) or \
            e_bsk.shape[:-2] != e_q.shape[:-2] or e_bsk.device != e_q.device:
        raise ValueError(f"BEHZ fast floor: e_q {tuple(e_q.shape)} and e_bsk "
                         f"{tuple(e_bsk.shape)} must share their leading "
                         "axes, n and device")
    _check_quads(e_q, "e_q", n)
    _check_quads(e_bsk, "e_bsk", n)
    _check_packed(tab, "fast_floor", e_q.device, K, D)
    out = torch.empty_like(e_bsk)
    _launch("behz_fast_floor", e_q.device,
            lambda lib, s: lib.abc_behz_fast_floor(
                e_q.data_ptr(), e_bsk.data_ptr(), out.data_ptr(),
                tab.data_ptr(), rows, K, D, n.bit_length() - 1, s))
    return out


def behz_from_bsk(x_bsk: torch.Tensor, tab: torch.Tensor, D: int
                  ) -> torch.Tensor:
    """Bsk → q on the card: [..., K + 1, n] (the K = L + 1 B primes, then
    m_sk) → [..., D, n] (D = L), `tab` the packed `from_bsk_words`."""
    K = x_bsk.shape[-2] - 1 if x_bsk.dim() >= 2 else 0
    rows, n = _shape_of(x_bsk, "x_bsk", K + 1)
    _check_quads(x_bsk, "x_bsk", n)
    _check_packed(tab, "from_bsk", x_bsk.device, K, D)
    out = torch.empty(tuple(x_bsk.shape[:-2]) + (D, n), dtype=torch.int32,
                      device=x_bsk.device)
    _launch("behz_from_bsk", x_bsk.device,
            lambda lib, s: lib.abc_behz_from_bsk(
                x_bsk.data_ptr(), out.data_ptr(), tab.data_ptr(), rows, K, D,
                n.bit_length() - 1, s))
    return out


# abc_behz_launch_info's kernel numbers
_INFO_KERNEL = {"behz_to_bsk": 0, "behz_fast_floor": 1, "behz_from_bsk": 2,
                "behz_tensor": 3}


def launch_info(name: str, K: int, D: int, rows: int, n: int) -> dict:
    """The launch a kernel makes at K sources, D destinations (behz_tensor:
    two bases of K and D limbs) and rows of n, with its
    theoretical occupancy on the current
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor): template
    arguments, threads a block, blocks, blocks and warps an SM."""
    import ctypes
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    info = (ctypes.c_longlong * 6)()
    err = lib.abc_behz_launch_info(_INFO_KERNEL[name], K, D, rows,
                                   n.bit_length() - 1, info)
    if err != 0:
        raise RuntimeError(f"abc_behz_launch_info({name}): "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm"), info))


def _tensor_base(f1, f2, q, ratio, device):
    """(rows1, rows2, D, n, leading shape) of one base of behz_tensor on the
    card; raises unless the kernel takes it."""
    D = q.shape[0]
    if f1.dim() < 3 or f2.dim() < 3 or f1.shape[-3] != 2 or \
            f2.shape[-3] != 2:
        raise ValueError(f"BEHZ tensor takes [..., 2, D, n] operands, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    rows1, n = _shape_of(f1, "f1", D)
    rows2, n2 = _shape_of(f2, "f2", D)
    rows1, rows2 = rows1 // 2, rows2 // 2
    lead = torch.broadcast_shapes(f1.shape[:-3], f2.shape[:-3])
    rows = max(rows1, rows2)
    if n2 != n or f1.device != device or f2.device != device or \
            min(rows1, rows2) not in (1, rows) or \
            int(np.prod(lead, dtype=np.int64)) != rows:
        raise ValueError(f"BEHZ tensor: operands {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)} must match or one of them hold "
                         "a single row, on one device")
    _check_quads(f1, "f1", n)
    _check_quads(f2, "f2", n)
    _check_table(q, "q", device, D)
    _check_table(ratio, "ratio", device, D, torch.int64)
    return rows1, rows2, D, n, tuple(lead)


def behz_tensor(*bases) -> tuple:
    """The tensor product over each base (f1, f2, q, ratio) given, one or
    two: [..., 2, D, n] × [..., 2, D, n] → [..., 3, D, n] mod q ([D, 1]
    column); `ratio` ([D] int64, modarith.ratio_table) is read by the kernel
    only. The leading axes broadcast where one operand has a single row. On
    the card every base goes through one launch, of the same n."""
    if not 1 <= len(bases) <= 2:
        raise ValueError(f"BEHZ tensor takes one or two bases, got "
                         f"{len(bases)}")
    if bases[0][0].device.type == "cpu":
        return tuple(tensor_plain(f1, f2, q) for f1, f2, q, _ in bases)
    device = bases[0][0].device
    shapes = [_tensor_base(*b, device) for b in bases]
    if len({s[3] for s in shapes}) != 1:
        raise ValueError("BEHZ tensor: the bases of one launch must share n")
    outs = tuple(torch.empty(lead + (3, D, n), dtype=torch.int32,
                             device=device)
                 for _, _, D, n, lead in shapes)
    args = []
    for (f1, f2, q, ratio), out, (rows1, rows2, D, _, _) in zip(
            bases, outs, shapes):
        args += [f1.data_ptr(), f2.data_ptr(), out.data_ptr(), q.data_ptr(),
                 ratio.data_ptr(), rows1, rows2, D]
    if len(bases) == 1:
        args += [None] * 5 + [0, 0, 0]
    n = shapes[0][3]
    _launch("behz_tensor", device, lambda lib, s: lib.abc_behz_tensor_bases(
        *args, n.bit_length() - 1, s))
    return outs
