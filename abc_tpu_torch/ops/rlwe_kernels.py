"""Key generation, encryption and decryption kernels (K5: the Threefry
uniform draw, the switching-key composition, the signed lift with the
encryption's adds, the BFV scale-and-round): launch wrappers of
csrc/rlwe.cu, their plain torch versions and the tables both read.

`rns_uniform`, `ksk_compose`, `rlwe_lift` and `bfv_dec_round` route
themselves, as keyswitch_kernels does: a CPU tensor goes to the plain
version (int64 torch with exact `%`, the chains crypto/prng.py, rlwe.py,
bfv.py and ckks.py ran before the kernels: the CPU route and the oracle of
the tests and of chip_smoke.py), any other to one launch of the kernel. The
kernels are built at first use; a failed build, a failed launch or an
operand the kernel does not take raises. `launches` counts kernel launches
per kernel and nothing else.

Key words are int32 tensors [..., 2] holding the bits of the uint32 pair
(k0, k1) of one Threefry stream (crypto/prng.derive_keys). Constant tables
of a Shoup product are int32 [..., R, 2]: the constant w < q_r and its
companion floor(w·2^32/q_r) (`shoup_pairs`); the plain versions read the
first word.

CPU torch has no add or shift on uint32, so the plain Threefry carries
32-bit words in int64 and masks them with 0xFFFFFFFF after every add and
shift.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from abc_tpu_torch.crypto.numthy import modinv
from abc_tpu_torch.crypto.prng import PARITY, ROTATIONS
from abc_tpu_torch.ops.modarith import as_residues, shoup, t64, to_host

launches = {"rns_uniform": 0, "ksk_compose": 0, "rlwe_lift": 0,
            "bfv_dec_round": 0}

_M32 = 0xFFFFFFFF
# words of one limb's record of the scale-and-round table (csrc/rlwe.cu)
DEC_REC = 5
# a coefficient whose fractional part lies closer than this many units of
# 2^-32 to 1/2 sends the ciphertext to the exact bigint path
DEC_MARGIN = 4096


# -------------------------------------------------------------------- tables

def shoup_pairs(col, moduli: Sequence[int], device) -> torch.Tensor:
    """[..., R, 1] constants below the R moduli (host integers or a tensor)
    → int32 [..., R, 2]: each constant and its Shoup companion."""
    w = np.asarray(to_host(col) if isinstance(col, torch.Tensor) else col,
                   dtype=np.uint64)
    q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
    comp = np.vectorize(lambda a, m: shoup(int(a), int(m)),
                        otypes=[np.uint64])(w, np.broadcast_to(q, w.shape))
    return as_residues(np.concatenate([w, comp], axis=-1), device)


class DecRound:
    """The BFV scale-and-round of one modulus chain to t: per data prime
    q_l, (q/q_l)^-1 mod q_l (`qinv`) and θ_l = t/q_l as the 64-bit
    fixed-point pair (f_hi, f_lo) = floor(θ_l·2^64) (exact: t is below
    every prime, so the integer CRT part vanishes), as columns for the plain
    version and packed (q, qinv, its companion, f_hi, f_lo) per limb for
    the kernel."""

    def __init__(self, qs: Sequence[int], t: int, device):
        qs = [int(q) for q in qs]
        q_big = 1
        for q in qs:
            q_big *= q
        qinv = [modinv((q_big // q) % q, q) for q in qs]
        theta = [(t << 64) // q for q in qs]
        self.t, self.L = int(t), len(qs)

        def col(values):
            return torch.tensor(values, dtype=torch.int64,
                                device=device).reshape(-1, 1)

        self.q = as_residues(np.asarray(qs, np.uint64).reshape(-1, 1),
                             device)
        self.qinv = as_residues(np.asarray(qinv, np.uint64).reshape(-1, 1),
                                device)
        self.f_hi, self.f_lo = col([f >> 32 for f in theta]), \
            col([f & _M32 for f in theta])
        self.words = as_residues(np.asarray(
            [w for q, qi, f in zip(qs, qinv, theta)
             for w in (q, qi, shoup(qi, q), f >> 32, f & _M32)],
            dtype=np.uint64), device)


# ----------------------------------------------------------- plain versions

def threefry2x32(k0, k1, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Threefry-2x32 block per counter element: (c0, c1) → (y0, y1).
    All operands are int64 tensors holding 32-bit words in [0, 2^32); the
    key words broadcast against the counters (one pair per digit row)."""
    def rotl(x, r):
        return ((x << r) & _M32) | (x >> (32 - r))

    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def rns_uniform_plain(keys, q, n: int) -> torch.Tensor:
    """keys [..., 2] → [..., R, n]: row r of stream (k0, k1) the 64-bit
    draws hi·2^32+lo at counters r·n .. r·n+n-1 reduced mod q_r (q [R, 1]).
    An unsigned 64-bit draw does not fit int64, so it is reduced through
    its base-2^16 digits w3..w0 and the residues of 2^16, 2^32, 2^48:
    w3·p48 + w2·p32 + w1·p16 + w0 < 2^48 is exact in int64."""
    R = q.shape[0]
    k = keys.to(torch.int64) & _M32
    ctr = torch.arange(R * n, dtype=torch.int64,
                       device=keys.device).reshape(R, n)
    hi, lo = threefry2x32(k[..., 0, None, None], k[..., 1, None, None], ctr,
                          torch.zeros_like(ctr))
    q64 = q.to(torch.int64)
    p16, p32, p48 = (torch.remainder(torch.full_like(q64, 1 << s), q64)
                     for s in (16, 32, 48))
    acc = (hi >> 16) * p48 + (hi & 0xFFFF) * p32 + (lo >> 16) * p16 \
        + (lo & 0xFFFF)
    return torch.remainder(acc, q64).to(torch.int32)


def _targets(s, q, target, perms):
    """[K, R, n]: per key s² (target -1) or s at perms[p] (target p)."""
    return torch.stack([t64.mul(s, s, q) if kind < 0 else
                        s.index_select(-1, perms[kind])
                        for kind in target.tolist()])


def ksk_compose_plain(keys, e, s, q, factors=None, target=None,
                      perms=None):
    """(b, a), each [K, A, R, n]: a = rns_uniform_plain(keys [K, A, 2]) and
    b = −(a·s) − e + f_i·target mod q ([R, 1]) from the NTT-form errors e
    [K, A, R, n] and secret s (its first R rows); without `factors` ([A, R,
    2] pairs of P·W_i) no target term (the public key)."""
    R, n = e.shape[-2:]
    a = rns_uniform_plain(keys, q, n)
    s = s[:R]
    b = t64.sub(t64.neg(t64.mul(a, s, q), q), e, q)
    if factors is not None:
        term = t64.mul(_targets(s, q, target, perms)[:, None],
                       factors[..., :1], q)
        b = t64.add(b, term, q)
    return b, a


def rlwe_lift_plain(v, q, base=None, msg=None, delta=None):
    """(base + lift(v) + msg) mod q: v [..., n] small signed int8 → [...,
    R, n] over q ([R, 1]); base [..., R, n] or None; msg None, or added to
    the even flattened rows 0, 2, 4, ... (c0 of each ciphertext of [B, 2,
    ...]): with delta ([R, 2] pairs) msg [rows/2, n] times delta_r, else
    msg [rows/2, R, n]."""
    out = torch.remainder(v.to(torch.int64)[..., None, :],
                          q.to(torch.int64)).to(torch.int32)
    if base is not None:
        out = t64.add(out, base, q)
    if msg is not None:
        R, n = out.shape[-2:]
        if delta is not None:
            msg = t64.mul(msg[..., None, :], delta[:, :1], q)
        flat = out.reshape(-1, R, n)
        flat[0::2] = t64.add(flat[0::2], msg.reshape(-1, R, n), q)
        out = flat.reshape(out.shape)
    return out


def bfv_dec_round_plain(v, tab: DecRound):
    """v [..., L, n] (c(s) mod q, coefficient domain) → (m [..., n] int32,
    flag): m = round(Σ_l y_l·θ_l) mod t with y_l = v_l·(q/q_l)^-1 mod q_l,
    the fractional parts of y_l·θ_l summed exactly in 2^-32 units; flag a
    bool tensor, true where a coefficient lies within DEC_MARGIN of the
    rounding boundary."""
    y = t64.mul(v, tab.qinv, tab.q).to(torch.int64)
    p_hi = y * tab.f_hi                        # < 2^62: exact in int64
    frac = ((p_hi & _M32) + ((y * tab.f_lo) >> 32)).sum(dim=-2)
    whole = (p_hi >> 32).sum(dim=-2) + (frac >> 32)
    frac = frac & _M32
    half = 1 << 31
    flag = ((frac - half).abs() < DEC_MARGIN).any()
    m = torch.remainder(whole + (frac >= half), tab.t)
    return m.to(torch.int32), flag


# ---------------------------------------------------------------- launching

def _operand(x, name, dims, dtype=torch.int32):
    """Rows of a CUDA operand of at least `dims` axes (every axis before
    the last `dims`, multiplied); raises unless the kernels take it:
    contiguous, 16-byte aligned (int8: 4-byte), n a power of two >= 4."""
    if x.device.type != "cuda":
        raise ValueError(f"rlwe kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"rlwe operand {name} must be {dtype}, got "
                        f"{x.dtype}")
    if x.dim() < dims:
        raise ValueError(f"rlwe operand {name} needs {dims} axes, got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n < 4 or n & (n - 1):
        raise ValueError(f"rlwe operand {name}: n must be a power of two "
                         f">= 4, got {n}")
    align = 4 if dtype == torch.int8 else 16
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"rlwe operand {name} must be contiguous and "
                         f"{align}-byte aligned, got strides {x.stride()} "
                         f"at {x.data_ptr():#x}")
    return x.numel() // int(np.prod(x.shape[-dims:], dtype=np.int64))


def _table(t, name, device, shape, dtype=torch.int32):
    if t is None or t.device != device or t.dtype != dtype or \
            not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"rlwe table {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got "
            f"{None if t is None else (t.dtype, tuple(t.shape), t.device)}")


def _keys(keys):
    """Streams of CUDA key words [..., 2]; raises unless contiguous int32."""
    if keys.device.type != "cuda":
        raise ValueError(f"rlwe kernels take CPU or CUDA tensors, got "
                         f"{keys.device}")
    if keys.dtype != torch.int32 or keys.dim() < 1 or \
            keys.shape[-1] != 2 or not keys.is_contiguous():
        raise ValueError(f"rlwe key words must be a contiguous int32 [..., "
                         f"2] tensor, got {keys.dtype} {tuple(keys.shape)}")
    return keys.numel() // 2


def _moduli(q, ratio, device):
    R = q.shape[0]
    _table(q, "q", device, (R, 1))
    _table(ratio, "ratio", device, (R,), torch.int64)
    return R


def _launch(name, device, call):
    from abc_tpu_torch.ops import _build
    _build.launch(launches, name, device, call)


def _ptr(t):
    return None if t is None else t.data_ptr()


def rns_uniform(keys, q, ratio, n: int) -> torch.Tensor:
    """Uniform residues [..., R, n] of the streams keys [..., 2] over the
    moduli q ([R, 1]; ratio [R] int64, modarith.ratio_table, read by the
    kernel only): row r at counters r·n .. r·n+n-1, the reference's
    uniform_rns_np words of each stream."""
    if keys.device.type == "cpu":
        return rns_uniform_plain(keys, q, n)
    rows = _keys(keys)
    R = _moduli(q, ratio, keys.device)
    if n < 4 or n & (n - 1):
        raise ValueError(f"rns_uniform: n must be a power of two >= 4, got "
                         f"{n}")
    out = torch.empty(tuple(keys.shape[:-1]) + (R, n), dtype=torch.int32,
                      device=keys.device)
    _launch("rns_uniform", keys.device, lambda lib, st: lib.abc_rns_uniform(
        keys.data_ptr(), out.data_ptr(), q.data_ptr(), ratio.data_ptr(),
        rows, R, n.bit_length() - 1, st))
    return out


def ksk_compose(keys, e, s, q, ratio, factors=None, target=None,
                perms=None):
    """(b, a), each [K, A, R, n]: the switching keys of K streams of A
    digits (keys [K, A, 2]) toward their target secrets, a drawn as
    rns_uniform draws it and b = −(a·s) − e + f_i·target mod q ([R, 1];
    ratio [R]): e [K, A, R, n] the NTT-form errors, s [R', n] (R' >= R,
    its first R rows read) the NTT-form secret; factors [A, R, 2] pairs of
    P·W_i mod q_r, target [K] int32 (-1: s², p >= 0: s at perms[p], perms
    [P, n] int64); without factors no target term (the public key)."""
    if keys.device.type == "cpu":
        return ksk_compose_plain(keys, e, s, q, factors, target, perms)
    dev = keys.device
    _keys(keys)
    _operand(e, "e", 2)
    _operand(s, "s", 2)
    R = _moduli(q, ratio, dev)
    K, A = keys.shape[0], keys.shape[1]
    n = e.shape[-1]
    if tuple(keys.shape) != (K, A, 2) or tuple(e.shape) != (K, A, R, n) or \
            s.dim() != 2 or s.shape[0] < R or s.shape[1] != n or \
            e.device != dev or s.device != dev:
        raise ValueError(f"ksk_compose: keys {tuple(keys.shape)}, e "
                         f"{tuple(e.shape)}, s {tuple(s.shape)} must be [K, "
                         f"A, 2], [K, A, {R}, n], [>= {R}, n] on {dev}")
    if factors is not None:
        _table(factors, "factors", dev, (A, R, 2))
        _table(target, "target", dev, (K,))
        if perms is not None:
            _table(perms, "perms", dev, (perms.shape[0], n), torch.int64)
    b = torch.empty((K, A, R, n), dtype=torch.int32, device=dev)
    a = torch.empty_like(b)
    _launch("ksk_compose", dev, lambda lib, st: lib.abc_ksk_compose(
        keys.data_ptr(), e.data_ptr(), s.data_ptr(), _ptr(factors),
        _ptr(target), _ptr(perms), q.data_ptr(), ratio.data_ptr(),
        b.data_ptr(), a.data_ptr(), K, A, R, n.bit_length() - 1, st))
    return b, a


def rlwe_lift(v, q, base=None, msg=None, delta=None):
    """(base + lift(v) + msg) mod q ([R, 1]) for v [..., n] small signed
    int8 → [..., R, n]: base [..., R, n] or None; msg None, or added to the
    even rows (v's leading axes flattened: c0 of each ciphertext of [B, 2,
    ...]): with delta ([R, 2] pairs) msg [rows/2, n] plaintext coefficients
    times delta_r, else msg [rows/2, R, n] residues."""
    if v.device.type == "cpu":
        return rlwe_lift_plain(v, q, base, msg, delta)
    dev = v.device
    rows = _operand(v, "v", 1, torch.int8)
    R, n = q.shape[0], v.shape[-1]
    _table(q, "q", dev, (R, 1))
    _indices("rlwe_lift", rows * R * n // 4, "output quads")
    shape = tuple(v.shape[:-1]) + (R, n)
    if base is not None:
        _operand(base, "base", 2)
        if tuple(base.shape) != shape or base.device != dev:
            raise ValueError(f"rlwe_lift: base {tuple(base.shape)} must be "
                             f"{shape} on {dev}")
    if msg is not None:
        _operand(msg, "msg", 1)
        want = (-(-rows // 2), n) if delta is not None else \
            (-(-rows // 2), R, n)
        if tuple(msg.reshape((-1,) + want[1:]).shape) != want or \
                msg.device != dev:
            raise ValueError(f"rlwe_lift: msg {tuple(msg.shape)} must hold "
                             f"{want} on {dev}")
        if delta is not None:
            _table(delta, "delta", dev, (R, 2))
    elif delta is not None:
        raise ValueError("rlwe_lift: delta without msg")
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    _launch("rlwe_lift", dev, lambda lib, st: lib.abc_rlwe_lift(
        v.data_ptr(), _ptr(base), _ptr(msg), _ptr(delta), q.data_ptr(),
        out.data_ptr(), rows, R, n.bit_length() - 1, st))
    return out


def bfv_dec_round(v, tab: DecRound):
    """v [..., L, n] → (m [..., n] int32, flag): bfv_dec_round_plain's
    words; on the card the flag is an int32 tensor of the call's own, a
    word for each block of its launch (flag_words), some word 1 iff a
    coefficient lies within DEC_MARGIN of the rounding boundary, every word
    written by the one launch of the call (no memset). `flag.any()` reads
    it on either route."""
    if v.device.type == "cpu":
        return bfv_dec_round_plain(v, tab)
    dev = v.device
    _operand(v, "v", 2)
    L, n = v.shape[-2:]
    if L != tab.L:
        raise ValueError(f"bfv_dec_round: v has {L} limbs, the table "
                         f"{tab.L}")
    _table(tab.words, "dec_round", dev, (L * DEC_REC,))
    rows = v.numel() // (L * n)
    _indices("bfv_dec_round", rows * n, "coefficients")
    m = torch.empty(tuple(v.shape[:-2]) + (n,), dtype=torch.int32,
                    device=dev)
    flag = torch.empty(flag_words(rows * n), dtype=torch.int32, device=dev)
    _launch("bfv_dec_round", dev, lambda lib, st: lib.abc_bfv_dec_round(
        v.data_ptr(), tab.words.data_ptr(), m.data_ptr(), flag.data_ptr(),
        flag.numel(), rows, L, tab.t, n.bit_length() - 1, st))
    return m, flag


def flag_words(coeffs: int) -> int:
    """Words of bfv_dec_round's flag for `coeffs` coefficients: its
    launch's blocks, 64 coefficients each (128 threads, 8 lanes a quad)."""
    return -(-coeffs // 64)


def _indices(name, count, what):
    """Raises unless `count` fits the kernels' 32-bit indices."""
    if count >= 1 << 31:
        raise ValueError(f"{name}: {count} {what} pass the kernel's 32-bit "
                         f"indices (< 2^31)")


# abc_rlwe_plan's kernel numbers
_INFO_KERNEL = {"rns_uniform": 0, "ksk_compose": 1, "rlwe_lift": 2,
                "bfv_dec_round": 3}


def launch_info(name: str, rows: int, R: int, n: int) -> dict:
    """The launch a kernel makes for `rows` rows of R limbs of n (the
    output rows flattened for rns_uniform and ksk_compose; v's rows and the
    limbs lifted to for rlwe_lift; v's rows and L for bfv_dec_round) with
    its theoretical occupancy on the current card: arg0 and arg1 (rlwe_lift:
    limb rows a thread and groups of them a source row; else 0), threads a
    block, blocks, blocks and warps an SM."""
    import ctypes
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    info = (ctypes.c_longlong * 6)()
    err = lib.abc_rlwe_plan(_INFO_KERNEL[name], rows, R, n.bit_length() - 1,
                            info)
    if err != 0:
        raise RuntimeError(f"abc_rlwe_plan({name}): "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm"), info))
