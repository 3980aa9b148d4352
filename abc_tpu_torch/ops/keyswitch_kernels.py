"""Key-switching and rescaling kernels (K4: the digit lift, the contraction
with a switching key, the exact division by primes): launch wrappers of
csrc/keyswitch.cu, their plain torch versions and the tables both read.

`decompose`, `contract` and `mod_down` route themselves, as
behz_kernels.behz_tensor does (`mod_down` with a `Tail`, K9a, finishes the
ciphertext of a relinearization or a rotation in the same launch): a CPU
tensor goes to the plain version (int64 torch with exact `%`, the chains
BfvContext and CkksContext ran before the kernels: the CPU route and the
oracle of the tests and of chip_smoke.py), any other to one launch of the
kernel. The kernels are built at first use;
a failed build, a failed launch or an operand the kernel does not take
raises. `launches` counts kernel launches per kernel and nothing else.

The tables are made once per context (CKKS: per level) from host integers,
as `Digits` and `Division`; each holds the plain version's columns and the
kernel's packed uint32 words (the layouts of csrc/keyswitch.cu), so that
the two give the same canonical words.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from abc_tpu_torch.crypto.numthy import modinv
from abc_tpu_torch.ops.modarith import as_residues, shoup, t64

launches = {"ks_decompose": 0, "ks_contract": 0, "ks_mod_down": 0,
            "ks_mod_down_relin": 0, "ks_mod_down_rotate": 0}

# words of a record of the packed tables, and the most special primes one
# ks_mod_down launch divides out (csrc/keyswitch.cu)
REC = 4
MAX_SPECIALS = 16


# -------------------------------------------------------------------- tables

class Digits:
    """The fast base conversion of the k >= 2 digit lift at one level: for
    each of the α digits, its k sources (data-row index `gather`, the
    source prime `q_src`, (Q_j/q_i)^-1 mod q_src `inv_qhat`; a short digit
    pads with inv_qhat = 0, whose terms are exactly 0) and `qhat` = Q_j/q_i
    mod each of the R columns; `words` packs them for the kernel."""

    def __init__(self, qs: Sequence[int], groups: Sequence[Sequence[int]],
                 cols: Sequence[int], k: int, device):
        """qs: the data primes; groups: each digit's data-row indices (at
        most k); cols: the R column moduli of the lift."""
        alpha, R = len(groups), len(cols)
        gather = np.zeros((alpha, k), dtype=np.int64)
        inv_qhat = np.zeros((alpha, k, 1), dtype=np.uint64)
        q_src = np.full((alpha, k, 1), qs[0], dtype=np.uint64)
        qhat = np.zeros((alpha, k, R, 1), dtype=np.uint64)
        for j, grp in enumerate(groups):
            Qj = 1
            for i in grp:
                Qj *= qs[i]
            for i, gi in enumerate(grp):
                qh = Qj // qs[gi]
                gather[j, i] = gi
                q_src[j, i, 0] = qs[gi]
                inv_qhat[j, i, 0] = modinv(qh % qs[gi], qs[gi])
                for r, qr in enumerate(cols):
                    qhat[j, i, r, 0] = qh % qr
        self.alpha, self.k = alpha, k
        self.gather = torch.from_numpy(gather.reshape(-1)).to(device)
        self.inv_qhat = as_residues(inv_qhat, device)
        self.q_src = as_residues(q_src, device)
        self.qhat = as_residues(qhat, device)
        # per (j, i): (row, q_src, inv_qhat, its companion); then T[j][i][r]
        recs = [(int(g), int(m), int(w), shoup(int(w), int(m)))
                for g, m, w in zip(gather.reshape(-1), q_src.reshape(-1),
                                   inv_qhat.reshape(-1))]
        self.words = as_residues(np.asarray(
            [w for rec in recs for w in rec] + qhat.reshape(-1).tolist(),
            dtype=np.uint64), device)


class Division:
    """The exact centred division of [..., Lo + k, n] over the base `cols`
    by its last k primes, last first, into [..., Lo, n]: step s divides the
    rows below Lo + s by the prime of row Lo + s. `steps[s]` = (q column of
    those rows, p_s mod q, p_s^-1 mod q, p_s >> 1), the plain version's;
    `words` packs them for the kernel. A rescale is the division of a level
    by its last data prime (k = 1). len() is k."""

    def __init__(self, cols: Sequence[int], k: int, device):
        if not 1 <= k < len(cols):
            raise ValueError(f"a division by {k} of {len(cols)} primes")
        cols = [int(c) for c in cols]
        Lo = len(cols) - k
        self.steps: List[tuple] = []
        stride = REC + REC * len(cols)
        words = np.zeros(k * stride, dtype=np.uint64)
        for s in range(k):
            p, rows = cols[Lo + s], cols[:Lo + s]
            p_mod = [p % q for q in rows]
            p_inv = [modinv(p, q) for q in rows]
            self.steps.append(tuple(
                as_residues(np.asarray(v, dtype=np.uint64).reshape(-1, 1),
                            device) for v in (rows, p_mod, p_inv))
                + (p >> 1,))
            words[s * stride] = p >> 1
            recs = [(q, pm, pi, shoup(pi, q))
                    for q, pm, pi in zip(rows, p_mod, p_inv)]
            words[s * stride + REC:s * stride + REC * (1 + len(rows))] = \
                [w for rec in recs for w in rec]
        self.Lo, self.k = Lo, k
        self.words = as_residues(words, device)

    def __len__(self) -> int:
        return self.k


class Tail(NamedTuple):
    """What `mod_down` adds to the halves (k0, k1) of a key switch of
    [..., 2, Lo + k, n] before it stores them (K9a), finishing a ciphertext
    [..., 2, Lo, n]: "relin" adds components 0 and 1 of the size-3 product
    `c` ([..., 3, Lo, n]) to k0 and k1; "rotate" adds c0^g, the image of
    `c` (c0 [..., Lo, n]) under x → x^g, to k0 and keeps k1, given `ginv` =
    g^-1 mod 2n (RlweKeys._galois_inv; the kernel reads column j of c0^g
    from c0 at s = j·g^-1 mod 2n, at s − n negated where s >= n, the plain
    version gathers by crypto/rlwe.galois_gather's tables)."""
    kind: str
    c: torch.Tensor
    ginv: int = 0


# ----------------------------------------------------------- plain versions

def lift_plain(d, q):
    """k = 1: each data row of d ([..., L, n]) lifted to the R columns of q
    ([R, 1]) by a conditional subtract (primes of one size): [..., L, R,
    n]."""
    R = q.shape[0]
    lifted = d[..., :, None, :].expand(tuple(d.shape[:-1]) + (R,) +
                                       tuple(d.shape[-1:]))
    q3 = q.reshape(1, R, 1)
    return torch.where(lifted >= q3, lifted - q3, lifted)


def decompose_plain(d, q, digits: Digits):
    """k >= 2: the fast base conversion of each digit [d]_{Q_j} of d ([...,
    L, n]) to the R columns of q ([R, 1]), uncentred: [..., α, R, n]."""
    batch, n = tuple(d.shape[:-2]), d.shape[-1]
    q3 = q.reshape(1, q.shape[0], 1)
    y_src = d.index_select(-2, digits.gather).reshape(
        batch + (digits.alpha, digits.k, n))
    y = t64.mul(y_src, digits.inv_qhat, digits.q_src)
    D = None
    for i in range(digits.k):
        term = t64.mul(y[..., i:i + 1, :], digits.qhat[:, i], q3)
        D = term if D is None else t64.add(D, term, q3)
    return D


def contract_plain(D, ksk_b, ksk_a, q, perm=None):
    """Σ_i D_i ⊙ ksk_i over the digit axis (dim -3) for both key halves:
    [..., α, R, n] → [..., 2, R, n] mod q ([R, 1]); ksk_a None: the first
    half alone, [..., 1, R, n]; with `perm`, D's columns permuted first
    (D[..., perm])."""
    if perm is not None:
        D = D.index_select(-1, perm)
    q3 = q.reshape(1, q.shape[0], 1)
    return torch.stack([t64.sum_mod(t64.mul(D, key, q3), q, dim=-3)
                        for key in (ksk_b, ksk_a) if key is not None],
                       dim=-3)


def mod_down_plain(x, division: Division, tail: Optional[Tail] = None):
    """[..., Lo + k, n] → [..., Lo, n]: k successive exact centred divisions
    (x − centred([x]_p))·p^{-1}, last prime first. The reference's steps
    word for word: [x]_p reduced mod q by one conditional subtract (primes
    of one size), the centring test on the unreduced residue. With a tail,
    x is [..., 2, Lo + k, n] and the tail's chain follows (tail_plain)."""
    for s in reversed(range(division.k)):
        qv, p_mod, p_inv, half = division.steps[s]
        rows = qv.shape[0]
        x_rest, x_p = x[..., :rows, :], x[..., rows:rows + 1, :]
        x_p_red = torch.where(x_p >= qv, x_p - qv, x_p)
        corr = torch.where(x_p > half, t64.sub(x_p_red, p_mod, qv), x_p_red)
        x = t64.mul(t64.sub(x_rest, corr, qv), p_inv, qv)
    return x if tail is None else tail_plain(x, tail, division.steps[0][0])


def tail_plain(k, tail: Tail, q):
    """The chains a relinearization and a rotation ran after the key switch
    (k [..., 2, Lo, n], q [Lo, 1]): the two adds and the stack, or the
    signed gather of c0 by galois_gather's tables for g = ginv^-1 mod 2n,
    its negation, the add to k0 and the stack."""
    from abc_tpu_torch.crypto.rlwe import galois_gather
    k0, k1 = k[..., 0, :, :], k[..., 1, :, :]
    if tail.kind == "relin":
        c = tail.c
        return torch.stack([t64.add(c[..., 0, :, :], k0, q),
                            t64.add(c[..., 1, :, :], k1, q)], dim=-3)
    n = k.shape[-1]
    gather, sign_pos = galois_gather(n, pow(tail.ginv, -1, 2 * n),
                                     tail.c.device)
    c0g = tail.c.index_select(-1, gather)
    c0g = torch.where(sign_pos, c0g, t64.neg(c0g, q))
    return torch.stack([t64.add(c0g, k0, q), k1], dim=-3)


# ---------------------------------------------------------------- launching

def _operand(x, name, dims, strided=False):
    """(rows, n, words between rows) of a CUDA operand of at least `dims`
    axes; raises unless the kernels take it. A `strided` operand's [L, n]
    rows may lie any multiple of 4 words apart, as long as its leading
    axes share one stride (one component of a batch of ciphertexts, a
    level's limbs of a wider one); any other must be contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"key-switch kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"key-switch operand {name} must be int32, got "
                        f"{x.dtype}")
    if x.dim() < dims:
        raise ValueError(f"key-switch operand {name} needs {dims} axes, got "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n < 4 or n & (n - 1):
        raise ValueError(f"key-switch operand {name}: n must be a power of "
                         f"two >= 4, got {n}")
    block = int(np.prod(x.shape[-dims:], dtype=np.int64))
    stride = _row_stride(x) if strided else \
        (block if x.is_contiguous() else None)
    if stride is None:
        raise ValueError(f"key-switch operand {name} must be contiguous"
                         + (f" rows of {tuple(x.shape[-2:])} at one stride"
                            if strided else "") + f", got strides "
                         f"{x.stride()} of {tuple(x.shape)}")
    if x.data_ptr() % 16 or stride % 4:
        raise ValueError(f"key-switch operand {name} must be 16-byte "
                         f"aligned, at {x.data_ptr():#x}, rows {stride} "
                         "words apart")
    return x.numel() // block, n, stride


def _row_stride(x):
    """Words between the [L, n] rows of x, or None where its rows are not
    contiguous or its leading axes do not collapse to one stride."""
    L, n = x.shape[-2:]
    if x.stride(-1) != 1 or (L > 1 and x.stride(-2) != n):
        return None
    lead = [(size, st) for size, st in zip(x.shape[:-2], x.stride()[:-2])
            if size != 1]
    if any(outer != inner * size for (_, outer), (size, inner) in
           zip(lead, lead[1:])):
        return None
    stride = lead[-1][1] if lead else L * n
    return stride if stride >= L * n else None


def _table(t, name, device, words, dtype=torch.int32):
    if t is None or t.device != device or t.dtype != dtype or \
            not t.is_contiguous() or t.numel() != words:
        raise ValueError(
            f"key-switch table {name} must be a contiguous {dtype} tensor of "
            f"{words} words on {device}, got "
            f"{None if t is None else (t.dtype, tuple(t.shape), t.device)}")


def _launch(name, device, call):
    from abc_tpu_torch.ops import _build
    _build.launch(launches, name, device, call)


def decompose(d, q, ratio, digits: Optional[Digits] = None):
    """The digit lift of d ([..., L, n], coefficient domain; on the card its
    rows may lie at one stride, _operand) to the R columns of q ([R, 1];
    `ratio` [R] int64, modarith.ratio_table, read by the kernel only):
    k = 1 (digits None) [..., L, R, n], else [..., α, R, n] by
    `digits`."""
    if d.device.type == "cpu":
        return lift_plain(d, q) if digits is None else \
            decompose_plain(d, q, digits)
    rows, n, d_stride = _operand(d, "d", 2, strided=True)
    L, R = d.shape[-2], q.shape[0]
    _table(q, "q", d.device, R)
    _table(ratio, "ratio", d.device, R, torch.int64)
    A, K, tab = L, 1, None
    if digits is not None:
        A, K, tab = digits.alpha, digits.k, digits.words
        _table(tab, "digits", d.device, A * K * (REC + R))
    out = torch.empty(tuple(d.shape[:-2]) + (A, R, n), dtype=torch.int32,
                      device=d.device)
    _launch("ks_decompose", d.device, lambda lib, s: lib.abc_ks_decompose(
        d.data_ptr(), out.data_ptr(), q.data_ptr(), ratio.data_ptr(),
        None if tab is None else tab.data_ptr(), rows, d_stride, L, A, R, K,
        n.bit_length() - 1, s))
    return out


def contract(D, ksk_b, ksk_a, q, ratio, perm=None):
    """Σ_i D_i ⊙ ksk_i for both halves of a switching key, one [..., 2, R, n]
    tensor from D [..., α, R, n] and keys [α, R, n], or keys with leading
    axes equal to D's last ones (a LocalComm shard axis); q [R, 1], ratio
    [R] int64. ksk_a None: the first half alone, [..., 1, R, n] (a
    decryption's Σ_k c_k·s^k against the rows [1, s, s², ...]). perm ([n]
    int64): output column c reads D at perm[c], the Galois permutation of a
    hoisted rotation."""
    if D.device.type == "cpu":
        return contract_plain(D, ksk_b, ksk_a, q, perm)
    rows, n, _ = _operand(D, "D", 3)
    A, R = D.shape[-3], D.shape[-2]
    klead = tuple(ksk_b.shape[:-3])
    for name, key in (("ksk_b", ksk_b), ("ksk_a", ksk_a)):
        if key is None and name == "ksk_a":
            continue
        _operand(key, name, 3)
        lead = tuple(D.shape[:-3])
        if tuple(key.shape) != klead + (A, R, n) or key.device != D.device \
                or lead[len(lead) - len(klead):] != klead or \
                len(klead) > len(lead):
            raise ValueError(f"key-switch contraction: {name} "
                             f"{tuple(key.shape)} must be [..., {A}, {R}, "
                             f"{n}] with D's last leading axes "
                             f"{tuple(D.shape)}, on D's device")
    _table(q, "q", D.device, R)
    _table(ratio, "ratio", D.device, R, torch.int64)
    if perm is not None:
        _table(perm, "perm", D.device, n, torch.int64)
    krows = int(np.prod(klead, dtype=np.int64))
    halves = 1 if ksk_a is None else 2
    out = torch.empty(tuple(D.shape[:-3]) + (halves, R, n),
                      dtype=torch.int32, device=D.device)
    _launch("ks_contract", D.device, lambda lib, s: lib.abc_ks_contract(
        D.data_ptr(), ksk_b.data_ptr(),
        None if ksk_a is None else ksk_a.data_ptr(), out.data_ptr(),
        None if perm is None else perm.data_ptr(), q.data_ptr(),
        ratio.data_ptr(), rows, krows, A, R, n.bit_length() - 1, s))
    return out


def mod_down(x, division: Division, tail: Optional[Tail] = None):
    """x [..., Lo + k, n] (on the card its rows may lie at one stride,
    _operand) → [..., Lo, n], the exact centred division by the last k
    primes of the division's base. With a tail (K9a), x holds the halves
    of key switches, [..., 2, Lo + k, n], and the launch writes the
    finished ciphertexts [..., 2, Lo, n] (Tail). How the launch splits its
    work (kept rows a thread): `mod_down_plan`."""
    if x.device.type == "cpu":
        return mod_down_plain(x, division, tail)
    rows, n, x_stride = _operand(x, "x", 2, strided=True)
    Lo, k = division.Lo, division.k
    if x.shape[-2] != Lo + k or k > MAX_SPECIALS:
        raise ValueError(f"key-switch mod down: x {tuple(x.shape)} must have "
                         f"{Lo} + {k} rows, at most {MAX_SPECIALS} divided "
                         "out")
    _table(division.words, "division", x.device, k * REC * (1 + Lo + k))
    out = torch.empty(tuple(x.shape[:-2]) + (Lo, n), dtype=torch.int32,
                      device=x.device)
    if tail is None:
        _launch("ks_mod_down", x.device, lambda lib, s: lib.abc_ks_mod_down(
            x.data_ptr(), out.data_ptr(), division.words.data_ptr(), rows,
            x_stride, Lo, k, n.bit_length() - 1, s))
        return out
    c_stride, c_comp = _tail_operand(x, tail, Lo, n)
    kind = _TAILS[tail.kind]
    _launch(f"ks_mod_down_{tail.kind}", x.device,
            lambda lib, s: lib.abc_ks_mod_down_tail(
                x.data_ptr(), out.data_ptr(), division.words.data_ptr(), rows,
                x_stride, Lo, k, n.bit_length() - 1, kind, tail.c.data_ptr(),
                c_stride, c_comp, tail.ginv, s))
    return out


# abc_ks_mod_down_tail's tail numbers (0: none, abc_ks_mod_down)
_TAILS = {"relin": 1, "rotate": 2}


def _tail_operand(x, tail: Tail, Lo, n):
    """(words between ciphertexts, words between components) of a tail's
    ciphertext rows, which must lie where the kernel reads them: one
    ciphertext per pair of x's rows, [Lo, n] rows of consecutive words; a
    rotation's g^-1 must be odd and below 2n."""
    if tail.kind not in _TAILS:
        raise ValueError(f"key-switch mod down: no tail {tail.kind!r}")
    c, lead = tail.c, tuple(x.shape[:-3])
    relin = tail.kind == "relin"
    first = c[..., 0, :, :] if relin else c
    if x.dim() < 3 or x.shape[-3] != 2 or c.device != x.device or \
            c.dtype != torch.int32 or tuple(first.shape) != lead + (Lo, n) \
            or (relin and c.shape[-3] < 2):
        raise ValueError(f"key-switch mod down's {tail.kind} tail: x "
                         f"{tuple(x.shape)} must be [..., 2, {Lo} + k, {n}] "
                         f"and its ciphertext {tuple(c.shape)} int32 "
                         f"{'[..., >= 2' if relin else '[...'}, {Lo}, {n}] "
                         "on x's device")
    c_stride = _row_stride(first)
    c_comp = c.stride(-3) if relin else 0
    if c_stride is None or c.data_ptr() % 16 or c_stride % 4 or c_comp % 4:
        raise ValueError(f"key-switch mod down's {tail.kind} tail: rows of "
                         f"{(Lo, n)} at one stride, 16-byte aligned, got "
                         f"strides {c.stride()} of {tuple(c.shape)}")
    if not relin and not (0 < tail.ginv < 2 * n and tail.ginv % 2):
        raise ValueError(f"key-switch mod down's rotate tail: g^-1 mod 2n "
                         f"must be odd and below {2 * n}, got {tail.ginv}")
    return c_stride, c_comp


def _lib():
    from abc_tpu_torch.ops import _build
    return _build.load()


def _info_error(lib, what, err):
    if err != 0:
        raise RuntimeError(f"{what}: "
                           f"{lib.abc_cuda_error_string(err).decode()}")


# the mod-down kernels and their tail numbers in abc_ks_mod_down_plan
_MOD_DOWN = {"ks_mod_down": 0,
             **{f"ks_mod_down_{kind}": v for kind, v in _TAILS.items()}}


def mod_down_plan(name: str, n: int, rows: int, Lo: int, k: int = 1) -> dict:
    """The launch ks_mod_down (or a form with a tail) makes over `rows` rows
    of Lo kept rows of n and k special primes on the current card
    (abc_ks_mod_down_plan): the instantiation (arg0: the special primes
    held in registers; arg1: the kept rows a thread, also as "rows"),
    threads a block, blocks, blocks and warps an SM, threads and the
    card's SMs. ks_decompose and ks_contract launch by their whole shape
    (`plan`)."""
    import ctypes
    if name not in _MOD_DOWN:
        raise ValueError(f"mod_down_plan takes {sorted(_MOD_DOWN)}; "
                         f"{name} launches by its shape: plan()")
    lib = _lib()
    info = (ctypes.c_longlong * 8)()
    _info_error(lib, f"abc_ks_mod_down_plan({name})",
                lib.abc_ks_mod_down_plan(_MOD_DOWN[name], rows, Lo, k,
                                         n.bit_length() - 1, info))
    out = dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                    "warps_per_sm", "total_threads", "sms"), info))
    out["rows"] = out["arg1"]
    return out


# abc_ks_plan's kernel numbers and the names of its instantiation and split
_PLAN = {"ks_decompose": (0, ("sources", None, "cols", "groups")),
         "ks_contract": (1, ("lanes", "halves", None, None))}


def plan(name: str, n: int, rows: int, A: int, R: int, K: int = 1,
         halves: int = 2) -> dict:
    """The launch ks_decompose (`rows` of d, A digits of K sources, R
    columns) or ks_contract (`rows` of D, A digits, R columns, `halves`)
    makes on the current card (abc_ks_plan): the instantiation (arg0,
    arg1: the sources held in registers; or the lanes a quad, 1 for the
    streaming kernel, and the halves), the lift's split (arg2, arg3: the
    columns a thread and the column groups), threads a block, blocks,
    blocks and warps an SM, threads and the card's SMs; the same numbers
    under their names."""
    import ctypes
    kernel, names = _PLAN[name]
    lib = _lib()
    info = (ctypes.c_longlong * 10)()
    _info_error(lib, f"abc_ks_plan({name})", lib.abc_ks_plan(
        kernel, rows, A, R, K, halves, n.bit_length() - 1, info))
    out = dict(zip(("arg0", "arg1", "arg2", "arg3", "threads", "blocks",
                    "blocks_per_sm", "warps_per_sm", "total_threads", "sms"),
                   info))
    out.update((k, v) for k, v in zip(names, info[:4]) if k)
    return out
