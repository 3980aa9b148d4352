"""RNS elementwise kernels (K9b: `rns_ew`, the modular add, subtract,
multiply and negate of ciphertexts and plaintexts): launch wrappers of
csrc/elementwise.cu and their plain torch versions.

`add`, `sub`, `mul` and `neg` route themselves, as keyswitch_kernels does: a
CPU tensor goes to the plain version (the t64 engine of ops/modarith.py,
the chains the contexts ran before the kernel: the CPU route and the oracle
of the tests and of chip_smoke.py), a CUDA tensor to one launch of the
kernel, and any other device raises. The kernel is built at first use; a
failed build, a failed launch or an operand the kernel does not take
raises. `launches` counts kernel launches per op and nothing else.

Every call computes `out = a ∘ b mod q` over [..., C, L, n] residues (q
[L, 1]: limb l over q_l), or −a, with b broadcast as torch broadcasts it:
the same shape as a, a plaintext [L, n] over every component and batch row
(an [n] coefficient vector expanded over the limbs reads with limb stride
0), or a constant column [L, 1]. `w` ([L, 1]) multiplies b first (Δ·m of a
BFV plaintext). `first=True` is the component-0 form: the op with b on
component 0, the other components copied (negated, for `neg`), the
plaintext add and subtract of a ciphertext in one launch.

How a launch splits its work (quads a thread) follows from its size:
`launch_info`.
"""

from __future__ import annotations

import numpy as np
import torch

from abc_tpu_torch.ops.modarith import in_chain, t64

launches = {"rns_ew_add": 0, "rns_ew_sub": 0, "rns_ew_mul": 0,
            "rns_ew_neg": 0}

# abc_rns_ew's op numbers (csrc/elementwise.cu)
OPS = {"add": 0, "sub": 1, "mul": 2, "neg": 3}


# ----------------------------------------------------------- plain version

def ew_plain(op, a, b, q, w=None, first=False):
    """The t64 chain of one call: b·w mod q first where w is given, then
    a ∘ b (neg: −a, plus b on component 0 where b is given); the
    component-0 form replaces component 0 of a (of −a) by the op's
    result."""
    if w is not None:
        b = t64.mul(b, w, q)
    if op == "neg":
        a = t64.neg(a, q)
        if b is None:
            return a
        op = "add"
    fn = getattr(t64, op)
    if not first:
        return fn(a, b, q)
    c0 = fn(a[..., 0, :, :], b, q)
    return torch.cat([c0[..., None, :, :], a[..., 1:, :, :]], dim=-3)


# ---------------------------------------------------------------- launching

def _layout(x, shape, name, column=False):
    """(rows, row, component, limb strides in words, is a column) of x read
    as [rows, C, L, n] of the output `shape`: x broadcast to it, its
    leading axes beyond the broadcast ones collapsed to one stride (rows of
    x, read at an output row modulo them). Raises unless the kernel takes
    x."""
    try:
        e = x.expand(shape)
    except RuntimeError as err:
        raise ValueError(f"rns_ew operand {name} {tuple(x.shape)} does not "
                         f"broadcast to {tuple(shape)}") from err
    col = e.stride(-1) == 0
    if (col and not column) or (not col and e.stride(-1) != 1):
        raise ValueError(f"rns_ew operand {name}: its coefficients must be "
                         f"consecutive, got strides {x.stride()} of "
                         f"{tuple(x.shape)}")

    def st(axis):
        return 0 if shape[axis] == 1 else e.stride(axis)

    comp = st(-3) if len(shape) >= 3 else 0
    limb = st(-2)
    lead = [(size, e.stride(i)) for i, size in enumerate(shape[:-3])
            if size != 1]
    while lead and lead[0][1] == 0:             # broadcast outer rows
        lead.pop(0)
    if any(s == 0 for _, s in lead) or any(
            outer != inner * size
            for (_, outer), (size, inner) in zip(lead, lead[1:])):
        raise ValueError(f"rns_ew operand {name}: its leading axes must "
                         f"collapse to one stride, got strides {x.stride()} "
                         f"of {tuple(x.shape)} read as {tuple(shape)}")
    rows = int(np.prod([size for size, _ in lead], dtype=np.int64))
    row = lead[-1][1] if lead else 0
    if not col and (x.data_ptr() % 16 or row % 4 or comp % 4 or limb % 4):
        raise ValueError(f"rns_ew operand {name} must be 16-byte aligned "
                         f"with rows a multiple of 4 words apart, at "
                         f"{x.data_ptr():#x}, strides {x.stride()}")
    return rows, row, comp, limb, col


def _table(t, name, device, words, dtype=torch.int32):
    if t is None or t.device != device or t.dtype != dtype or \
            not t.is_contiguous() or t.numel() != words:
        raise ValueError(
            f"rns_ew table {name} must be a contiguous {dtype} tensor of "
            f"{words} words on {device}, got "
            f"{None if t is None else (t.dtype, tuple(t.shape), t.device)}")


def _args(op, a, b, q, ratio, w, first):
    """(output shape, a function of the output tensor giving abc_rns_ew's
    arguments but the stream) of one call; raises unless the kernel takes
    its operands. The host build of the tests calls the source with
    them."""
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t is not None and (t.device != dev or t.dtype != torch.int32):
            raise ValueError(f"rns_ew operand {name} must be int32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if a.dim() < (3 if first else 2):
        raise ValueError(f"rns_ew operand a must be [..., L, n] (the "
                         f"component-0 form: [..., C, L, n]), got "
                         f"{tuple(a.shape)}")
    shape = tuple(a.shape if b is None or first else
                  torch.broadcast_shapes(a.shape, b.shape))
    n, L = shape[-1], shape[-2]
    if n < 4 or n & (n - 1):
        raise ValueError(f"rns_ew: n must be a power of two >= 4, got {n}")
    C = shape[-3] if len(shape) >= 3 else 1
    rows = int(np.prod(shape[:-3], dtype=np.int64))
    la = _layout(a, shape, "a")
    lb = (0, 0, 0, 0, False)
    if b is not None:
        # the component-0 form reads b against component 0 alone
        lb = _layout(b.unsqueeze(-3) if first and b.dim() >= 3 else b,
                     shape, "b", column=True)
    _table(q, "q", dev, L)
    if op == "mul" or w is not None:
        _table(ratio, "ratio", dev, L, torch.int64)
    if w is not None:
        _table(w, "w", dev, L)
    return shape, lambda out: (
        OPS[op], a.data_ptr(), *la[:4], None if b is None else b.data_ptr(),
        *lb[:4], int(lb[4]), None if w is None else w.data_ptr(),
        out.data_ptr(), q.data_ptr(),
        None if ratio is None else ratio.data_ptr(), rows, C, L, int(first),
        n.bit_length() - 1)


def _launch(op, a, b, q, ratio, w, first):
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"rns_ew takes CPU or CUDA tensors, got {dev}")
    shape, args = _args(op, a, b, q, ratio, w, first)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    from abc_tpu_torch.ops import _build
    _build.launch(launches, f"rns_ew_{op}", dev,
                  lambda lib, s: lib.abc_rns_ew(*args(out), s))
    return out


@in_chain("elementwise")
def _ew(op, a, b, q, ratio, w=None, first=False):
    if a.device.type == "cpu":
        return ew_plain(op, a, b, q, w, first)
    return _launch(op, a, b, q, ratio, w, first)


def add(a, b, q, ratio, w=None, first=False):
    """a + b·w mod q (w None: a + b); first: on component 0 alone."""
    return _ew("add", a, b, q, ratio, w, first)


def sub(a, b, q, ratio, w=None, first=False):
    """a − b·w mod q (w None: a − b); first: on component 0 alone."""
    return _ew("sub", a, b, q, ratio, w, first)


def mul(a, b, q, ratio):
    """a·b mod q (ratio [L] int64, modarith.ratio_table, read by the kernel
    only)."""
    return _ew("mul", a, b, q, ratio)


def neg(a, q, ratio=None, b=None, w=None):
    """−a mod q (0 stays 0); with b, −a with b·w added to component 0 (a
    plaintext minus a ciphertext)."""
    return _ew("neg", a, b, q, ratio, w, b is not None)


def launch_info(op: str, lines: int, n: int) -> dict:
    """The launch an op makes for `lines` output rows of n (every output
    axis but the last, multiplied) with its theoretical occupancy on the
    current card: the quads a thread (arg0: 1, or 2 where the launch fills
    the card), threads a block, blocks, blocks and warps an SM."""
    import ctypes
    from abc_tpu_torch.ops import _build
    lib = _build.load()
    info = (ctypes.c_longlong * 6)()
    err = lib.abc_ew_launch_info(OPS[op], lines, n.bit_length() - 1, info)
    if err != 0:
        raise RuntimeError(f"abc_ew_launch_info({op}): "
                           f"{lib.abc_cuda_error_string(err).decode()}")
    return dict(zip(("arg0", "arg1", "threads", "blocks", "blocks_per_sm",
                     "warps_per_sm"), info))
