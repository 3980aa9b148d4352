"""abc_tpu_torch NTT ablation and ALU calibration: the plain torch versions
against the TPU kernels of scripts/ntt_ablation.py run through the Pallas
interpreter, the routing and refusals of the kernel wrappers, the SASS census
parser, and — on a CUDA device — the hand-written kernels against their plain
versions.

Inputs are drawn with numpy from a seed; every word is an integer, so the
tolerance is exact equality.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from abc_tpu.crypto.ntt import NttContext as RefNttContext
from abc_tpu.crypto.numthy import gen_ntt_primes
from abc_tpu_torch.crypto.ntt import NttContext
from abc_tpu_torch.ops import ntt_ablation as na
from abc_tpu_torch.ops import ntt_kernels as nk
from abc_tpu_torch.ops.modarith import as_residues, to_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tpu_script():
    """scripts/ntt_ablation.py, loaded from its file (it is not a package
    module) for its Pallas kernel bodies."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "ntt_ablation_tpu", os.path.join(ROOT, "scripts", "ntt_ablation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rand(moduli, n, batch=(), seed=0):
    L = len(moduli)
    rng = np.random.default_rng(seed)
    hi = np.asarray(moduli, dtype=np.uint64).reshape(L, 1)
    return rng.integers(0, hi, size=batch + (L, n),
                        dtype=np.uint64).astype(np.uint32)


def _rand_words(shape, seed):
    """u32 words over the whole range, about half of them >= 2^31."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


def _ablate_interpret(script, a, moduli, n, mode):
    """scripts/ntt_ablation.py:ablate_ntt restated with interpret=True: the
    same pallas_call over `_ablate_kernel`, its grid, blocks and tables."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from abc_tpu.ops.pallas_ntt import (LANE, _pad_limbs, _prep, _tblk,
                                        _xblk, get_tables)

    ref = RefNttContext(n, moduli, engine="jx32")
    pw, psh, lw, lsh = (jnp.asarray(t) for t in get_tables(ref)[:4])
    q = jnp.asarray(np.asarray(moduli, dtype=np.uint32))
    a = jnp.asarray(a)
    B, L, G, ngroups, sub, a5 = _prep(a, q, n)
    Lp = G * ngroups
    out = pl.pallas_call(
        functools.partial(script._ablate_kernel, n, G, mode),
        grid=(ngroups, B),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  _xblk(G, sub),
                  _tblk(G, (sub, LANE)), _tblk(G, (sub, LANE)),
                  _tblk(G, (8, LANE)), _tblk(G, (8, LANE))],
        out_specs=_xblk(G, sub),
        out_shape=jax.ShapeDtypeStruct((B, ngroups, G, sub, LANE),
                                       jnp.uint32),
        interpret=True,
    )(_pad_limbs(q.reshape(L, 1), Lp), a5,
      _pad_limbs(pw, Lp), _pad_limbs(psh, Lp),
      _pad_limbs(lw, Lp), _pad_limbs(lsh, Lp))
    return np.asarray(out.reshape(B, Lp, n)[:, :L].reshape(a.shape))


def _alu_interpret(script, x, kind, iters):
    """scripts/ntt_ablation.py:alu_chain restated with interpret=True."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    kern = script._alu_mac_kernel if kind == "mac" \
        else script._alu_shoup_kernel
    block = pl.BlockSpec((1,) + x.shape[1:], lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(kern, iters),
        grid=(x.shape[0],),
        in_specs=[block], out_specs=block,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


# ------------------------------------------------- plain vs the TPU kernels

@pytest.mark.parametrize("mode", na.MODES)
@pytest.mark.parametrize("n", [256, 2048])
def test_ablate_plain_matches_pallas_interpret(tpu_script, n, mode):
    moduli = gen_ntt_primes(30, 2, n)
    a = _rand(moduli, n, batch=(2,), seed=n + na.MODES.index(mode))
    want = _ablate_interpret(tpu_script, a, moduli, n, mode)
    ctx = NttContext(n, moduli, "cpu")
    got = na.ablate_ntt_plain(as_residues(a, "cpu"), ctx.q, ctx.fwd_tw, mode)
    np.testing.assert_array_equal(to_host(got), want)


@pytest.mark.parametrize("iters", [1, 37])
@pytest.mark.parametrize("kind", na.ALU_KINDS)
def test_alu_plain_matches_pallas_interpret(tpu_script, kind, iters):
    x = _rand_words((2, 8, 128), seed=iters)
    assert (x >= 1 << 31).any()
    want = _alu_interpret(tpu_script, x, kind, iters)
    got = na.alu_chain_plain(as_residues(x, "cpu"), kind, iters)
    np.testing.assert_array_equal(to_host(got), want)


def test_alu_plain_matches_python_integers():
    """The 16-bit-split emulation of mul and umulhi against exact Python
    integers, at the words where wraparound bites."""
    words = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 536903680,
             2654435761, 4000000000]
    x = as_residues(np.asarray(words, dtype=np.uint64).reshape(1, 1, -1),
                    "cpu")
    c, d, _ = na.ALU_CONSTANTS["mac"]
    w, wsh, q = na.ALU_CONSTANTS["shoup"]
    mac, shoup = list(words), list(words)
    for _ in range(3):
        mac = [(v * c + d) % (1 << 32) for v in mac]
        shoup = [(v * w - ((v * wsh) >> 32) * q) % (1 << 32) for v in shoup]
    assert to_host(na.alu_chain_plain(x, "mac", 3)).ravel().tolist() == mac
    assert to_host(na.alu_chain_plain(x, "shoup", 3)).ravel().tolist() \
        == shoup


def test_plain_modes_closed_forms():
    """zero, masks_only and the NTT modes against their closed forms and the
    np64 oracle."""
    n = 1024
    moduli = gen_ntt_primes(30, 3, n)
    ctx = NttContext(n, moduli, "cpu")
    a = _rand(moduli, n, batch=(2,), seed=9)
    at = as_residues(a, "cpu")
    q = np.asarray(moduli, dtype=np.uint64).reshape(3, 1)
    pop = np.asarray([bin(p).count("1") for p in range(n)], dtype=np.uint64)
    np.testing.assert_array_equal(
        to_host(na.ablate_ntt_plain(at, ctx.q, ctx.fwd_tw, "masks_only")),
        (a.astype(np.uint64) + pop) % q)
    assert torch.equal(na.ablate_ntt_plain(at, ctx.q, ctx.fwd_tw, "zero"), at)
    ref = RefNttContext(n, moduli, engine="np64").fwd(a)
    for mode in na.NTT_MODES:
        np.testing.assert_array_equal(
            to_host(na.ablate_ntt_plain(at, ctx.q, ctx.fwd_tw, mode)), ref)


# --------------------------------------------------- routing and refusals

def test_wrappers_route_cpu_tensors_to_plain_without_launching():
    n = 1024
    ctx = NttContext(n, gen_ntt_primes(30, 2, n), "cpu")
    a = as_residues(_rand(ctx.moduli, n, batch=(2,), seed=4), "cpu")
    x = as_residues(_rand_words((2, 4, 128), seed=4), "cpu")
    before = dict(na.launches), dict(nk.launches)
    for mode in na.MODES:
        assert torch.equal(na.ablate_ntt(a, ctx, mode),
                           na.ablate_ntt_plain(a, ctx.q, ctx.fwd_tw, mode))
    for kind in na.ALU_KINDS:
        assert torch.equal(na.alu_chain(x, kind, 5),
                           na.alu_chain_plain(x, kind, 5))
    assert (dict(na.launches), dict(nk.launches)) == before


def _refusals():
    n = 1024
    ctx = NttContext(n, gen_ntt_primes(30, 2, n), "cpu")
    a = as_residues(_rand(ctx.moduli, n, seed=5), "cpu")
    x = as_residues(_rand_words((2, 4, 128), seed=5), "cpu")
    meta = torch.empty((2, n), dtype=torch.int32, device="meta")
    meta_x = torch.empty((2, 4, 128), dtype=torch.int32, device="meta")
    return {
        "meta_ablate": (lambda: na.ablate_ntt(meta, ctx, "full"),
                        ValueError, "CPU or CUDA"),
        "meta_alu": (lambda: na.alu_chain(meta_x, "mac", 4),
                     ValueError, "CPU or CUDA"),
        "unknown_mode": (lambda: na.ablate_ntt(a, ctx, "shipping"),
                         ValueError, "unknown ablation mode"),
        "unknown_kind": (lambda: na.alu_chain(x, "fma", 4),
                         ValueError, "unknown ALU chain"),
        "int64_ablate": (lambda: na.ablate_ntt(a.to(torch.int64), ctx,
                                               "full"),
                         TypeError, "int32"),
        "int64_alu": (lambda: na.alu_chain(x.to(torch.int64), "shoup", 4),
                      TypeError, "int32"),
        "negative_iters": (lambda: na.alu_chain(x, "mac", -1),
                           ValueError, "iters"),
    }


@pytest.mark.parametrize("case", ["meta_ablate", "meta_alu", "unknown_mode",
                                  "unknown_kind", "int64_ablate", "int64_alu",
                                  "negative_iters"])
def test_wrappers_refuse(case):
    fn, exc, match = _refusals()[case]
    before = dict(na.launches)
    with pytest.raises(exc, match=match):
        fn()
    assert na.launches == before


def test_script_refuses_without_cuda(monkeypatch):
    from abc_tpu_torch.scripts import ntt_ablation as script
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--batched", "--quick"])


# ------------------------------------------------------------- SASS census

def _sass_function(name, lines):
    """`cuobjdump -sass` text of one function: instructions at 16-byte
    addresses from 0."""
    out = [f"\t\tFunction : _ZN12_GLOBAL__N_1{name}Ev"]
    for addr, line in enumerate(lines):
        out.append(f"        /*{16 * addr:04x}*/                   {line} ;"
                   f"    /* 0x000fe40000000800 */")
    return "\n".join(out)


def _chain(ops, unroll):
    """An alu chain's SASS: entry, an unrolled loop of `ops` per iteration
    (branching back by address), then a remainder loop of one."""
    body = [op for _ in range(unroll) for op in ops]
    top, rem = 0x20, 0x20 + 16 * (len(body) + 3)
    return _sass_function("alu_kernel", [
        "LDG.E.CONSTANT R5, desc[UR4][R2.64]", "ISETP.GE.AND P0, PT, R7, 0x1"]
        + body + ["IADD3 R2, R2, -0x8, RZ", "ISETP.NE.AND P1, PT, R2, RZ",
                  f"@P1 BRA 0x{top:x}"]
        + ops + ["ISETP.NE.AND P0, PT, R0, RZ", f"@P0 BRA 0x{rem:x}",
                 "STG.E desc[UR4][R2.64], R5", "EXIT", "BRA 0x400"])


_MAC = ["IMAD R5, R5, R8, R9"]
_SHOUP = ["IMAD.HI.U32 R5, R7, UR9, RZ", "IMAD R6, R5, UR6, RZ",
          "IMAD R7, R7, UR8, -R6"]
# the shape of a one-stage-per-barrier kernel: its stage loop (0x10-0x120)
# around its butterfly loop (0x20-0xf0)
_FWD = _sass_function("ntt_fwd_kernel", [
    "MOV R0, RZ", "IADD3 R1, R1, 0x1, RZ",
    "SHF.R.S32.HI R20, RZ, UR5, R19", "LDS R22, [R20]", "LDS R23, [R21]",
    "LDG.E.CONSTANT R6, desc[UR8][R6.64]",
    "LDG.E.CONSTANT R8, desc[UR8][R8.64]", "ISETP.GE.U32.AND P1, PT, R22",
    "IMAD.HI.U32 R25, R23, R6, RZ", "IMAD R25, R10, R25, RZ",
    "IMAD R25, R8, R23, -R25", "STS [R20], R7", "STS [R21], R22",
    "@!P1 BRA 0x20", "USHF.L.U32 UR6, UR6, 0x1, URZ",
    "BAR.SYNC.DEFER_BLOCKING 0x0", "@!P1 BRA 0x10", "@P0 EXIT",
    "BRA 0x120"])


def test_sass_census_of_the_butterfly_loop():
    from abc_tpu_torch.scripts import ntt_ablation as script
    funcs = script.sass_functions(_FWD)
    c = script.butterfly_census(funcs, "ntt_fwd_kernel", n=16384)
    assert c["butterflies_per_loop_body"] == 1
    assert (c["instructions_per_butterfly"], c["alu_per_butterfly"],
            c["imad_per_butterfly"]) == (12, 5, 3)
    assert (c["lds_per_butterfly"], c["sts_per_butterfly"],
            c["ldg_per_butterfly"], c["control_per_butterfly"]) == (2, 2, 2, 1)
    assert c["barriers_per_outer_loop"] == 1
    assert c["alu_per_element"] == 5 * 14 / 2


def test_sass_census_counts_butterflies_by_their_shoup_products():
    """A three-stage register pass: 12 butterflies (12 IMAD.HI) between 8
    loads and 8 stores in one loop body, no loop around it."""
    from abc_tpu_torch.scripts import ntt_ablation as script
    shoup = ["IMAD.HI.U32 R25, R23, R6, RZ", "IMAD R25, R10, R25, RZ",
             "IMAD R25, R8, R23, -R25", "IADD3 R7, R7, R25, RZ"]
    body = ["MOV R0, RZ"] + ["LDS R22, [R20]"] * 8 + shoup * 12 + \
        ["STS [R20], R7"] * 8 + ["@!P1 BRA 0x10", "EXIT", "BRA 0x400"]
    funcs = script.sass_functions(_sass_function("ntt_fwd_kernel", body))
    c = script.butterfly_census(funcs, "ntt_fwd_kernel", n=8192)
    assert c["butterflies_per_loop_body"] == 12
    assert c["instructions_per_butterfly"] == (8 + 48 + 8 + 1) / 12
    assert c["imad_per_butterfly"] == 3 and c["alu_per_butterfly"] == 4
    assert c["barriers_per_outer_loop"] is None


def test_sass_census_reads_full_as_the_shipping_pass():
    """`full` is the C = 1 instantiation ablate_ntt_kernel<kFull, 0>, the
    shipping pass compiled again: the census finds its three-stage pass
    under FULL_KERNEL's name and counts what it counts for SHIPPING_KERNEL
    on the same body."""
    from abc_tpu_torch.scripts import ntt_ablation as script
    shoup = ["IMAD.HI.U32 R25, R23, R6, RZ", "IMAD R25, R10, R25, RZ",
             "IMAD R25, R8, R23, -R25", "IADD3 R7, R7, R25, RZ",
             "LOP3.LUT R9, R9, 0xff, RZ, 0xc0, !PT"]
    body = ["MOV R0, RZ"] + ["LDS R22, [R20]"] * 8 + shoup * 12 + \
        ["STS [R20], R7"] * 8 + ["@!P1 BRA 0x10", "EXIT", "BRA 0x400"]
    text = "\n".join(
        _sass_function(name, body) for name in (
            script.FULL_KERNEL, script.SHIPPING_KERNEL,
            script.FULL_KERNEL.replace("Li0EE", "Li3EE")))
    funcs = script.sass_functions(text)
    full = script.butterfly_census(funcs, script.FULL_KERNEL)
    shipping = script.butterfly_census(funcs, script.SHIPPING_KERNEL)
    assert full["kernel"] == "ablate_ntt_kernelILi4ELi0EE"
    assert full["butterflies_per_loop_body"] == 12
    assert full["instructions_per_butterfly"] == (8 + 60 + 8 + 1) / 12
    assert {k: v for k, v in full.items() if k != "kernel"} == \
        {k: v for k, v in shipping.items() if k != "kernel"}


@pytest.mark.parametrize("kind,ops,unroll,folded", [
    ("mac", _MAC, 8, False), ("shoup", _SHOUP, 8, False),
    ("mac", _MAC, 4, True)])
def test_sass_census_of_the_alu_chains(kind, ops, unroll, folded):
    """Instructions per chained iteration from the unrolled loop; a loop
    with fewer multiply-adds than the chain needs reads as folded."""
    from abc_tpu_torch.scripts import ntt_ablation as script
    other = "shoup" if kind == "mac" else "mac"
    text = (_chain(ops, unroll).replace("alu_kernel", f"alu_{kind}_kernel")
            + "\n" + _chain(_MAC if other == "mac" else _SHOUP, 8)
            .replace("alu_kernel", f"alu_{other}_kernel"))
    got = script.alu_chain_census(script.sass_functions(text))[kind]
    assert got["ops_per_iter"] == len(ops) * unroll / script.ALU_UNROLL
    assert got["instructions_per_iter"] == \
        (len(ops) * unroll + 3) / script.ALU_UNROLL
    assert got["folded"] is folded


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n,L,batch,ctas", [
    (16384, 14, 1, 8), (8192, 6, 3, 8), (16384, 14, 8, 1), (8192, 16, 4, 2),
    (8192, 12, 3, 4)])
def test_ablate_kernels_match_plain_on_cuda(cuda, n, L, batch, ctas):
    """Every ablate_ntt_kernel<Mode, LOGC>: each mode at a shape of each
    cluster size against its plain version, the NTT modes against
    ntt_fwd."""
    moduli = gen_ntt_primes(30, L, n)
    ctx = NttContext(n, moduli, cuda)
    assert nk.cluster_size(L * batch, n) == ctas
    a = as_residues(_rand(moduli, n, batch=(batch,), seed=n + L), cuda)
    fwd = nk.ntt_fwd(a, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
    for mode in na.MODES:
        before = na.launches["ablate_ntt"]
        got = na.ablate_ntt(a, ctx, mode)
        torch.cuda.synchronize()
        assert na.launches["ablate_ntt"] == before + 1
        assert torch.equal(got, na.ablate_ntt_plain(a, ctx.q, ctx.fwd_tw,
                                                    mode)), mode
        if mode in na.NTT_MODES:
            assert torch.equal(got, fwd), mode


@pytest.mark.gpu
@pytest.mark.parametrize("kind", na.ALU_KINDS)
def test_alu_kernels_match_plain_on_cuda(cuda, kind):
    x = as_residues(_rand_words((14, 128, 128), seed=7), cuda)
    for iters in (0, 1, 37, 512):
        got = na.alu_chain(x, kind, iters)
        torch.cuda.synchronize()
        assert torch.equal(got, na.alu_chain_plain(x, kind, iters)), iters
