"""What the compiler made of the package's kernels, read from the text that
`_build` keeps: `ptxas -v` output (`_build.build_log`) and `cuobjdump -sass`
(`_build.sass()`).

Generic: `sass_functions` and `opcode` (the SASS of each function),
`ptxas_table` (registers, shared memory and spills of each entry function)
and `kernel_key` (one name for a kernel, mangled or demangled). For the BEHZ
kernels of csrc/behz.cu: `kernel_table` (both tables merged), `launch_of`
and `launch_key` (which instantiation a launch of one mult+relin runs, as
`behz_kernels.launch_info` reports it), `fmt_kernel`, and `shape_params`,
the parameters of a measured shape. Host-only text parsing; imports no
CUDA toolkit and no JAX.
"""

from __future__ import annotations

import re

# instructions counted per kernel in the SASS census: IMAD of every kind but
# IMAD.MOV (a move), IMAD.WIDE, global and shared loads and stores, barriers
CENSUS = ("IMAD", "IMAD.WIDE", "LDG", "STG", "LDS", "STS", "BAR")

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_MANGLED_ARGS = re.compile(r"I((?:L[a-z]+\d+E)+)E")
_MANGLED_ARG = re.compile(r"L([a-z]+)(\d+)E")
_DEMANGLED = re.compile(r"(\w+_kernel)(?:<([^<>]*)>)?\s*\(")


def sass_functions(text):
    """{mangled name: [(address, instruction text without ';'), ...]} from
    `cuobjdump -sass` output (branch targets are addresses)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(ins):
    """The mnemonic with its modifiers ('IMAD.HI.U32'), predicate dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def _key(name, args):
    return name + (f"<{','.join(args)}>" if args else "")


def kernel_key(name: str) -> str:
    """'behz_to_bsk_kernel<1,16>' from a kernel's mangled name (ptxas,
    cuobjdump) or its demangled one (the profiler's)."""
    if not name.startswith("_Z"):
        m = _DEMANGLED.search(name)
        return _key(m.group(1), [re.sub(r"^\(\w+\)", "", a.strip())
                                 for a in (m.group(2) or "").split(",")
                                 if a.strip()]) if m else name
    # the nested name's parts, each its length and its characters
    at = 3 if name.startswith("_ZN") else 2
    while at < len(name) and name[at].isdigit():
        digits = re.match(r"\d+", name[at:]).group()
        at += len(digits) + int(digits)
        part = name[at - int(digits):at]
        if part.endswith("_kernel"):
            m = _MANGLED_ARGS.match(name, at)
            return _key(part, [v for _, v in _MANGLED_ARG.findall(
                m.group(1) if m else "")])
    return name


def ptxas_table(log: str) -> dict:
    """{kernel key: registers, shared memory bytes, spill stores and loads}
    of every entry function in `ptxas -v` output."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            rows.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[cur].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[cur].update(registers=int(m.group(1)),
                             smem=int(smem.group(1)) if smem else 0)
    return {kernel_key(k): v for k, v in rows.items() if "registers" in v}


def sass_table(text: str) -> dict:
    """{kernel key: instruction census} of `cuobjdump -sass` output."""
    table = {}
    for mangled, body in sass_functions(text).items():
        ops = [opcode(ins) for _, ins in body]
        census = {"instructions": len(ops)}
        for what in CENSUS:
            census[what] = sum(1 for o in ops if o.startswith(what) and
                               not o.startswith("IMAD.MOV"))
        table[kernel_key(mangled)] = census
    return table


def kernel_table(build_log: str, sass_text: str) -> dict:
    """ptxas_table and sass_table of the BEHZ kernels, merged by key."""
    ptx, sass = ptxas_table(build_log), sass_table(sass_text)
    return {k: {**ptx.get(k, {}), **sass.get(k, {})}
            for k in sorted(set(ptx) | set(sass)) if k.startswith("behz_")}


def launch_of(name, L, K, batch):
    """(sources, destinations, rows) of a BEHZ kernel's launch in one
    mult+relin of `batch` ciphertexts at L data primes, Bsk of K primes
    (behz_tensor: the limbs of its two bases, q and Bsk)."""
    return {"behz_to_bsk": (L, K, 2 * batch),
            "behz_fast_floor": (L, K, 3 * batch),
            "behz_from_bsk": (K - 1, L, 3 * batch),
            "behz_tensor": (L, K, batch)}[name]


def launch_key(name: str, info: dict) -> str:
    """The kernel key of a `behz_kernels.launch_info`."""
    if name == "behz_tensor":
        return "behz_tensor_kernel"
    if info["arg0"] == 0:                 # a warp a tile, KW sources
        return f"{name}_warp_kernel<{info['arg1']}>"
    return f"{name}_kernel<{info['arg0']},{info['arg1']}>"


def fmt_kernel(row: dict) -> str:
    """One kernel's compiler census on one line."""
    if not row:
        return "no ptxas or SASS record"
    return (f"{row.get('registers')} registers, {row.get('smem')} B smem, "
            f"spills {row.get('spill_stores')}/{row.get('spill_loads')} B; "
            f"SASS " + " ".join(f"{k} {row.get(k)}" for k in
                                ("instructions",) + CENSUS))


def shape_params(n, L, t_bits):
    """The parameters of a BEHZ measurement shape (n, L, t bits): t_bits
    None takes BfvParams.create(n) (seed 11) and checks its L, else L data
    primes of 30 bits and t of t_bits bits."""
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.crypto.params import BfvParams
    if t_bits is None:
        params = BfvParams.create(n, seed=11)
        if params.L != L:
            raise ValueError(f"BfvParams.create({n}) has L={params.L}")
        return params
    t = gen_ntt_primes(t_bits, 1, n)[0]
    return BfvParams(n=n, coeff_modulus=gen_ntt_primes(30, L + 1, n,
                                                       exclude=[t]),
                     plain_modulus=t)
