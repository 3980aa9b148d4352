"""What the compiler made of the package's kernels, read from the text that
`_build` keeps: `ptxas -v` output (`_build.build_log`) and `cuobjdump -sass`
(`_build.sass()`).

Generic: `sass_functions` and `opcode` (the SASS of each function),
`ptxas_table` (registers, shared memory and spills of each entry function)
and `kernel_key` (one name for a kernel, mangled or demangled);
`kernel_table` (both tables merged, for the kernels of one source: the BEHZ
kernels of csrc/behz.cu, the key-switch kernels of csrc/keyswitch.cu, the
key generation, encryption and decryption kernels of csrc/rlwe.cu by the
prefix RLWE, the elementwise kernels of csrc/elementwise.cu by "rns_ew_",
the mesh kernels of csrc/mesh.cu by MESH)
and `fmt_kernel`. For the BEHZ kernels: `launch_of` and `launch_key` (which
instantiation a launch of one mult+relin runs, as
`behz_kernels.launch_info` reports it) and `shape_params`, the parameters
of a measured shape; for the key-switch kernels `ks_launch_key`, for the
elementwise ones `ew_launch_key`, for rlwe_lift and bfv_dec_round
`rlwe_launch_key`. Host-only text parsing; imports no
CUDA toolkit and no JAX.
"""

from __future__ import annotations

import re

# instructions counted per kernel in the SASS census: IMAD of every kind but
# IMAD.MOV (a move), IMAD.WIDE, global and shared loads and stores,
# barriers, and subroutine calls (CALL: the 64-bit division and remainder
# routines are called so)
CENSUS = ("IMAD", "IMAD.WIDE", "LDG", "STG", "LDS", "STS", "BAR", "CALL")

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


# the key generation, encryption and decryption kernels of csrc/rlwe.cu, a
# prefix of kernel_table
RLWE = ("rns_uniform", "ksk_compose", "rlwe_lift", "bfv_dec_round")
# the mesh kernels of csrc/mesh.cu (each a template over its direction or
# its source words), a prefix of kernel_table
MESH = ("dist_ntt_combine", "rns_psum_mod")


def kernel_table(build_log: str, sass_text: str,
                 prefix="behz_") -> dict:
    """ptxas_table and sass_table of the kernels whose names start with
    `prefix` (the BEHZ kernels, "ks_", or a tuple of names such as RLWE),
    merged by key."""
    ptx, sass = ptxas_table(build_log), sass_table(sass_text)
    return {k: {**ptx.get(k, {}), **sass.get(k, {})}
            for k in sorted(set(ptx) | set(sass)) if k.startswith(prefix)}


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


def ks_launch_key(name: str, info: dict) -> str:
    """The kernel key of a `keyswitch_kernels.mod_down_plan` or `.plan`:
    ks_mod_down, and its forms with a tail, are instantiated by their
    largest number of special primes and their kept rows a thread,
    ks_decompose by the sources it holds in registers, ks_contract by its
    lanes a quad and its halves (one lane a quad: the streaming kernel, not
    a template)."""
    if name == "ks_contract" and info["arg0"] == 1:
        return f"{name}_stream_kernel"
    if name.startswith("ks_mod_down") or name == "ks_contract":
        return f"{name}_kernel<{info['arg0']},{info['arg1']}>"
    return f"{name}_kernel<{info['arg0']}>"


def ew_launch_key(name: str, info: dict) -> str:
    """The kernel key of an `elementwise_kernels.launch_info`: each op is
    instantiated by its quads a thread."""
    return f"{name}_kernel<{info['arg0']}>"


def rlwe_launch_key(name: str, info: dict) -> str:
    """The kernel key of an `rlwe_kernels.launch_info`: rlwe_lift is
    instantiated by its limb rows a thread; the others are no templates."""
    if name == "rlwe_lift":
        return f"{name}_kernel<{info['arg0']}>"
    return f"{name}_kernel"


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
