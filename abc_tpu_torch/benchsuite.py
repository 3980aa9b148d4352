"""Staged benchmark suite on one CUDA device (port of abc_tpu/benchsuite.py).

Six configs, each returning one JSON-able dict {"metric", "value", "unit",
...}; `run_suite_dict` runs them and `abc_tpu_torch.bench` embeds the result:

  config 1  cardio end-to-end on the dummy scheme (host only).
  config 2  BFV n=8192 ct·ct multiply + relinearization, ops/s.
  config 3  batched hamming distance (mult+relin, 2 Galois rotations, adds),
            ops/s, with a decrypted pass (slot 0 holds the distance 2).
  config 4  cone-rewriting multiplicative-depth reduction: depth and gate
            count before/after on the named circuits (host only), and the
            16-bit sorting comparator run encrypted before and after the
            rewrite, each on a modulus chain sized by the noise model.
  config 5  CKKS n=32768 (8 + 2 primes, k=2) ct·ct multiply + relin, ops/s.
  config 6  LaplaceSharpening at the reference's own parameters (n=16384,
            4x4) through the whole-program executor, in the reference's CSV
            schema (t_keygen, t_input_encryption, t_computation,
            t_decryption), checked against the plain oracle.

Timing. Configs 2, 3 and 5 chain the op on its own output, v = step(v, y),
and take the median of k_est two-point estimates (utils/timing.py: on a CUDA
device the chains are CUDA graphs timed between CUDA events, so no host time
enters; least and largest estimate reported beside the median, an invalid
measurement is nan). Every step of a chain does the whole op's work: the
contexts' identity-keyed caches are emptied per step (otherwise the
transforms of the fixed operand y, or the warm-up's, would be served to
later steps), and on a CUDA device the kernel launches of every step are
asserted while the chain is captured. Configs 4 and 6 time `run_raw` of a
captured program between CUDA events (copies in, one replay, clones out).

Every config takes `device`, "cuda" by default. A CUDA device that is not
there raises; the CPU is a caller's choice (the tests make it, at small
sizes given as arguments) and its times are host-clock times of eager
chains, labelled "timer": "host". The reference's `vs_baseline` fields
(ratios to stand-in rates of another machine) are left out.
"""

from __future__ import annotations

import json
import math
import random
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from abc_tpu_torch.ops import ntt_kernels
from abc_tpu_torch.utils.timing import estimates, repeated, timer_of

# chain lengths: one n=8192 mult+relin step is 110 graph nodes at k=1 and
# the CKKS op 181 (385 and 213 before the BEHZ kernels, for which these
# lengths were chosen to keep a graph under 10 000 nodes)
_CHAIN = {2: 24, 3: 12, 5: 32}
# what `fast` (the bench's own run of the suite) and `quick` (the smoke run)
# pass instead of the defaults
_FAST_KW = {
    2: {"chain": 16},
    3: {"chain": 8},
    5: {"chain": 16},
}
_QUICK_KW = {
    2: {"chain": 8, "k_est": 3},
    3: {"chain": 4, "k_est": 3},
    4: {"repeats": 3},
    5: {"chain": 8, "k_est": 3},
    6: {"runs": 5},
}

LAPLACE_SIZE = 4
LAPLACE_PROGRAM = """
  int weightMatrix = {1, 1, 1, 1, -8, 1, 1, 1, 1};
  secret int img2 = img;
  for (int x = 1; x < imgSize-1; x = x + 1) {
    for (int y = 1; y < imgSize-1; y = y + 1) {
      secret int value = 0;
      for (int j = -1; j < 2; j = j + 1) {
        for (int i = -1; i < 2; i = i + 1) {
          value = value + weightMatrix[(i + 1)*3 + j + 1]
              *img[(x + i)*imgSize + y + j];
        }
      }
      img2[imgSize*x + y] = 2*img[imgSize*x + y] - value;
    }
  }
  return img2;
"""


def require_device(device) -> torch.device:
    """torch.device(device); a CUDA device that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; the "
            "suite measures on the card (pass device='cpu' to run it on the "
            "host at a small size)")
    return dev


def device_label(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def whole_op_chain(ctx, step, census: Optional[Tuple[int, int]] = None):
    """make_chain for utils/timing: c -> (x -> step applied c times), with
    `ctx`'s identity-keyed caches emptied around every step, so that each
    does the whole op's work. census = (forward, inverse) NTT kernel launches
    one step must make: held per step on a CUDA device, where a launch is
    counted while the chain is walked (warm-up and capture)."""
    def make_chain(c):
        def run(x):
            v = x
            for _ in range(c):
                before = dict(ntt_kernels.launches)
                with ctx.fresh_caches():
                    v = step(v)
                made = tuple(ntt_kernels.launches[name] - before[name]
                             for name in ("ntt_fwd", "ntt_inv"))
                if census is not None and v.is_cuda and made != census:
                    raise AssertionError(
                        f"a chain step launched {made} forward/inverse NTT "
                        f"kernels, the whole op launches {census}: the step "
                        "was served from a cache")
            return v
        return run
    return make_chain


def chain_ops_per_s(ctx, step, x0: torch.Tensor, chain: int, k_est: int = 5,
                    census: Optional[Tuple[int, int]] = None,
                    batch: int = 1) -> Dict:
    """ops/s of x -> step(x) chained on its own output (whole_op_chain), by
    the two-point timer; one step is `batch` ops (x0 a batch of independent
    inputs)."""
    med, lo, hi, fixed = estimates(whole_op_chain(ctx, step, census), x0,
                                   chain, k_est)
    return {"value": batch / med, "unit": "ops/s",
            "ops_per_s_min": batch / hi, "ops_per_s_max": batch / lo,
            "ms_per_step": med * 1e3, "fixed_ms": fixed * 1e3,
            "chain": chain, "k_est": k_est, "timer": timer_of(x0),
            "ntt_launches_per_step": census and list(census)}


# --------------------------------------------------------------------------
def config1_cardio_dummy(device="cuda") -> Dict:
    """Cardio risk score: parse → circuit lowering → dummy-scheme run. Host
    only: `device` is not read."""
    from abc_tpu_torch.cli import run_benchmark
    r = run_benchmark("cardio", backend="dummy", slots=1024, runs=3)
    return {"metric": "config1_cardio_dummy_e2e",
            "value": r["t_computation"], "unit": "ms", "timer": "host",
            "correct": r["_outputs"]["riskScore"][0] == 5,
            "note": "host only (dummy scheme); best t_computation of 3 runs"}


def config2_bfv_mult_relin(chain: int = _CHAIN[2], device="cuda",
                           n: int = 8192, k_est: int = 5) -> Dict:
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams

    dev = require_device(device)
    ctx = BfvContext(BfvParams.create(n, seed=123), dev)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a, b = ctx.encrypt_many([ctx.encode([1, 2, 3, 4]),
                             ctx.encode([5, 6, 7, 8])])
    got = ctx.decode(ctx.decrypt(ctx.multiply(a, b)))[:4]

    def step(x):
        return ctx.multiply(BfvCiphertext(x), BfvCiphertext(b.data)).data

    rec = chain_ops_per_s(ctx, step, a.data, chain, k_est, census=(5, 3))
    rec.update(metric=f"config2_bfv_n{n}_mult_relin ({device_label(dev)})",
               correct=got == [5, 12, 21, 32],
               note="dependent chain v = multiply(v, y), every step the "
                    "whole op (caches emptied per step)")
    return rec


def config3_batched_hamming(chain: int = _CHAIN[3], device="cuda",
                            n: int = 8192, k_est: int = 5) -> Dict:
    """Batched hamming distance over 4 packed slots: d = (x−y)²,
    rotate-reduce with 2 Galois rotations: one mult+relin + 2 rotations + 3
    adds per iteration (the reference's HammingDistanceTest workload,
    compiled by the batching pass to exactly this op sequence)."""
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams

    dev = require_device(device)
    ctx = BfvContext(BfvParams.create(n, seed=7), dev)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    for steps in (1, 2):
        ctx.get_galois_key(pow(3, steps, 2 * n))
    x, y = ctx.encrypt_many([ctx.encode([1, 1, 0, 1]),
                             ctx.encode([1, 0, 1, 1])])

    def hamming(xd):
        d = ctx.sub(BfvCiphertext(xd), BfvCiphertext(y.data))
        sq = ctx.multiply(d, d)
        s = ctx.add(sq, ctx.rotate_rows(sq, 2))
        s = ctx.add(s, ctx.rotate_rows(s, 1))
        return s.data

    # correctness of one pass (slot 0 holds the distance = 2), outside the
    # timed chains: decrypt synchronises with the host
    with ctx.fresh_caches():
        got = ctx.decode(ctx.decrypt(BfvCiphertext(hamming(x.data))))[0]
    # a square transforms its one operand once (2 forward launches), then
    # the relin decomposition and one per rotation; inverse: 2 tensor
    # products, the relin and one per rotation
    rec = chain_ops_per_s(ctx, hamming, x.data, chain, k_est, census=(5, 5))
    rec.update(metric=f"config3_batched_hamming_n{n} ({device_label(dev)})",
               correct=got == 2,
               note="per op: 1 ct-ct mult+relin + 2 Galois rotations + adds")
    return rec


def _cone_measured_runtime(bits: int = 16, n: int = 2048, t_bits: int = 14,
                           repeats: int = 5, device="cuda") -> Dict:
    """Execute sorting_gt{bits} ENCRYPTED before and after cone rewriting,
    each on a modulus chain sized by the noise model: the depth win
    converted into a measured runtime win.

    Protocol: & → mult, ^ → add over Z_t (exact ring re-interpretation,
    passes/cone_rewriter.arithmetize_netlist), the whole program as one CUDA
    graph, `run_raw` timed between CUDA events: median of `repeats` with the
    least and largest. Gate: decrypted outputs equal before vs after (the
    rewrite is a ring identity)."""
    from abc_tpu_torch import circuits
    from abc_tpu_torch.crypto.bfv import BfvContext
    from abc_tpu_torch.crypto.noise import analyze_circuit, \
        estimate_noise_bits
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.parser import Parser
    from abc_tpu_torch.passes.cone_rewriter import (
        arithmetize_netlist, program_mult_depth, run_cone_rewriting,
    )
    from abc_tpu_torch.passes.pipeline import (
        CompiledProgram, input_types_from_ast,
    )
    from abc_tpu_torch.passes.type_checking import run_type_checking
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import JittedProgram

    dev = require_device(device)
    src = circuits.sorting_comparator(bits)
    input_ast = Parser.parse(circuits.sorting_comparator_inputs(bits))
    output_ast = Parser.parse("out = gt;")
    itypes = input_types_from_ast(input_ast)

    result: Dict = {}
    decrypted = {}
    for mode in ("before", "after"):
        ast = Parser.parse(src)
        if mode == "after":
            run_cone_rewriting(ast, flow_select=True)
        depth = program_mult_depth(ast)
        arithmetize_netlist(ast)
        tcv = run_type_checking(ast, itypes)
        compiled = CompiledProgram(ast=ast, tcv=tcv, input_types=itypes)
        need = estimate_noise_bits(analyze_circuit(compiled), n, t_bits) \
            + t_bits + 10
        limbs = max(2, math.ceil(need / 30))
        t = gen_ntt_primes(t_bits, 1, n)[0]
        primes = gen_ntt_primes(30, limbs + 1, n, exclude=[t])
        ctx = BfvContext(BfvParams(n=n, coeff_modulus=primes,
                                   plain_modulus=t, seed=77), dev)
        jp = JittedProgram(compiled, BfvCiphertextFactory(context=ctx),
                           input_ast, output_ast)
        decrypted[mode] = jp.run()["out"][0]
        med, lo, hi = repeated(lambda: jp.run_raw(jp.secret_inputs), repeats,
                               dev)
        result[mode] = {"depth": depth, "data_limbs": limbs,
                        "ms_per_eval": med * 1e3,
                        "ms_per_eval_min": lo * 1e3,
                        "ms_per_eval_max": hi * 1e3,
                        "evals_per_s": 1.0 / med,
                        "device_bytes": jp.device_bytes}
        del jp, ctx
    result["decrypt_equal"] = decrypted["before"] == decrypted["after"]
    result["measured_speedup"] = (result["before"]["ms_per_eval"]
                                  / result["after"]["ms_per_eval"])
    result["timer"] = "cuda_events" if dev.type == "cuda" else "host"
    result["protocol"] = (
        f"sorting_gt{bits} arithmetized over Z_t (t={t_bits} bits), "
        f"n={n}, chain sized per-variant by crypto/noise.py; run_raw of the "
        f"captured program, median of {repeats}")
    return result


def config4_cone_rewriting(measure_runtime: bool = True, device="cuda",
                           **measured_kw) -> Dict:
    """Multiplicative-depth reduction on the NAMED boolean circuits
    (BASELINE config 4: "chi-squared / sorting"): the chi-squared test
    statistic, the 16-bit sorting comparator (greater-than ripple chain),
    and a 4x4-bit odd-even sorting network. Flow-based minimum-cone
    selection (Aubry Alg. 3) vs the greedy fallback: reports depth
    before/after AND the gate cost (mul/AND gates added) of each."""
    from abc_tpu_torch import circuits
    from abc_tpu_torch.ast_ir.nodes import (Assignment, Return,
                                            VariableDeclaration)
    from abc_tpu_torch.parser import Parser
    from abc_tpu_torch.passes.cone_rewriter import (
        mul_gate_count, program_mult_depth, run_cone_rewriting,
    )

    if measure_runtime:
        require_device(device)

    def stats(ast):
        gates = 0
        for s in ast.iter_preorder():
            e = None
            if isinstance(s, Assignment):
                e = s.value
            elif isinstance(s, VariableDeclaration) and s.value is not None:
                e = s.value
            elif isinstance(s, Return) and s.value is not None:
                e = s.value
            if e is not None:
                gates += mul_gate_count(e)
        return program_mult_depth(ast), gates

    out = {}
    t0 = time.perf_counter()
    for name, src in (("chi_squared", circuits.chi_squared()),
                      ("sorting_gt16", circuits.sorting_comparator(16)),
                      ("sorting_gt32", circuits.sorting_comparator(32)),
                      ("cardio_netlist", circuits.cardio_netlist()),
                      ("sorting_network_4x4", circuits.sorting_network(4, 4))):
        row = {}
        for mode, flow in (("flow", True), ("greedy", False)):
            ast = Parser.parse(src)
            d0, g0 = stats(ast)
            cr = run_cone_rewriting(ast, flow_select=flow)
            d1, g1 = stats(ast)
            row[mode] = {"depth": [d0, d1], "gates": [g0, g1],
                         "rewrites": cr.rewrites_applied}
        out[name] = row
    compile_ms = (time.perf_counter() - t0) * 1e3

    d0, d1 = out["sorting_gt16"]["flow"]["depth"]
    rec = {"metric": "config4_cone_rewriting_mult_depth",
           "value": d1, "unit": "mult-depth (sorting_gt16)",
           "depth_before": d0,
           "circuits": out,
           "compile_ms": compile_ms,
           "note": "flow = Aubry Alg. 3 minimum vertex cut over C^AND; "
                   "greedy = deepest-first fallback. gates = mul/AND "
                   "count before/after (the cost of the depth saved)"}
    if measure_runtime:
        rec["measured"] = _cone_measured_runtime(device=device, **measured_kw)
    return rec


def sharded_word_exact(device="cuda", n: int = 32768, levels: int = 8,
                       coeff_shards: int = 8) -> Dict:
    """The coefficient-sharded multiply + relin (parallel/dist_ckks.py) at
    k=1 on `coeff_shards` shards of one device (LocalComm): its words
    against CkksContext.multiply(a, b, rescale=False) on the same
    encryptions. Untimed, as in the reference."""
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu_torch.parallel.mesh import coeff_mesh

    dev = require_device(device)
    ctx = CkksContext(CkksParams.create(n, levels=levels, seed=3), dev)
    dist = DistCkksMultiplier(ctx, coeff_mesh(coeff_shards, device=dev))
    vals = np.random.default_rng(1).uniform(-1.0, 1.0, 16)
    a = ctx.encrypt(ctx.encode(vals))
    b = ctx.encrypt(ctx.encode(vals[::-1].copy()))
    want = ctx.multiply(a, b, rescale=False).data
    return {"word_exact": bool(torch.equal(dist(a.data, b.data), want)),
            "k": 1, "n": n, "levels": levels, "coeff_shards": coeff_shards,
            "collectives": dict(dist.mesh.census)}


def config5_ckks_sharded(chain: int = _CHAIN[5], device="cuda",
                         n: int = 32768, levels: int = 8, k_est: int = 5
                         ) -> Dict:
    """The CKKS ct·ct multiply + relinearization: timed on one device at
    k=2, and, as the reference's second half, the coefficient-sharded
    multiply held word for word at k=1 on 8 shards of the device
    (sharded_word_exact; untimed)."""
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.ops.modarith import as_residues

    dev = require_device(device)
    # hybrid key switching (ks_digits=2) halves the relin decomposition:
    # ceil(8/2)*(8+2) = 40 forward-NTT rows vs 8*9 = 72 at k=1
    params = CkksParams.create(n, levels=levels, seed=3, ks_digits=2)
    ctx = CkksContext(params, dev)
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    L = params.L
    rng = np.random.default_rng(0)
    ct = as_residues(rng.integers(0, 2 ** 29, size=(2, L, n),
                                  dtype=np.uint64), dev)

    def step(x):
        a = CkksCiphertext(x, L, params.scale)
        return ctx.multiply(a, a, rescale=False).data

    # correctness of the op on a real encryption, outside the timed chains
    vals = rng.uniform(-1.0, 1.0, 16)
    enc = ctx.encrypt(ctx.encode(vals))
    sq = ctx.multiply(enc, enc, rescale=False)
    z = np.real(ctx.decode(ctx.decrypt(sq)))[:len(vals)]
    rec = chain_ops_per_s(ctx, step, ct, chain, k_est, census=(3, 2))
    sharded = sharded_word_exact(dev, n, levels)
    rec.update(metric=f"config5_ckks_n{n}_mult_relin ({device_label(dev)})",
               correct=bool(np.allclose(z, vals ** 2, atol=1e-2))
               and sharded["word_exact"],
               sharded=sharded,
               note="hybrid ks_digits=2 relin timed on one device; the "
                    "coefficient-sharded multiply word-exact at k=1 on 8 "
                    "shards of it (`sharded`), untimed")
    return rec


def laplace_oracle(img, size=LAPLACE_SIZE):
    weights = [1, 1, 1, 1, -8, 1, 1, 1, 1]
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            conv = sum(weights[(i + 1) * 3 + j + 1] *
                       img[(x + i) * size + (y + j)]
                       for j in range(-1, 2) for i in range(-1, 2))
            want[x * size + y] = 2 * img[x * size + y] - conv
    return want


def config6_laplace_n16384_e2e(device="cuda", slots: int = 16384,
                               runs: int = 10, passes: int = 2) -> Dict:
    """Encrypted LaplaceSharpening end-to-end at the REFERENCE's parameters
    (n=16384, MATRIX_SIZE=4, LaplaceSharpeningTest.cpp:17,151-161): parse →
    type-check → execute with secret index reads/writes → decrypt, checked
    against the plain oracle. Reported in the reference's own CSV schema
    (t_keygen, t_input_encryption, t_computation, t_decryption).

    The flow runs `passes` times and the last pass gives the CSV: the first
    carries the process's first use of every kernel and table. t_keygen =
    factory + switching-key census and build, t_input_encryption = batched
    device encryption of the secret inputs (+ eval_ready), t_computation =
    `run_raw` of the captured program between CUDA events (median of
    `runs`, least and largest beside it), t_decryption on the host clock.
    The one-off cost of making the graph (`warmup`, `capture`) stands where
    the reference reports its compile time."""
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program

    dev = require_device(device)
    size = LAPLACE_SIZE
    rng = random.Random(7)
    img = [rng.randrange(0, 256) for _ in range(size * size)]
    inputs_src = ("secret int img = {" + ",".join(map(str, img)) + "};"
                  f" int imgSize = {size};")

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def flow():
        t0 = clock()
        factory = BfvCiphertextFactory(slots=slots, seed=23, device=dev)
        t_factory = (clock() - t0) * 1e3
        jp = jit_compile_program(LAPLACE_PROGRAM, inputs_src, "out = img2;",
                                 factory=factory)
        ph = dict(jp.phase_ms)
        ph["factory_ctor"] = t_factory
        got = jp.run()["out"][:size * size]
        comp = repeated(lambda: jp.run_raw(jp.secret_inputs), runs, dev)
        raw = jp.run_raw(jp.secret_inputs)
        dec = repeated(lambda: jp.decrypt_outputs(raw), 5, "cpu")
        return got, ph, comp, dec, jp.device_bytes

    for _ in range(passes):
        got, ph, comp, dec, device_bytes = flow()
    assert got == laplace_oracle(img), "laplace e2e decrypt mismatch"

    t_keygen = ph["factory_ctor"] + ph.get("key_census", 0) + \
        ph.get("key_build", 0)
    t_enc = ph.get("encrypt", 0) + ph.get("eval_ready", 0)
    return {"metric": f"config6_laplace_n{slots}_e2e ({device_label(dev)})",
            "value": comp[0] * 1e3, "unit": "ms t_computation",
            "t_computation_min": comp[1] * 1e3,
            "t_computation_max": comp[2] * 1e3,
            "csv_schema": {"t_keygen": t_keygen,
                           "t_input_encryption": t_enc,
                           "t_computation": comp[0] * 1e3,
                           "t_decryption": dec[0] * 1e3},
            "warmup_ms": ph.get("warmup", 0.0),
            "capture_ms": ph.get("capture", 0.0),
            "program_setup_ms": ph.get("parse_compile", 0) +
            ph.get("setup_other", 0),
            "setup_phase_ms": ph,
            "device_bytes": device_bytes,
            "correct": True,
            "timer": "cuda_events" if dev.type == "cuda" else "host",
            "note": "decrypted output verified against the plain oracle; "
                    f"CSV phases are those of pass {passes} of {passes}; "
                    "t_computation = run_raw of the captured program (copy "
                    f"in, one replay, clone out), median of {runs}"}


CONFIGS = {
    1: config1_cardio_dummy,
    2: config2_bfv_mult_relin,
    3: config3_batched_hamming,
    4: config4_cone_rewriting,
    5: config5_ckks_sharded,
    6: config6_laplace_n16384_e2e,
}


def run_suite_dict(configs=None, fast: bool = False, device="cuda",
                   quick: bool = False) -> Dict[str, Dict]:
    """Run the staged suite and return {config name: result dict}. A config
    that raises is recorded as {"error": ...} and the suite goes on, so that
    one bad config does not lose the rest; callers must treat an "error" as
    a failure (bench.main exits non-zero on one). A CUDA device that is not
    there raises here, before any config runs."""
    require_device(device)
    table = _QUICK_KW if quick else _FAST_KW if fast else {}
    out: Dict[str, Dict] = {}
    for k in sorted(configs or CONFIGS):
        kw = dict(table.get(k, {}), device=device)
        try:
            out[f"config{k}"] = CONFIGS[k](**kw)
        except Exception as exc:  # recorded, never hidden: see the docstring
            out[f"config{k}"] = {"metric": f"config{k} (failed)",
                                 "value": float("nan"), "unit": "-",
                                 "error": f"{type(exc).__name__}: "
                                          f"{str(exc)[:200]}"}
    return out


def run_suite(configs=None, device="cuda") -> None:
    for result in run_suite_dict(configs, device=device).values():
        print(json.dumps(result), flush=True)
