#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (abc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

The port is self-contained, so nothing here can ask the JAX package for an
oracle. The card's results are held against (i) each kernel's plain torch
version on the card, (ii) the port's own CPU run of the same seed, word for
word, (iii) the plaintext oracle after decryption and (iv) golden SHA-256
digests of the reference's words, stored in
abc_tpu_torch/testdata/golden.json (tests/test_torch_golden.py recomputes
them from abc_tpu's np64 engine).

Phases, each of which raises on failure (the script then exits nonzero):

1. Build the kernels from abc_tpu_torch/csrc with nvcc (sm_90a), one nvcc
   per source, started together.
2. Kernel vs plain: ntt_fwd / ntt_inv against their plain torch versions on
   the card (torch.equal) at every n in {1024 .. 32768} x rows in {1, 12,
   14, 16, 18, 24, 42, 112, 896}, inputs holding 0 and q-1, so that every
   cluster size (1, 2, 4, 8 CTAs per row) is launched; inv(fwd(x)) == x;
   every main-path launch shape runs on at least 96 CTAs; the launch shapes
   of a batched mult+relin at n=8192 (B x 12, 16, 42, 18, 24, 14 rows at B
   in {8, 16, 64}: up to 2688 rows). Then, at the main
   path's launch shapes and the ablation's, kernel and plain times in CUDA
   events (median of 10 calls, warm L2) and the profiler's device time,
   beside the bound: the larger of bytes moved over 3.35 TB/s and integer
   multiply-adds over 132 SMs x 64 per clock x 1.98 GHz.
3. BFV mult+relin at n=8192 (6 data primes, k=1 and k=2): keys,
   ciphertexts and result on the card equal to the port's CPU context of
   the same seed and to the golden digests; one multiply of fresh operands
   launches exactly 5 forward and 3 inverse transforms (154 limb rows at
   k=1); ms per op; device time per named elementwise chain (the
   torch.profiler ranges of ops/modarith.chain_range), with the kernels
   under the ranges counted against all kernels of the profile.
4. The main path: the README hamming program, compiled by the port's passes
   and run encrypted through run_compiled with the port's factory at
   n=8192. Kernel launch counts are taken over this run alone. Its output
   words equal the CPU run and the golden digest, and decrypt to 2.
5. LaplaceSharpening at the reference's parameters (n=16384, 13 data
   primes): decrypts equal to the plain oracle, rotations share one hoisted
   decomposition, both kernels launched; phase times.
6. Keys on the card: a fresh factory (keygen) and every Galois key that
   LaplaceSharpening used, timed, equal to phase 5's keys.
7. NTT ablation and ALU calibration: every mode of ablate_ntt torch.equal to
   its plain version at (n, L, B) = (16384, 14, 1) and (8192, 6, 3), the
   four NTT modes also equal to ntt_fwd; both alu_chain kinds at
   [14, 128, 128] x 512 iterations equal to their plain versions. Then the
   path itself: `python -m abc_tpu_torch.scripts.ntt_ablation --quick`'s
   measurement, with the ablation module's launch counts taken over it
   alone, the SASS check that the ALU chains were not folded, and its JSON
   on one line.
8. Whole-program execution (jit_compile_program / JittedProgram: the
   program as one CUDA graph). The README hamming program at n=8192 with
   phase 4's seed: run() decrypts to 2, the raw output words equal phase
   4's eager words and the golden digest; kernel launch counts are taken
   over this path alone (they move at set-up, warm-up and capture only),
   and a profiled replay holds as many NTT kernels as one eager walk of the
   program launches.
   Serving: three fresh input pairs through encrypt_inputs -> run_raw ->
   decrypt_outputs, each equal to the plain oracle and, word for word, to an
   eager executor run on the same ciphertexts, with ntt_kernels.launches and
   context.counters unchanged across the replays. auto_params=True chooses
   the same parameter set on the card as on the CPU, with the same words.
   LaplaceSharpening at n=16384 (phase 5's seed) as a graph: words equal to
   phase 5's, phase_ms, bytes of the graph's pool, ms per replay beside
   phase 5's second eager run. mult+relin at n=8192, k=1 as a graph (words
   equal to phase 3's op on the same operands): ms per replay beside phase 3's eager
   ms/op and device-kernel total. `python -m abc_tpu_torch hamming -
   --backend bfv --slots 8192` as a subprocess.

9. CKKS at the reference's own CKKS size (n=32768, 8 data + 2 special
   primes of 30 bits, k=2, scale 2^25; abc_tpu/benchsuite.py config 5).
   Views: ntt_fwd / ntt_inv through leveled NttContext.subset views against
   their plain versions (torch.equal) at the op's launch shapes (16, 40
   rows forward; 24, 20 inverse) and at level 3 (9 and 10 rows), with times
   and the bound at the op's shapes. The op: multiply(a, a, rescale=False),
   eager: public key, relinearization key, ciphertext and result equal to
   the port's CPU run and the golden digests; 3 forward launches of 16, 16,
   40 rows and 2 inverse of 24, 20; ms/op; device time by kernel name. A
   leveled run at scale 2^29 (multiply with rescale, a second multiply at
   level 7 with its partial last digit, rotate and hoisted rotations of it,
   its rescale): words equal to the CPU run, decoded values against numpy. As a graph: the op
   itself and `p = a *** b; p = rotate(p, 1);` through jit_compile_program
   (words equal to the eager run and the CPU run, a replay on fresh inputs
   against numpy, no counter moving across replays, phase_ms, device_bytes,
   ms per replay), and one float program under auto_params=True. The packed
   matvec: matvec_bsgs_ckks at n=2048 (1024 x 1024) against numpy, one
   hoisted decomposition for the baby steps. Kernel launch counts are taken
   over this phase's driven path alone (the view comparisons come first).

10. The measurement entry point. The batch contract on the card: at B=8,
   multiply and rotate_rows of [B, 2, L, n] equal B separate calls word for
   word, and row 0 of the product equals the golden digest. Then `python -m
   abc_tpu_torch.bench --quick` in process (abc_tpu_torch/bench.py: the NTT
   and mult+relin batch curves at B in {1, 8, 16, 64}, the mult+relin floor,
   the six staged configs of abc_tpu_torch/benchsuite.py, every chain step
   held to its 5 + 3 launches while it is captured): no config may carry
   an error, config 3 must be correct, config 4's variants must decrypt
   alike, config 6 must equal the plain oracle, no headline value may be
   nan, the compact line must stay under 1500 characters. Its two lines are
   printed; kernel launch counts are taken over the bench alone.

Needs one CUDA device; exits nonzero at once without one. Imports nothing of
JAX or of abc_tpu. Prints the card's name and power limit, a
{"kernels": [...]} JSON line, and last {"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# LaplaceSharpening as the reference runs it (abc_tpu/benchsuite.py config 6)
LAPLACE = """
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
MAIN_N = 8192        # the bench headline preset: 6 data primes, t of 20 bits
LAPLACE_N = 16384    # the reference's own end-to-end parameters: 13 primes
LAPLACE_SEED = 23
# (n, L, batch) timed in phase 2: the launches of one n=8192 mult+relin
# (forward 12, 16, 12, 16, 42 rows; inverse 18, 24, 14) and the ablation's
NTT_SHAPES = [(8192, 6, 2), (8192, 8, 2), (8192, 7, 6), (8192, 6, 3),
              (8192, 8, 3), (8192, 7, 2), (16384, 14, 1), (16384, 14, 8)]
# the largest forward (key-switch decomposition, 42 rows) and inverse (Bsk
# tensor product, 24 rows) transform of one n=8192 mult+relin
JSON_SHAPE = {"ntt_fwd": (8192, 7, 6), "ntt_inv": (8192, 8, 3)}
MAIN_ROWS = (12, 14, 16, 18, 24, 42)     # per launch on the main path
SWEEP_N = (1024, 2048, 4096, 8192, 16384, 32768)
SWEEP_ROWS = ((1, 1), (12, 6), (14, 7), (16, 8), (18, 6), (24, 8), (42, 7),
              (112, 14), (896, 14))      # (rows, L)
# the launches of one n=8192 mult+relin on a batch of B ciphertexts, (rows
# per ciphertext, L): the bench's mult+relin curve launches B times these
BATCH_ROWS = ((12, 6), (16, 8), (42, 7), (18, 6), (24, 8), (14, 7))
BATCH_SIZES = (8, 16, 64)
# The card's rates for the bound: device memory (NVIDIA's data sheet) and
# 32-bit integer multiply-adds, 132 SMs x 64 per clock x 1.98 GHz (the SM
# clock read under load), the ceiling that alu_chain calibrates against.
HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
IMAD_PER_BUTTERFLY = 3                   # one Shoup product
REPLACES = {
    "ntt_fwd": "abc_tpu/ops/pallas_ntt.py:265 (_fwd_kernel via "
               "pallas_fwd_ntt :417, pallas_fwd_ntt_fp :440)",
    "ntt_inv": "abc_tpu/ops/pallas_ntt.py:309 (_inv_kernel via "
               "pallas_inv_ntt :469, pallas_inv_ntt_fp :496)",
    "ablate_ntt": "scripts/ntt_ablation.py:85 (_ablate_kernel via "
                  "ablate_ntt :178)",
    "alu_chain": "scripts/ntt_ablation.py:201 (_alu_mac_kernel), :210 "
                 "(_alu_shoup_kernel) via alu_chain :221",
}
SOURCE = {"ntt_fwd": "abc_tpu_torch/csrc/ntt.cu",
          "ntt_inv": "abc_tpu_torch/csrc/ntt.cu",
          "ablate_ntt": "abc_tpu_torch/csrc/ntt_ablation.cu",
          "alu_chain": "abc_tpu_torch/csrc/ntt_ablation.cu"}
# CKKS at the reference's own size (abc_tpu/benchsuite.py config 5): the
# launches of one multiply(a, a, rescale=False) as (kernel, level, with the
# special primes, batch): forward 2 x 8 = 16 rows (each operand) and 4 x 10 =
# 40 (key-switch decomposition), inverse 3 x 8 = 24 (tensor product) and 2 x
# 10 = 20 (key-switch accumulators); then the shapes of a key switch at
# level 3 (3 and 5 rows per component)
CKKS_OP_SHAPES = [("ntt_fwd", 8, False, 2), ("ntt_fwd", 8, True, 4),
                  ("ntt_inv", 8, False, 3), ("ntt_inv", 8, True, 2)]
CKKS_LOW_SHAPES = [("ntt_fwd", 3, False, 3), ("ntt_fwd", 3, True, 2),
                   ("ntt_inv", 3, False, 3), ("ntt_inv", 3, True, 2)]
CKKS_CENSUS = [("ntt_fwd", 16), ("ntt_fwd", 16), ("ntt_inv", 24),
               ("ntt_fwd", 40), ("ntt_inv", 20)]       # in launch order
# the shapes the kernels line reports for CKKS: the largest forward and
# inverse launch of the op
CKKS_JSON_SHAPE = {"ntt_fwd": (8, True, 4), "ntt_inv": (8, False, 3)}
CKKS_MATVEC_N = 2048
CKKS_DEPTH2 = ("secret double acc = w0 * w1; acc = acc + rotate(w0, 1); "
               "acc = acc * w1; return acc;")
ABLATION_SHAPES = [(16384, 14, 1), (8192, 6, 3)]
ALU_SHAPE, ALU_ITERS = (14, 128, 128), 512
# where the kernels line times the ablation kernels: mode / kind
ABLATION_TIMED = {"ablate_ntt": "full", "alu_chain": "shoup"}


def cuda_ms(fn, reps=10):
    """Median time of one fn() call in ms between CUDA events (after a
    warm-up): device time plus any host time the call adds between them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_profile(fn, reps=5):
    """Device kernels of fn() from torch.profiler, per call: (total kernel
    ms, kernel launches, {kernel name: ms}, {kernel name: launches}); None
    where the profiler saw no device activity in three tries (a trace now
    and then comes back empty)."""
    from torch.profiler import ProfilerActivity, profile
    from abc_tpu_torch.ops.modarith import CHAIN_PREFIX
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, counts, launches = {}, {}, 0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "memcpy" in ev.name.lower() or "memset" in ev.name.lower() \
                    or ev.name.startswith(CHAIN_PREFIX):
                continue
            launches += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3 / reps
            counts[ev.name] = counts.get(ev.name, 0) + 1 / reps
        if launches:
            return sum(by_name.values()), launches / reps, by_name, counts
    return None


def chain_profile(fn, reps=3):
    """Device time of eager fn() per named elementwise chain, per call:
    {chain: [ms, kernels]} and the number of device kernels in the profile.
    A kernel belongs to the innermost ops/modarith.chain_range that was open
    when it was launched (matched through the launch call of the same
    correlation id); the hand-written NTT kernels are one row of their own,
    kernels launched outside every range another, and kernels whose launch
    call the profiler did not record a third (it loses events on long eager
    runs), so that the rows always add up to the kernels seen."""
    from torch.profiler import ProfilerActivity, profile
    from abc_tpu_torch.ops.modarith import CHAIN_PREFIX
    on_card = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name[len(
        CHAIN_PREFIX):]) for ev in events
        if ev.device_type != on_card and ev.name.startswith(CHAIN_PREFIX)]
    launched_at = {ev.id: ev.time_range.start for ev in events
                   if ev.device_type != on_card
                   and ev.name.startswith(("cudaLaunch", "cuLaunch"))}
    table, kernels = {}, 0
    for ev in events:
        if ev.device_type != on_card or ev.name.startswith(CHAIN_PREFIX) \
                or "memcpy" in ev.name.lower() or "memset" in ev.name.lower():
            continue
        kernels += 1
        at = launched_at.get(ev.id)
        if "ntt_" in ev.name:
            where = "NTT kernels"
        elif at is None:
            where = "(launch not recorded)"
        else:
            inside = [r for r in ranges if r[0] <= at <= r[1]]
            where = min(inside, key=lambda r: r[1] - r[0])[2] if inside \
                else "(outside the ranges)"
        row = table.setdefault(where, [0.0, 0.0])
        row[0] += ev.device_time_total / 1e3 / reps
        row[1] += 1 / reps
    return table, kernels / reps, len(ranges) / reps


def fmt_chains(chains, expect_kernels):
    """The per-chain table on one line, largest first, and whether its
    kernels add up to what one op launches."""
    table, kernels, n_ranges = chains
    total = sum(ms for ms, _ in table.values())
    rows = "; ".join(f"{name} {ms:.4f} ms ({100 * ms / total:.1f}%) in "
                     f"{count:.1f}" for name, (ms, count) in sorted(
                         table.items(), key=lambda kv: -kv[1][0]))
    lost = table.get("(launch not recorded)", [0.0, 0.0])[1]
    return (f"{total:.4f} ms in {kernels:.1f} kernels per op under "
            f"{n_ranges:.0f} ranges ({expect_kernels} kernels expected; "
            f"{lost:.1f} without a launch record): {rows}")


def fmt(prof):
    if prof is None:
        return "not measured"
    return f"{prof[0]:.4f} ms in {prof[1]:.0f} kernels"


def fmt_ntt(prof):
    """fmt plus the share of the hand-written NTT kernels."""
    if prof is None:
        return "not measured"
    ntt = sum(v for name, v in prof[2].items() if "ntt_" in name)
    count = sum(c for name, c in prof[3].items() if "ntt_" in name)
    return f"{fmt(prof)}, of which NTT {ntt:.4f} ms in {count:.0f}"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def digest(t):
    """SHA-256 of a tensor's uint32 words, little-endian, C order (the
    recipe of abc_tpu_torch/testdata/golden.json)."""
    from abc_tpu_torch.ops.modarith import to_host
    words = np.ascontiguousarray(to_host(t.contiguous()), dtype="<u4")
    return hashlib.sha256(words.tobytes()).hexdigest()


def golden():
    import abc_tpu_torch
    path = os.path.join(os.path.dirname(abc_tpu_torch.__file__), "testdata",
                        "golden.json")
    with open(path) as f:
        return json.load(f)


def bound(n_bytes, imads):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the multiply-adds over the
    integer rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S * 1e3, imads / IMAD_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def ntt_bound(n, L, rows, inverse):
    """Bound of one transform launch: rows in and out, the [L, n] twiddle
    and companion tables and q (and n^-1 with its companion) read once;
    n/2 log2(n) butterflies per row, and the n^-1 scale of the inverse."""
    n_bytes = 4 * (2 * rows * n + 2 * L * n + L + (2 * L if inverse else 0))
    products = rows * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))
    return bound(n_bytes, IMAD_PER_BUTTERFLY * products)


def rand_residues(moduli, shape, seed, device):
    from abc_tpu_torch.ops.modarith import as_residues
    q = np.asarray(moduli, dtype=np.uint64).reshape(len(moduli), 1)
    rng = np.random.default_rng(seed)
    return as_residues(rng.integers(0, q, size=shape, dtype=np.uint64),
                       device)


def _transforms(nk, ctx, x):
    """{kernel name: (kernel call, plain call)} on input x."""
    return {
        "ntt_fwd": (lambda: nk.ntt_fwd(x, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh),
                    lambda: nk.fwd_ntt_plain(x, ctx.q, ctx.fwd_tw)),
        "ntt_inv": (lambda: nk.ntt_inv(x, ctx.q, ctx.inv_tw, ctx.inv_tw_sh,
                                       ctx.n_inv, ctx.n_inv_sh),
                    lambda: nk.inv_ntt_plain(x, ctx.q, ctx.inv_tw,
                                             ctx.n_inv)),
    }


def phase_kernels(dev):
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_kernels as nk

    stats = {k: {"max_abs_err": 0} for k in nk.launches}

    def hold(name, got, want, at):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(torch.equal(got, want), f"{name} != plain at {at}")

    # every n x rows, with 0 and q-1 among the inputs
    clusters = {}
    for n in SWEEP_N:
        seen = []
        for rows, L in SWEEP_ROWS:
            moduli = gen_ntt_primes(30, L, n)
            ctx = NttContext(n, moduli, dev)
            x = rand_residues(moduli, (rows // L, L, n), seed=n + rows,
                              device=dev)
            x[..., 0] = 0
            x[..., 1::257] = (ctx.q - 1).reshape(L, 1)
            for name, (kern, plain) in _transforms(nk, ctx, x).items():
                hold(name, kern(), plain(), (n, rows))
            back = ctx.inv(ctx.fwd(x))
            check(torch.equal(back, x), f"inv(fwd(x)) != x at {n, rows}")
            c = nk.cluster_size(rows, n)
            clusters[c] = clusters.get(c, 0) + 1
            seen.append(f"{rows}:{c}")
        print(f"  n={n}: ntt_fwd, ntt_inv = plain and inv(fwd(x)) = x at "
              f"rows:CTAs-per-row {' '.join(seen)}", flush=True)
    check(set(clusters) == {1, 2, 4, 8},
          f"cluster sizes launched: {clusters}")
    # the launch shapes of a batched mult+relin (the bench's curve)
    seen = []
    for B in BATCH_SIZES:
        for rows, L in BATCH_ROWS:
            moduli = gen_ntt_primes(30, L, MAIN_N)
            ctx = NttContext(MAIN_N, moduli, dev)
            x = rand_residues(moduli, (B * rows // L, L, MAIN_N),
                              seed=B + rows, device=dev)
            x[..., 0] = 0
            x[..., 1::257] = (ctx.q - 1).reshape(L, 1)
            for name, (kern, plain) in _transforms(nk, ctx, x).items():
                hold(name, kern(), plain(), (MAIN_N, B * rows))
            seen.append(f"{B * rows}:{nk.cluster_size(B * rows, MAIN_N)}")
    print(f"  n={MAIN_N}, batched mult+relin shapes (B in {BATCH_SIZES}): "
          f"ntt_fwd, ntt_inv = plain at rows:CTAs-per-row {' '.join(seen)}",
          flush=True)
    ctas = {rows: rows * nk.cluster_size(rows, MAIN_N) for rows in MAIN_ROWS}
    check(min(ctas.values()) >= 96, f"main-path launches on {ctas} CTAs")
    print(f"  shapes per cluster size {clusters}; main-path launches "
          f"(n={MAIN_N}) rows -> CTAs {ctas}", flush=True)

    # times at the main path's launch shapes and the ablation's
    for n, L, batch in NTT_SHAPES:
        moduli = gen_ntt_primes(30, L, n)
        ctx = NttContext(n, moduli, dev)
        x = rand_residues(moduli, (batch, L, n), seed=n + L + batch,
                          device=dev)
        rows = L * batch
        line = [f"n={n} L={L} batch={batch} ({rows} rows x "
                f"{nk.cluster_size(rows, n)} CTAs):"]
        for name, (kern, plain) in _transforms(nk, ctx, x).items():
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            prof = kernel_profile(kern)
            b_ms, b_by = ntt_bound(n, L, rows, name == "ntt_inv")
            line.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f} ms) "
                        f"[device: {fmt(prof)}; bound {b_ms:.5f} ms by "
                        f"{b_by}]")
            if JSON_SHAPE[name] == (n, L, batch):
                plain_prof = kernel_profile(plain)
                stats[name].update(
                    ms=ms, plain_ms=plain_ms, device_ms=prof and prof[0],
                    plain_device_ms=plain_prof and plain_prof[0],
                    bound_ms=b_ms, bound_by=b_by)
                line.append(f"[plain device: {fmt(plain_prof)}]")
        print("  " + "  ".join(line), flush=True)
    return stats


def phase_mult_relin(dev, k, gold):
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import ntt_kernels as nk

    params = BfvParams.create(gold["n"], seed=gold["seed"], ks_digits=k)
    ctx, cpu = BfvContext(params, dev), BfvContext(params, "cpu")
    a, b = ctx.encrypt_many([ctx.encode(gold["a"]), ctx.encode(gold["b"])])
    ca, cb = cpu.encrypt_many([cpu.encode(gold["a"]), cpu.encode(gold["b"])])
    got, want = ctx.multiply(a, b), cpu.multiply(ca, cb)
    relin, cpu_relin = ctx.get_relin_key(), cpu.get_relin_key()
    words = {"pk_b": (ctx.pk_b_ntt, cpu.pk_b_ntt),
             "pk_a": (ctx.pk_a_ntt, cpu.pk_a_ntt),
             "relin_b": (relin[0], cpu_relin[0]),
             "relin_a": (relin[1], cpu_relin[1]),
             "ct_a": (a.data, ca.data), "ct_b": (b.data, cb.data),
             "result": (got.data, want.data)}
    for name, (on_card, on_cpu) in words.items():
        check(torch.equal(on_card.cpu(), on_cpu),
              f"k={k}: {name} on the card != the port's CPU run")
        check(digest(on_card) == gold[name],
              f"k={k}: {name} != golden digest (abc_tpu np64)")
    expect = [x * y for x, y in zip(gold["a"], gold["b"])]
    check(ctx.decode(ctx.decrypt(got))[:len(expect)] == expect,
          f"mult+relin k={k} decrypt")
    before = dict(nk.launches)
    fresh = [BfvCiphertext(a.data.clone()), BfvCiphertext(b.data.clone())]
    ctx.multiply(*fresh)
    torch.cuda.synchronize()
    d_fwd = nk.launches["ntt_fwd"] - before["ntt_fwd"]
    d_inv = nk.launches["ntt_inv"] - before["ntt_inv"]
    check((d_fwd, d_inv) == (5, 3),
          f"k={k}: {d_fwd} fwd / {d_inv} inv launches per mult+relin")
    ms = cuda_ms(lambda: ctx.multiply(BfvCiphertext(a.data.clone()),
                                      BfvCiphertext(b.data.clone())), reps=20)
    print(f"  k={k}: keys, ciphertexts and result word-identical to the CPU "
          f"run and the golden digests, decrypts {expect}; {d_fwd} fwd + "
          f"{d_inv} inv launches per op; {ms:.3f} ms/op (median of 20, fresh "
          f"operands)", flush=True)
    prof = kernel_profile(lambda: ctx.multiply(BfvCiphertext(a.data.clone()),
                                               BfvCiphertext(b.data.clone())))
    print(f"  k={k} device kernels per op: {fmt(prof)}", flush=True)
    chains = chain_profile(lambda: ctx.multiply(
        BfvCiphertext(a.data.clone()), BfvCiphertext(b.data.clone())))
    print(f"  k={k} device time per chain (eager profile with host ranges): "
          + fmt_chains(chains, "385" if k == 1 else "463"), flush=True)
    if prof is None:
        return ms, None
    ntt = sum(v for name, v in prof[2].items() if "ntt_" in name)
    top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
    print(f"    NTT kernels {ntt:.4f} ms; busy share of the op "
          f"{prof[0] / ms:.3f}; top: " + "; ".join(
              f"{name[:60]} {v:.4f} ms" for name, v in top), flush=True)
    return ms, prof[0]


def run_dsl(factory, inputs_src, program_src, output_src):
    """Parse, compile and execute under RuntimeVisitor, as run_compiled
    does; returns the output ciphertext and the host-clock times (ms) of
    input encryption and computation."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast)
    from abc_tpu_torch.runtime.executor import RuntimeVisitor

    inputs = Parser.parse(inputs_src)
    compiled = compile_program(program_src, input_types_from_ast(inputs),
                               CompileOptions())
    t0 = time.perf_counter()
    rv = RuntimeVisitor(factory, inputs, compiled.secret_tainted)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rv.execute_ast(compiled.ast)
    ct = rv.get_output(Parser.parse(output_src))[0][1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ct, {"input_encryption": (t1 - t0) * 1e3,
                "computation": (t2 - t1) * 1e3}


def readme_hamming(factory, gold):
    """The README quick start: compile_program (vectorized) -> run_compiled
    with `factory`; returns the output ciphertext."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast, run_compiled)

    inputs = Parser.parse(gold["inputs"])
    compiled = compile_program(gold["program"], input_types_from_ast(inputs),
                               CompileOptions(vectorize=True))
    _, outputs = run_compiled(compiled, inputs, Parser.parse(gold["output"]),
                              factory)
    return outputs[0][1]


def phase_hamming(dev, gold):
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    factory = BfvCiphertextFactory(slots=gold["n"], seed=gold["seed"],
                                   device=dev)
    for name in nk.launches:
        nk.launches[name] = 0
    t0 = time.perf_counter()
    ct = readme_hamming(factory, gold)
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) * 1e3
    launches = dict(nk.launches)
    hd = factory.decrypt(ct)[0]
    cpu_factory = BfvCiphertextFactory(slots=gold["n"], seed=gold["seed"],
                                       device="cpu")
    cpu_ct = readme_hamming(cpu_factory, gold)
    check(all(v > 0 for v in launches.values()),
          f"main path launched a kernel no time: {launches}")
    check(torch.equal(ct.ct.data.cpu(), cpu_ct.ct.data),
          "hamming output on the card != the port's CPU run")
    check(digest(ct.ct.data) == gold["result"],
          "hamming output != golden digest (abc_tpu np64 factory)")
    check(factory.context.counters == cpu_factory.context.counters,
          "hamming op counters differ between card and CPU")
    check(hd == 2, f"hamming decrypts to {hd}")
    print(f"  hamming n={gold['n']}: decrypts to {hd}, word-identical to "
          f"the CPU run and the golden digest; launches {launches}; "
          f"counters {factory.context.counters}; run_compiled {t_run:.1f} ms "
          f"(host clock: encryption, switching-key builds and evaluation)",
          flush=True)
    return launches, ct.ct.data


LAPLACE_SIZE = 4


def laplace_image(seed):
    import random
    rng = random.Random(seed)
    return [rng.randrange(0, 256) for _ in range(LAPLACE_SIZE ** 2)]


def laplace_inputs(img):
    return ("secret int img = {" + ",".join(map(str, img)) + "};"
            f" int imgSize = {LAPLACE_SIZE};")


def laplace_oracle(img):
    size, weights = LAPLACE_SIZE, [1, 1, 1, 1, -8, 1, 1, 1, 1]
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            conv = sum(weights[(i + 1) * 3 + j + 1] *
                       img[(x + i) * size + (y + j)]
                       for j in range(-1, 2) for i in range(-1, 2))
            want[x * size + y] = 2 * img[x * size + y] - conv
    return want


def phase_laplace(dev):
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    size = LAPLACE_SIZE
    img = laplace_image(7)
    inputs_src, want = laplace_inputs(img), laplace_oracle(img)

    before = dict(nk.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory = BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                                   device=dev)
    torch.cuda.synchronize()
    t_keygen = (time.perf_counter() - t0) * 1e3
    ct, first = run_dsl(factory, inputs_src, LAPLACE, "out = img2;")
    t0 = time.perf_counter()
    got = factory.decrypt(ct)[:size * size]
    t_dec = (time.perf_counter() - t0) * 1e3
    check(got == want, f"laplace decrypt {got} != oracle {want}")
    c = dict(factory.context.counters)
    check(c["decomp_hit"] > c["decomp"], f"no hoisting: {c}")
    launched = {k: nk.launches[k] - before[k] for k in before}
    check(all(v > 0 for v in launched.values()), f"laplace: {launched}")
    _, steady = run_dsl(factory, inputs_src, LAPLACE, "out = img2;")
    print(f"  laplace n={LAPLACE_N}: decrypts equal to the oracle; counters "
          f"{c}; launches {launched}", flush=True)
    print(f"  phases (host clock, ms): factory+keygen {t_keygen:.1f}, input "
          f"encryption {first['input_encryption']:.1f}, computation "
          f"{first['computation']:.1f} (first run: builds "
          f"{len(factory.context._keys)} switching keys on the card), "
          f"computation again with keys built {steady['computation']:.1f}, "
          f"decryption {t_dec:.1f}", flush=True)
    return factory.context, ct.ct.data, steady["computation"]


def phase_keys(dev, used):
    """A fresh factory of LaplaceSharpening's parameters and seed, then
    every switching key that program used (`used`: phase 5's context), all
    built on the card and timed on the host clock."""
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    ids = sorted(used._keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                               device=dev).context
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    keys = ctx.materialize_keys(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for name, a, b in [("s", ctx.s_ntt_full, used.s_ntt_full),
                       ("pk_b", ctx.pk_b_ntt, used.pk_b_ntt)] + \
            [(kid, keys[kid][0], used._keys[kid][0]) for kid in ids]:
        check(torch.equal(a, b), f"{name}: same seed, another key")
    mb = sum(t.numel() * 4 for pair in keys.values() for t in pair) / 2 ** 20
    print(f"  n={LAPLACE_N}: factory+keygen {(t1 - t0) * 1e3:.1f} ms, "
          f"{len(ids)} switching keys ({mb:.0f} MiB) "
          f"{(t2 - t1) * 1e3:.1f} ms, {(t2 - t1) * 1e3 / len(ids):.1f} ms "
          f"per key, all on the card (host clock); equal to phase 5's",
          flush=True)


def _timed(stats, kern, plain, at, bound_of):
    """Kernel and plain times (CUDA events and profiler) and the bound into
    stats."""
    stats["ms"], stats["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
    prof, plain_prof = kernel_profile(kern), kernel_profile(plain)
    stats["device_ms"] = prof and prof[0]
    stats["plain_device_ms"] = plain_prof and plain_prof[0]
    stats["bound_ms"], stats["bound_by"] = bound_of
    stats["at"] = at
    return (f"{stats['ms']:.4f} ms (plain {stats['plain_ms']:.4f} ms) "
            f"[device: {fmt(prof)}; plain {fmt(plain_prof)}; bound "
            f"{stats['bound_ms']:.5f} ms by {stats['bound_by']}]")


def phase_ablation(dev):
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_ablation as na
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import as_residues
    from abc_tpu_torch.scripts import ntt_ablation as script

    stats = {k: {"max_abs_err": 0} for k in na.launches}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(torch.equal(got, want), what)

    for n, L, batch in ABLATION_SHAPES:
        moduli = gen_ntt_primes(30, L, n)
        ctx = NttContext(n, moduli, dev)
        x = rand_residues(moduli, (batch, L, n), seed=n + 2 * L + batch,
                          device=dev)
        fwd = nk.ntt_fwd(x, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
        for mode in na.MODES:
            got = na.ablate_ntt(x, ctx, mode)
            hold("ablate_ntt", got,
                 na.ablate_ntt_plain(x, ctx.q, ctx.fwd_tw, mode),
                 f"ablate_ntt {mode} != plain at {n, L, batch}")
            if mode in na.NTT_MODES:
                hold("ablate_ntt", got, fwd,
                     f"ablate_ntt {mode} != ntt_fwd at {n, L, batch}")
        line = f"  n={n} L={L} batch={batch}: {len(na.MODES)} modes = plain"
        if (n, L, batch) == ABLATION_SHAPES[0]:
            mode = ABLATION_TIMED["ablate_ntt"]
            line += f"; {mode}: " + _timed(
                stats["ablate_ntt"], lambda: na.ablate_ntt(x, ctx, mode),
                lambda: na.ablate_ntt_plain(x, ctx.q, ctx.fwd_tw, mode),
                [n, L, batch], ntt_bound(n, L, L * batch, False))
        print(line, flush=True)

    rng = np.random.default_rng(12)
    xa = as_residues(rng.integers(0, 1 << 32, size=ALU_SHAPE,
                                  dtype=np.uint64), dev)
    for kind in na.ALU_KINDS:
        hold("alu_chain", na.alu_chain(xa, kind, ALU_ITERS),
             na.alu_chain_plain(xa, kind, ALU_ITERS),
             f"alu_chain {kind} != plain")
    kind = ABLATION_TIMED["alu_chain"]
    print(f"  alu_chain {'/'.join(na.ALU_KINDS)} {list(ALU_SHAPE)} x "
          f"{ALU_ITERS} = plain; {kind}: " + _timed(
              stats["alu_chain"], lambda: na.alu_chain(xa, kind, ALU_ITERS),
              lambda: na.alu_chain_plain(xa, kind, ALU_ITERS),
              list(ALU_SHAPE) + [ALU_ITERS],
              # words in and out; 3 multiply-adds per word and iteration
              bound(2 * 4 * xa.numel(), 3 * xa.numel() * ALU_ITERS)),
          flush=True)

    # the path: the ablation script's measurement, counted alone
    for name in na.launches:
        na.launches[name] = 0
    result = script.run(quick=True,
                        log=lambda *a: print("   ", *a, flush=True))
    torch.cuda.synchronize()
    launches = dict(na.launches)
    check(all(v > 0 for v in launches.values()),
          f"the ablation path launched a kernel no time: {launches}")
    chains = result["census"]["alu_chain"]
    check(not any(c["folded"] for c in chains.values()),
          f"ALU chains folded by the compiler: {chains}")
    times = [result[m]["us_per_fwd"] for m in script.MAIN_MODES + (
        "shipping",)] + [result[f"alu_{k}"]["us_per_launch"]
                         for k in na.ALU_KINDS]
    check(all(np.isfinite(t) and t > 0 for t in times),
          f"ablation times not positive: {times}")
    print("  SASS: " + ", ".join(
        f"alu_{k} {c['ops_per_iter']} IMAD / {c['instructions_per_iter']} "
        f"instructions per iteration (not folded)"
        for k, c in chains.items()) + "; per butterfly: " + ", ".join(
            f"{what} {c['instructions_per_butterfly']:.1f} instructions, "
            f"{c['alu_per_butterfly']:.1f} ALU"
            for what, c in (("full (one stage per barrier)",
                             result["census"]),
                            ("ntt_fwd (three stages per pass)",
                             result["census"]["shipping"])))
        + f"; launches {launches}", flush=True)
    print(json.dumps({"ntt_ablation": result}), flush=True)
    return stats, launches


def replay_ms(jp, tensors, reps):
    """(median ms of one run_raw between CUDA events, "spread max M, iqr Q":
    the largest distance of a run from that median and the interquartile
    range, both relative to the median)."""
    jp.run_raw(tensors)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        jp.run_raw(tensors)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return med, (f"spread max {max(abs(t - med) for t in times) / med:.3f}, "
                 f"iqr {(q3 - q1) / med:.3f}")


def unchanged_across(jp, tensors):
    """run_raw(tensors) with every Python-side counter held still."""
    from abc_tpu_torch.ops import ntt_kernels as nk
    before = dict(nk.launches), dict(jp.factory.context.counters), \
        jp._graph
    raw = jp.run_raw(tensors)
    torch.cuda.synchronize()
    check((dict(nk.launches), dict(jp.factory.context.counters),
           jp._graph) == before,
          "a replay moved a launch or op counter, or made a new graph")
    return raw


def walk_launches(jp):
    """Kernel launches of one eager walk of the program."""
    from abc_tpu_torch.ops import ntt_kernels as nk
    before = dict(nk.launches)
    jp.run_eager(jp.secret_inputs)
    return {k: nk.launches[k] - before[k] for k in before}


def replay_profile(jp, tensors, per_walk, reps=5):
    """kernel_profile of a replay, which must hold exactly the NTT
    kernels that one walk of the program launches: the hand-written
    kernels are inside the graph, and nothing else took their place."""
    from abc_tpu_torch.ops import ntt_kernels as nk
    prof = kernel_profile(lambda: jp.run_raw(tensors), reps)
    check(prof is not None,
          "the profiler saw no device activity in a replay, three times")
    in_graph = {name: round(sum(
        c for kernel, c in prof[3].items() if name in kernel))
        for name in nk.launches}
    check(in_graph == per_walk,
          f"a replay runs {in_graph} NTT kernels, one walk of the "
          f"program launches {per_walk}")
    return prof


def phase_whole_program(dev, gold, hamming_words, laplace_words,
                        laplace_eager_ms, mult_eager):
    from abc_tpu_torch import CompileOptions, jit_compile_program
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    # --- the README hamming program as one graph, n=8192
    g = gold["hamming_n8192"]
    factory = BfvCiphertextFactory(slots=g["n"], seed=g["seed"], device=dev)
    for name in nk.launches:
        nk.launches[name] = 0
    jp = jit_compile_program(g["program"], g["inputs"], g["output"],
                             factory=factory,
                             options=CompileOptions(vectorize=True))
    raw = jp.run_raw(jp.secret_inputs)
    torch.cuda.synchronize()
    launches = dict(nk.launches)
    out_name = next(iter(raw))
    check(all(v > 0 for v in launches.values()),
          f"the whole-program path launched a kernel no time: {launches}")
    per_walk = walk_launches(jp)
    check(torch.equal(raw[out_name], hamming_words),
          "hamming as a graph != phase 4's eager words")
    check(digest(raw[out_name]) == g["result"],
          "hamming as a graph != golden digest (abc_tpu np64 factory)")
    hd = jp.run()[out_name][0]
    check(hd == 2, f"hamming as a graph decrypts to {hd}")
    prof = replay_profile(jp, jp.secret_inputs, per_walk)
    ms, spread = replay_ms(jp, jp.secret_inputs, 20)
    print(f"  hamming n={g['n']}: run() decrypts to {hd}; raw words equal to "
          f"phase 4's eager run and the golden digest; launches on this "
          f"path {launches} (encryption, key builds, warm-up and capture; "
          f"one walk of the program {per_walk}, and a profiled replay holds "
          f"exactly those); phase_ms "
          f"{ {k: round(v, 1) for k, v in jp.phase_ms.items()} }; "
          f"device bytes {jp.device_bytes}; replay {ms:.3f} ms (CUDA events, "
          f"median of 20, {spread}); device: {fmt(prof)}",
          flush=True)

    # --- serving: fresh inputs through the same graph
    for x, y in (([0, 0, 0, 0], [1, 1, 1, 1]), ([1, 0, 1, 0], [1, 0, 1, 0]),
                 ([1, 1, 1, 0], [0, 1, 0, 0])):
        fresh = jp.encrypt_inputs({"x": x, "y": y})
        raw = unchanged_across(jp, fresh)
        got = jp.decrypt_outputs(raw)[out_name][0]
        want = sum(int(a != b) for a, b in zip(x, y))
        check(got == want, f"serving {x} {y}: {got} != oracle {want}")
        check(torch.equal(raw[out_name], jp.run_eager(fresh)[out_name]),
              f"serving {x} {y}: replay != eager run on the same ciphertexts")
    held = jp.run_raw(jp.secret_inputs)[out_name]
    jp.run_raw(fresh)
    check(torch.equal(held, hamming_words),
          "a later run_raw overwrote an earlier result")
    print("  serving: 3 fresh input pairs, each equal to the oracle and to "
          "an eager run on the same ciphertexts; no launch or op counter "
          "moved across the replays; one graph", flush=True)

    # --- auto_params: the same choice and the same words as the CPU run
    auto = {d: jit_compile_program(
        g["program"], g["inputs"], g["output"], auto_params=True, device=d,
        seed=g["seed"], security_strict=True,
        options=CompileOptions(vectorize=True)) for d in (dev, "cpu")}
    check(auto[dev].auto_params == auto["cpu"].auto_params,
          f"auto_params on the card {auto[dev].auto_params} != on the CPU "
          f"{auto['cpu'].auto_params}")
    raw = auto[dev].run_raw(auto[dev].secret_inputs)[out_name]
    check(torch.equal(
        raw.cpu(), auto["cpu"].run_raw(auto["cpu"].secret_inputs)[out_name]),
        "auto_params: words on the card != the port's CPU run")
    hd = auto[dev].run()[out_name][0]
    check(hd == 2, f"auto_params hamming decrypts to {hd}")
    print(f"  auto_params: {auto[dev].auto_params} on card and CPU alike; "
          f"words equal; decrypts to {hd}", flush=True)
    del auto

    # --- LaplaceSharpening n=16384 as one graph
    factory = BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                                   device=dev)
    img = laplace_image(7)
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    jp = jit_compile_program(LAPLACE, laplace_inputs(img), "out = img2;",
                             factory=factory)
    raw = jp.run_raw(jp.secret_inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - allocated0
    check(torch.equal(raw["out"], laplace_words),
          "laplace as a graph != phase 5's eager words")
    img2 = laplace_image(8)
    fresh = jp.encrypt_inputs({"img": img2})
    raw = unchanged_across(jp, fresh)
    got = jp.decrypt_outputs(raw)["out"][:LAPLACE_SIZE ** 2]
    check(got == laplace_oracle(img2),
          f"laplace replay on a fresh image {got} != oracle")
    check(torch.equal(raw["out"], jp.run_eager(fresh)["out"]),
          "laplace replay != eager run on the same ciphertext")
    ms, spread = replay_ms(jp, fresh, 10)
    per_walk = walk_launches(jp)
    prof = replay_profile(jp, fresh, per_walk, reps=2)
    print(f"  laplace n={LAPLACE_N}: words equal to phase 5's; a fresh image "
          f"equal to the oracle and to an eager run; phase_ms "
          f"{ {k: round(v, 1) for k, v in jp.phase_ms.items()} }; device "
          f"bytes {jp.device_bytes}, peak allocated while building and "
          f"running it {peak} above what phases 5-6 still hold; host "
          f"constants on the tape "
          f"{len(jp._tape.items)}; replay {ms:.3f} ms (CUDA events, median "
          f"of 10, fresh input, {spread}) beside phase 5's "
          f"second eager run {laplace_eager_ms:.1f} ms (host clock); "
          f"device: {fmt_ntt(prof)}, the NTT kernels of one walk "
          f"{per_walk}", flush=True)
    del jp, factory

    # --- mult+relin n=8192 k=1 as one graph: the multiply leaves size 3
    # (lazy relin), the rotation by 0 asks for size 2 and rotates nothing
    g = gold["mult_relin_n8192_k1"]
    factory = BfvCiphertextFactory(slots=g["n"], seed=g["seed"], device=dev)
    jp = jit_compile_program(
        "secret int p = a *** b; p = rotate(p, 0);",
        "secret int a = {%s}; secret int b = {%s};" % (
            ",".join(map(str, g["a"])), ",".join(map(str, g["b"]))),
        "y = p;", factory=factory)
    per_walk = walk_launches(jp)
    check(per_walk == {"ntt_fwd": 5, "ntt_inv": 3},
          f"mult+relin as a program: {per_walk} launches per walk")
    fresh = jp.encrypt_inputs({"a": g["b"], "b": g["a"]})
    raw = unchanged_across(jp, fresh)
    check(torch.equal(raw["y"], factory.context.multiply(
        BfvCiphertext(fresh["a"]), BfvCiphertext(fresh["b"])).data),
        "mult+relin as a graph != BfvContext.multiply on the same operands")
    ms, spread = replay_ms(jp, fresh, 20)
    prof = replay_profile(jp, fresh, per_walk)
    eager_ms, eager_dev = mult_eager
    print(f"  mult+relin n={g['n']} k=1 as a graph: words equal to "
          f"BfvContext.multiply (phase 3's op); {ms:.3f} ms per replay (CUDA events, median of "
          f"20, fresh operands, {spread}; two copies in, one "
          f"clone out) beside phase 3's eager {eager_ms:.3f} ms/op and its "
          f"device-kernel total "
          f"{'not measured' if eager_dev is None else f'{eager_dev:.4f} ms'}"
          f"; replay device: {fmt_ntt(prof)}"
          + f", busy share {prof[0] / ms:.3f}"
          + f"; phase_ms { {k: round(v, 1) for k, v in jp.phase_ms.items()} }"
          f"; device bytes {jp.device_bytes}", flush=True)

    # --- the CLI (per-op executor) in a process of its own
    proc = subprocess.run(
        [sys.executable, "-m", "abc_tpu_torch", "hamming", "-", "--backend",
         "bfv", "--slots", str(MAIN_N)], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr}")
    check(len(lines) == 2 and lines[0] == "t_keygen,t_input_encryption,"
          "t_computation,t_decryption" and len(lines[1].split(",")) == 4
          and all(float(v) > 0 for v in lines[1].split(",")),
          f"CLI CSV: {proc.stdout!r}")
    check("sum: [2" in proc.stderr, f"CLI stderr: {proc.stderr!r}")
    print(f"  python -m abc_tpu_torch hamming - --backend bfv --slots "
          f"{MAIN_N}: exit 0, {lines[0]} = {lines[1]} (ms, host clock, "
          f"first run of its process), sum: [2 ...", flush=True)
    return launches


def ckks_leveled(ctx, vals):
    """The leveled run on one context: multiply with rescale (level 8 ->
    7), a second multiply at level 7 (k=2: the last digit holds one prime,
    alpha = 4 over 7 limbs) left at its product scale, a rotation and
    hoisted rotations of it (Galois key switches through the same partial
    digit), and its rescale to level 6. Returns the ciphertexts by name."""
    x = ctx.encrypt(ctx.encode(vals))
    m1 = ctx.multiply(x, x)
    m2 = ctx.multiply(m1, x, rescale=False)
    out = {"x": x, "x^2": m1, "x^3": m2, "rot1": ctx.rotate(m2, 1)}
    for steps, ct in zip((2, -3, 0), ctx.hoisted_rotations(m2, [2, -3, 0])):
        out[f"hoisted{steps}"] = ct
    out["x^3 rescaled"] = ctx.rescale(m2)
    return out


def phase_ckks(dev, gold):
    from abc_tpu_torch import jit_compile_program
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.crypto.linalg import matvec_bsgs_ckks
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory

    g = gold["ckks_mult_relin_n32768_k2"]
    n, L, k = g["n"], g["levels"], g["ks_digits"]

    def make_params(**kw):
        return CkksParams.create(n, levels=L, seed=g["seed"], ks_digits=k,
                                 **kw)

    params = make_params()
    ctx, cpu = CkksContext(params, dev), CkksContext(params, "cpu")
    stats = {}

    # --- views: the kernels through leveled views against their plain
    # versions, at the op's launch shapes and at level 3
    for name, level, specials, batch in CKKS_OP_SHAPES + CKKS_LOW_SHAPES:
        view = (ctx._ntt_cols if specials else ctx._ntt_level)[level]
        rows = batch * len(view.moduli)
        x = rand_residues(view.moduli, (batch, len(view.moduli), n),
                          seed=level + rows, device=dev)
        x[..., 0] = 0
        x[..., 1::257] = (view.q - 1).reshape(-1, 1)
        kern, plain = _transforms(nk, view, x)[name]
        check(torch.equal(view.fwd(x) if name == "ntt_fwd" else view.inv(x),
                          plain()),
              f"{name} through the level-{level} view != plain at {rows} "
              f"rows")
        line = (f"  {name} level {level}{' + specials' if specials else ''}"
                f", {rows} rows x {nk.cluster_size(rows, n)} CTAs = plain")
        if (name, level, specials, batch) in CKKS_OP_SHAPES:
            st = {}
            line += ": " + _timed(
                st, kern, plain, [n, len(view.moduli), batch],
                ntt_bound(n, len(view.moduli), rows, name == "ntt_inv"))
            if CKKS_JSON_SHAPE[name] == (level, specials, batch):
                stats[name] = st
        print(line, flush=True)

    # --- the config-5 op, eager; launch counts from here on
    for name in nk.launches:
        nk.launches[name] = 0
    a, ca = ctx.encrypt(ctx.encode(g["a"])), cpu.encrypt(cpu.encode(g["a"]))
    got = ctx.multiply(a, a, rescale=False)
    want = cpu.multiply(ca, ca, rescale=False)
    relin, cpu_relin = ctx.get_relin_key(), cpu.get_relin_key()
    for name, (on_card, on_cpu) in {
            "pk_b": (ctx.pk_b_ntt, cpu.pk_b_ntt),
            "pk_a": (ctx.pk_a_ntt, cpu.pk_a_ntt),
            "relin_b": (relin[0], cpu_relin[0]),
            "relin_a": (relin[1], cpu_relin[1]),
            "ct_a": (a.data, ca.data),
            "result": (got.data, want.data)}.items():
        check(torch.equal(on_card.cpu(), on_cpu),
              f"CKKS {name} on the card != the port's CPU run")
        check(digest(on_card) == g[name],
              f"CKKS {name} != golden digest (abc_tpu np64)")
    check((got.level, got.scale, got.size) == (L, params.scale ** 2, 2),
          f"CKKS product at level {got.level}, scale {got.scale}")
    check(np.array_equal(ctx.decode(ctx.decrypt(got)),
                         cpu.decode(cpu.decrypt(want))),
          "CKKS decoded product on the card != the port's CPU run")

    def fresh():
        return CkksCiphertext(a.data.clone(), a.level, a.scale)

    seen, launch = [], nk._launch

    def recording(name, x, args):
        seen.append((name, x.numel() // x.shape[-1]))
        return launch(name, x, args)

    nk._launch = recording
    try:
        op = fresh()
        ctx.multiply(op, op, rescale=False)
    finally:
        nk._launch = launch
    torch.cuda.synchronize()
    check(seen == CKKS_CENSUS, f"CKKS op launched {seen}")

    def one_op():
        op = fresh()
        return ctx.multiply(op, op, rescale=False)

    op_ms = cuda_ms(one_op, reps=20)
    prof = kernel_profile(one_op)
    print(f"  config-5 op, n={n}, {L}+{k} primes, k={k}: multiply(a, a, "
          f"rescale=False) with pk, relin key, ciphertext and result "
          f"word-identical to the CPU run and the golden digests; launches "
          f"{seen}; {op_ms:.3f} ms/op (CUDA events, median of 20, fresh "
          f"operands); device: {fmt_ntt(prof)}"
          + ("" if prof is None else
             f", busy share {prof[0] / op_ms:.3f}; top: " + "; ".join(
                 f"{name[:60]} {v:.4f} ms" for name, v in sorted(
                     prof[2].items(), key=lambda kv: -kv[1])[:6])),
          flush=True)
    print("  config-5 op, device time per chain (eager profile with host "
          "ranges): " + fmt_chains(chain_profile(one_op), "213"), flush=True)
    del ctx, cpu, a, ca, got, want, relin, cpu_relin

    # --- a leveled run, at a prime-sized scale so that a rescaled product
    # keeps its precision (CkksParams.create's note: at 2^25 one rescale
    # leaves a scale of 2^20)
    lv_params = make_params(scale_bits=29)
    rng = np.random.default_rng(g["seed"])
    vals = rng.uniform(-1.0, 1.0, 64)
    lv_ctx = CkksContext(lv_params, dev)
    lv_card = ckks_leveled(lv_ctx, vals)
    lv_cpu = ckks_leveled(CkksContext(lv_params, "cpu"), vals)
    cube = vals ** 3
    # name: (first slot read, expected values there); a rotation to the
    # right by 3 puts slot 0 at slot 3
    oracle = {"x": (0, vals), "x^2": (0, vals ** 2), "x^3": (0, cube),
              "rot1": (0, cube[1:]), "hoisted2": (0, cube[2:]),
              "hoisted-3": (3, cube), "hoisted0": (0, cube),
              "x^3 rescaled": (0, cube)}
    worst = 0.0
    for name, ct in lv_card.items():
        other = lv_cpu[name]
        check(torch.equal(ct.data.cpu(), other.data)
              and (ct.level, ct.scale) == (other.level, other.scale),
              f"CKKS leveled run: {name} on the card != the CPU run")
        first, want = oracle[name]
        z = np.real(lv_ctx.decode(lv_ctx.decrypt(ct)))[first:first + len(want)]
        worst = max(worst, float(np.max(np.abs(z - want))))
        # the reference tests' tolerance at depth two (tests/test_ckks.py)
        check(np.allclose(z, want, rtol=2e-2, atol=2e-2),
              f"CKKS leveled run: {name} decodes {z[:4]}, oracle {want[:4]}")
    levels = {name: ct.level for name, ct in lv_card.items()}
    check([levels[name] for name in ("x", "x^2", "x^3", "rot1",
                                     "x^3 rescaled")]
          == [L, L - 1, L - 1, L - 1, L - 2],
          f"CKKS leveled run: levels {levels}")
    c = dict(lv_ctx.counters)
    check((c["mult"], c["relin"], c["galois"], c["decomp"], c["decomp_hit"])
          == (2, 2, 3, 1, 1), f"CKKS leveled run: counters {c}")
    print(f"  leveled run (scale 2^29): x^2 rescaled to level {L - 1}; x^3 "
          f"there through the partial-digit key switch ({L - 1} limbs, "
          f"alpha = {lv_ctx._alpha_at(L - 1)}), one rotation and 3 hoisted "
          f"rotations of it, its rescale to level {L - 2}: words equal to "
          f"the CPU run; decoded within 2e-2 of numpy (largest error "
          f"{worst:.2e}); counters {c}", flush=True)
    del lv_ctx, lv_card, lv_cpu

    # --- as a graph: the op itself, then multiply + rotate
    def factory_on(device):
        return CkksCiphertextFactory(context=CkksContext(params, device))

    def brace(values):
        return "{" + ", ".join(repr(float(v)) for v in values) + "}"

    factory = factory_on(dev)
    fctx = factory.context
    jp = jit_compile_program("secret double p = a *** a; p = rotate(p, 0);",
                             f"secret double a = {brace(g['a'])};", "y = p;",
                             factory=factory)
    per_walk = walk_launches(jp)
    check(per_walk == {"ntt_fwd": 3, "ntt_inv": 2},
          f"CKKS op as a program: {per_walk} launches per walk")
    fresh_in = jp.encrypt_inputs({"a": vals})
    raw = unchanged_across(jp, fresh_in)
    op = CkksCiphertext(fresh_in["a"], L, params.scale)
    check(torch.equal(raw["y"], fctx.multiply(op, op, rescale=False).data),
          "CKKS op as a graph != CkksContext.multiply on the same operand")
    z = jp.decrypt_outputs(raw)["y"][:len(vals)]
    check(np.allclose(z, vals ** 2, rtol=1e-2, atol=1e-2),
          f"CKKS op as a graph decrypts {z[:4]}")
    ms, spread = replay_ms(jp, fresh_in, 20)
    prof = replay_profile(jp, fresh_in, per_walk)
    print(f"  config-5 op as a graph: words equal to CkksContext.multiply; "
          f"{ms:.3f} ms per replay (CUDA events, median of 20, fresh "
          f"operand, {spread}; one copy in, one clone out) beside the eager "
          f"{op_ms:.3f} ms/op; replay device: {fmt_ntt(prof)}, busy share "
          f"{prof[0] / ms:.3f}; phase_ms "
          f"{ {k_: round(v, 1) for k_, v in jp.phase_ms.items()} }; device "
          f"bytes {jp.device_bytes}", flush=True)

    a_vals, b_vals = [1.5, 2.0, -0.5, 0.25], [0.5, 0.25, 4.0, -2.0]
    program = dict(program_src="secret double p = a *** b; p = rotate(p, 1);",
                   inputs_src=f"secret double a = {brace(a_vals)}; "
                              f"secret double b = {brace(b_vals)};",
                   output_src="y = p;")
    jp = jit_compile_program(factory=factory, **program)
    jp_cpu = jit_compile_program(factory=factory_on("cpu"), **program)
    raw = jp.run_raw(jp.secret_inputs)
    eager = fctx.rotate(fctx.relinearize(fctx.multiply(
        CkksCiphertext(jp.secret_inputs["a"], L, params.scale),
        CkksCiphertext(jp.secret_inputs["b"], L, params.scale),
        relinearize=False, rescale=False)), 1)
    check(torch.equal(raw["y"], eager.data)
          and torch.equal(raw["y"], jp.run_eager(jp.secret_inputs)["y"]),
          "CKKS program as a graph != the eager run")
    want = [x * y for x, y in zip(a_vals, b_vals)][1:]
    z = jp.run()["y"][:3]
    check(np.allclose(z, want, atol=1e-2), f"CKKS program decrypts {z}")
    per_walk = walk_launches(jp)
    fresh_in = jp.encrypt_inputs({"a": vals, "b": vals[::-1]})
    raw = unchanged_across(jp, fresh_in)
    check(torch.equal(raw["y"], jp.run_eager(fresh_in)["y"]),
          "CKKS program: replay != eager run on the same ciphertexts")
    z = jp.decrypt_outputs(raw)["y"][:len(vals) - 1]
    check(np.allclose(z, (vals * vals[::-1])[1:], atol=1e-2),
          f"CKKS program on fresh inputs decrypts {z[:4]}")
    # the CPU program on the card's own input ciphertexts: the same words
    cpu_raw = jp_cpu.run_raw({name: t.cpu() for name, t in fresh_in.items()})
    check(torch.equal(raw["y"].cpu(), cpu_raw["y"]),
          "CKKS program: words on the card != the port's CPU run")
    ms, spread = replay_ms(jp, fresh_in, 20)
    prof = replay_profile(jp, fresh_in, per_walk)
    print(f"  `{program['program_src']}` as a graph: words equal to the "
          f"eager run and to the CPU run on the same ciphertexts; fresh "
          f"inputs decrypt within 1e-2 of numpy; no launch or op counter "
          f"moved across the replay; one walk launches {per_walk}; "
          f"{ms:.3f} ms per replay (CUDA events, median of 20, {spread}); "
          f"device: {fmt_ntt(prof)}, busy share {prof[0] / ms:.3f}; "
          f"phase_ms { {k_: round(v, 1) for k_, v in jp.phase_ms.items()} }"
          f"; device bytes {jp.device_bytes}", flush=True)
    del jp, jp_cpu, factory, fctx

    # --- one float program under auto_params
    inputs = "secret double w0 = {1.0,2.0}; secret double w1 = {0.5,0.25};"
    auto = {d: jit_compile_program(CKKS_DEPTH2, inputs, "out = acc;",
                                   auto_params=True, device=d, seed=5)
            for d in (dev, "cpu")}
    check(auto[dev].auto_params == auto["cpu"].auto_params
          and auto[dev].auto_params["scheme"] == "ckks",
          f"auto_params on the card {auto[dev].auto_params} != on the CPU "
          f"{auto['cpu'].auto_params}")
    check(auto[dev]._graph is not None, "auto_params: no graph on the card")
    raw = auto[dev].run_raw(auto[dev].secret_inputs)["out"]
    check(torch.equal(
        raw.cpu(), auto["cpu"].run_raw(auto["cpu"].secret_inputs)["out"]),
        "CKKS auto_params: words on the card != the port's CPU run")
    z = auto[dev].run()["out"][:2]
    want = [(1.0 * 0.5 + 2.0) * 0.5, (2.0 * 0.25 + 2.0) * 0.25]
    check(np.allclose(z, want, atol=1e-2), f"CKKS auto_params decrypts {z}")
    print(f"  auto_params (float program, depth 2 with a rotation): "
          f"{auto[dev].auto_params} on card and CPU alike; words equal; "
          f"decrypts {[round(v, 4) for v in z]}", flush=True)
    del auto

    # --- the packed matvec: 1024 x 1024 over the slots of n=2048, at a
    # prime-sized scale (the baby rotations come before the multiplies)
    mv = CkksContext(CkksParams.create(CKKS_MATVEC_N, levels=3, seed=3,
                                       scale_bits=29), dev)
    size = mv.params.slot_count
    mat, vec = rng.uniform(-1, 1, (size, size)), rng.uniform(-1, 1, size)
    ct = mv.encrypt(mv.encode(vec))
    for name in mv.counters:
        mv.counters[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = matvec_bsgs_ckks(mv, ct, mat)
    torch.cuda.synchronize()
    t_mv = time.perf_counter() - t0
    err = float(np.max(np.abs(np.real(mv.decode(mv.decrypt(y))) - mat @ vec)))
    check(err < 1e-2, f"matvec_bsgs_ckks: largest error {err}")
    baby = int(size ** 0.5)
    giant = -(-size // baby)
    c = dict(mv.counters)
    # one hoisted decomposition serves all baby steps; each giant step but
    # the first rotates its own partial sum
    check((c["decomp"], c["decomp_hit"], c["galois"])
          == (1 + giant - 1, 0, baby - 1 + giant - 1),
          f"matvec_bsgs_ckks: counters {c}")
    print(f"  matvec_bsgs_ckks n={CKKS_MATVEC_N} ({size} x {size}, scale "
          f"2^29): largest error {err:.2e} against numpy; counters {c} "
          f"({baby} baby steps on one decomposition, {giant} giant steps); "
          f"{t_mv:.1f} s on the host clock", flush=True)
    launches = dict(nk.launches)
    check(all(v > 0 for v in launches.values()),
          f"the CKKS path launched a kernel no time: {launches}")
    return stats, launches


BENCH_BATCH = 8


def phase_bench(dev, gold):
    """The batch contract on the card, then the measurement entry point in
    process. Returns (NTT kernel launches, ablation kernel launches) of the
    bench run alone."""
    import contextlib
    import io

    from abc_tpu_torch import bench
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import ntt_ablation as na
    from abc_tpu_torch.ops import ntt_kernels as nk

    # --- B ciphertexts through one call against B calls; row 0 holds the
    # golden operands
    g = gold["mult_relin_n8192_k1"]
    ctx = BfvContext(BfvParams.create(g["n"], seed=g["seed"]), dev)
    ctx.ensure_eval_ready()
    ctx.materialize_keys(["relin", f"galois_{pow(3, 3, 2 * g['n'])}"])
    rng = np.random.default_rng(g["seed"])
    extra = rng.integers(-99, 100, size=(2 * BENCH_BATCH - 2, 6)).tolist()
    cts = ctx.encrypt_many([ctx.encode(v) for v in [g["a"], g["b"]] + extra])
    xs = torch.stack([ct.data for ct in cts[0::2]])
    ys = torch.stack([ct.data for ct in cts[1::2]])
    ops = {"multiply": lambda x, y: ctx.multiply(BfvCiphertext(x),
                                                 BfvCiphertext(y)),
           "rotate_rows": lambda x, y: ctx.rotate_rows(BfvCiphertext(x), 3)}
    census = {"multiply": {"ntt_fwd": 5, "ntt_inv": 3},
              "rotate_rows": {"ntt_fwd": 1, "ntt_inv": 1}}
    for name, op in ops.items():
        before = dict(nk.launches)
        with ctx.fresh_caches():
            got = op(xs, ys).data
        made = {k: nk.launches[k] - before[k] for k in before}
        check(got.shape == xs.shape, f"batched {name}: shape {got.shape}")
        for i in range(BENCH_BATCH):
            with ctx.fresh_caches():
                want = op(xs[i], ys[i]).data
            check(torch.equal(got[i], want),
                  f"batched {name}: row {i} != a separate call")
        if name == "multiply":
            check(digest(got[0]) == g["result"],
                  "batched multiply: row 0 != golden digest (abc_tpu np64)")
        check(made == census[name], f"batched {name} launched {made}")
        print(f"  {name} on [{BENCH_BATCH}, 2, {ctx.params.L}, {g['n']}]: "
              f"every row equal to a separate call"
              + (", row 0 equal to the golden digest"
                 if name == "multiply" else "")
              + f"; launches of the batched call {made}", flush=True)
    del ctx, cts, xs, ys

    # --- python -m abc_tpu_torch.bench --quick, in process
    for counts in (nk.launches, na.launches):
        for name in counts:
            counts[name] = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--quick"])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(nk.launches), dict(na.launches)
    lines = out.getvalue().strip().splitlines()
    check(len(lines) >= 2, f"bench printed {len(lines)} lines")
    full, line = json.loads(lines[-2]), json.loads(lines[-1])
    suite = full["suite"]
    check(rc == 0 and not full["problems"],
          f"bench exit {rc}: {full['problems']}")
    check(sorted(suite) == [f"config{i}" for i in range(1, 7)]
          and not any("error" in rec for rec in suite.values()),
          f"bench suite: { {k: v.get('error') for k, v in suite.items()} }")
    check(suite["config3"]["correct"] is True, "config 3: slot 0 != 2")
    check(suite["config4"]["measured"]["decrypt_equal"] is True,
          "config 4: the rewritten circuit decrypts differently")
    check(suite["config6"]["correct"] is True, "config 6: oracle")
    check(all(suite[f"config{i}"]["correct"] is True for i in (1, 2, 5)),
          "config 1, 2 or 5 incorrect")
    check(not full["nan_headlines"],
          f"bench headline values that are nan: {full['nan_headlines']}")
    check(len(lines[-1]) < 1500 and line["ok"] is True,
          f"bench compact line: {len(lines[-1])} characters")
    check(full["device"]["kind"] == torch.cuda.get_device_name(0)
          and full["timer"] == "cuda_graph", f"bench ran on {full['device']}")
    check(sorted(full["mult_relin"]["batch_curve"]) == ["1", "16", "64", "8"]
          and all(row["ntt_launches_per_step"] == [5, 3]
                  for row in full["mult_relin"]["batch_curve"].values()),
          "mult+relin curve: batches or the per-step census")
    check(all(v > 0 for v in launches[0].values()),
          f"the bench launched a kernel no time: {launches[0]}")
    sol = full["mult_relin"]["speed_of_light"]
    print(f"  bench --quick: {seconds:.1f} s, exit 0, six configs without "
          f"error, config 3 correct, config 4 decrypt_equal, config 6 equal "
          f"to the oracle, no nan; NTT launches {launches[0]}; mult+relin "
          f"floor {sol['floor_us']:.3f} us by {sol['bound_by']} "
          f"({sol['ntt_rows']} NTT rows), op at "
          f"{sol['pct_of_floor']:.3f}% of it at B=1", flush=True)
    print(lines[-2], flush=True)
    print(lines[-1], flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from abc_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"card: {smi[0]}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    _build.build()
    print(f"kernel build: {_build.build_seconds:.1f} s (nvcc, sm_90a)",
          flush=True)
    print("\n".join("  " + ln for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    _build.load()
    gold = golden()

    clock = [time.perf_counter()]

    def announce(title):
        """Print a phase's title after the seconds the one before it took."""
        now = time.perf_counter()
        print(f"  ({now - clock[0]:.1f} s on the host clock)\n{title}",
              flush=True)
        clock[0] = now

    announce("phase 2: kernels vs plain")
    stats = phase_kernels(dev)
    announce("phase 3: mult+relin n=8192")
    mult_eager = {k: phase_mult_relin(dev, k, gold[f"mult_relin_n8192_k{k}"])
                  for k in (1, 2)}
    announce("phase 4: main path (README hamming, n=8192)")
    launches, hamming_words = phase_hamming(dev, gold["hamming_n8192"])
    announce("phase 5: LaplaceSharpening n=16384")
    laplace_ctx, laplace_words, laplace_eager_ms = phase_laplace(dev)
    announce("phase 6: keygen and switching keys on the card")
    phase_keys(dev, laplace_ctx)
    del laplace_ctx
    announce("phase 7: NTT ablation and ALU calibration")
    abl_stats, abl_launches = phase_ablation(dev)
    stats.update(abl_stats)
    launches.update(abl_launches)
    announce("phase 8: whole-program execution (one CUDA graph per program)")
    graph_launches = phase_whole_program(dev, gold, hamming_words,
                                         laplace_words, laplace_eager_ms,
                                         mult_eager[1])
    announce("phase 9: CKKS (n=32768, 8 + 2 primes; leveled views, the "
             "config-5 op, float programs as graphs, the packed matvec)")
    ckks_stats, ckks_launches = phase_ckks(dev, gold)
    announce("phase 10: the measurement entry point (batch contract, "
             "python -m abc_tpu_torch.bench --quick in process)")
    bench_launches, bench_abl_launches = phase_bench(dev, gold)
    bench_launches.update(bench_abl_launches)
    announce("phases done")
    loaded = sorted(m for m, v in sys.modules.items() if v is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "abc_tpu"))
    check(not loaded, f"the reference or JAX was imported: {loaded}")

    # no single PyTorch call computes a negacyclic NTT mod q or these ALU
    # chains, so no kernel has a library yardstick
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                # the whole-program path counts while it sets up, warms up
                # and captures, and never at a replay
                "launches_whole_program": graph_launches.get(name, 0),
                # the CKKS path (phase 9), counted alone, and the kernel at
                # the largest launch shape of the CKKS op
                "launches_ckks": ckks_launches.get(name, 0),
                # the measurement entry point (phase 10), counted alone: it
                # times ntt_fwd / ntt_inv and never the ablation's kernels
                "launches_bench": bench_launches.get(name, 0),
                "ckks": ckks_stats.get(name),
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
                "bound_ms": stats[name]["bound_ms"],
                "bound_by": stats[name]["bound_by"], "library_ms": None,
                "device_ms": stats[name]["device_ms"],
                "plain_device_ms": stats[name]["plain_device_ms"],
                "at": stats[name].get("at", list(JSON_SHAPE.get(name, ())))}
               for name in ("ntt_fwd", "ntt_inv", "ablate_ntt", "alu_chain")]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
