#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (abc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

1. Build the NTT kernels from abc_tpu_torch/csrc with nvcc (sm_90a).
2. Kernel vs plain: ntt_fwd / ntt_inv against their plain torch versions on
   the card (torch.equal) at the slice's shapes, one shape against the np64
   host oracle, inv(fwd(x)) == x; kernel and plain times in CUDA events,
   median of 10 calls (warm L2).
3. BFV mult+relin at n=8192 (6 data primes, k=1 and k=2): the port on the
   card against an abc_tpu np64 context of the same seed, word for word; one
   multiply of fresh operands launches exactly 5 forward and 3 inverse
   transforms (154 limb rows at k=1); ms per op.
4. The main path: the README hamming program, compiled by abc_tpu's passes
   and run encrypted through run_compiled with the port's factory at
   n=8192. Kernel launch counts are taken over this run alone. Its output
   words equal abc_tpu's np64 factory of the same seed and decrypt to 2.
5. LaplaceSharpening at the reference's parameters (n=16384, 13 data
   primes): decrypts equal to the plain oracle, rotations share one hoisted
   decomposition, both kernels launched; phase times.

Needs one CUDA device; exits nonzero at once without one. Imports nothing of
JAX. Prints the card's name and power limit, a {"kernels": [...]} JSON line,
and last {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HAMMING_INPUTS = "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};"
HAMMING = """
  int sum = 0;
  for (int i = 0; i < 4; i = i + 1) {
    sum = sum + (x[i]-y[i])*(x[i]-y[i]);
  }
  return sum;
"""
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
NTT_SHAPES = [(8192, 6, 1), (8192, 6, 3), (8192, 7, 6), (8192, 8, 2),
              (8192, 8, 3), (16384, 14, 1), (16384, 14, 8)]
# the largest forward (key-switch decomposition, 42 rows) and inverse (Bsk
# tensor product, 24 rows) transform of one n=8192 mult+relin
JSON_SHAPE = {"ntt_fwd": (8192, 7, 6), "ntt_inv": (8192, 8, 3)}
ORACLE_SHAPE = (8192, 6, 3)      # also held against the np64 host oracle
REPLACES = {
    "ntt_fwd": "abc_tpu/ops/pallas_ntt.py:265 (_fwd_kernel via "
               "pallas_fwd_ntt :416, pallas_fwd_ntt_fp :439)",
    "ntt_inv": "abc_tpu/ops/pallas_ntt.py:309 (_inv_kernel via "
               "pallas_inv_ntt :468, pallas_inv_ntt_fp :495)",
}


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
    ms, kernel launches, {kernel name: ms}); None where the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in ev.name.lower() or "memset" in ev.name.lower():
            continue
        launches += 1
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.device_time_total / 1e3 / reps
    if not launches:
        return None
    return sum(by_name.values()), launches / reps, by_name


def fmt(prof):
    if prof is None:
        return "not measured"
    return f"{prof[0]:.4f} ms in {prof[1]:.0f} kernels"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rand_residues(moduli, shape, seed, device):
    from abc_tpu_torch.ops.modarith import as_residues
    q = np.asarray(moduli, dtype=np.uint64).reshape(len(moduli), 1)
    rng = np.random.default_rng(seed)
    return as_residues(rng.integers(0, q, size=shape, dtype=np.uint64),
                       device)


def phase_kernels(dev):
    from abc_tpu.crypto.ntt import NttContext as RefNttContext
    from abc_tpu.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import to_host

    stats = {k: {"max_abs_err": 0} for k in nk.launches}
    for n, L, batch in NTT_SHAPES:
        moduli = gen_ntt_primes(30, L, n)
        ctx = NttContext(n, moduli, dev)
        x = rand_residues(moduli, (batch, L, n), seed=n + L + batch,
                          device=dev)
        runs = {
            "ntt_fwd": (lambda: nk.ntt_fwd(x, ctx.q, ctx.fwd_tw,
                                           ctx.fwd_tw_sh),
                        lambda: nk.fwd_ntt_plain(x, ctx.q, ctx.fwd_tw)),
            "ntt_inv": (lambda: nk.ntt_inv(x, ctx.q, ctx.inv_tw,
                                           ctx.inv_tw_sh, ctx.n_inv,
                                           ctx.n_inv_sh),
                        lambda: nk.inv_ntt_plain(x, ctx.q, ctx.inv_tw,
                                                 ctx.n_inv)),
        }
        line = [f"n={n} L={L} batch={batch}:"]
        for name, (kern, plain) in runs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            check(torch.equal(got, want), f"{name} != plain at {n, L, batch}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            line.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f} ms)")
            if JSON_SHAPE[name] == (n, L, batch):
                stats[name]["ms"], stats[name]["plain_ms"] = ms, plain_ms
                prof, plain_prof = kernel_profile(kern), kernel_profile(plain)
                stats[name]["device_ms"] = prof and prof[0]
                stats[name]["plain_device_ms"] = plain_prof and plain_prof[0]
                line.append(f"[device: {fmt(prof)}; plain {fmt(plain_prof)}]")
        back = nk.ntt_inv(nk.ntt_fwd(x, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh),
                          ctx.q, ctx.inv_tw, ctx.inv_tw_sh, ctx.n_inv,
                          ctx.n_inv_sh)
        check(torch.equal(back, x), f"inv(fwd(x)) != x at {n, L, batch}")
        if (n, L, batch) == ORACLE_SHAPE:
            ref = RefNttContext(n, moduli, engine="np64")
            xh = to_host(x)
            check(np.array_equal(to_host(ctx.fwd(x)), ref.fwd(xh)),
                  "ntt_fwd != np64 oracle")
            check(np.array_equal(to_host(ctx.inv(x)), ref.inv(xh)),
                  "ntt_inv != np64 oracle")
            line.append("(= np64 oracle)")
        print("  " + "  ".join(line), flush=True)
    return stats


def phase_mult_relin(dev, k):
    from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext as RefBfvContext
    from abc_tpu.crypto.params import BfvParams
    from abc_tpu_torch.convert import context_from_reference
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import to_host

    ref = RefBfvContext(BfvParams.create(MAIN_N, seed=11, engine="np64",
                                         ks_digits=k))
    ctx = context_from_reference(ref, dev)
    a, b = ctx.encrypt_many([ctx.encode([3, 4, 5]), ctx.encode([7, -2, 9])])
    got = ctx.multiply(a, b)
    want = ref.multiply(ctx.to_reference(a), ctx.to_reference(b))
    check(np.array_equal(to_host(got.data), want.data),
          f"mult+relin k={k} != np64")
    check(ctx.decode(ctx.decrypt(got))[:3] == [21, -8, 45],
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
    print(f"  k={k}: word-identical to np64, decrypts [21, -8, 45]; "
          f"{d_fwd} fwd + {d_inv} inv launches per op; "
          f"{ms:.3f} ms/op (median of 20, fresh operands)", flush=True)
    prof = kernel_profile(lambda: ctx.multiply(BfvCiphertext(a.data.clone()),
                                               BfvCiphertext(b.data.clone())))
    print(f"  k={k} device kernels per op: {fmt(prof)}", flush=True)
    if prof is not None:
        ntt = sum(v for name, v in prof[2].items() if "ntt_" in name)
        top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
        print(f"    NTT kernels {ntt:.4f} ms; busy share of the op "
              f"{prof[0] / ms:.3f}; top: " + "; ".join(
                  f"{name[:60]} {v:.4f} ms" for name, v in top), flush=True)


def run_dsl(factory, inputs_src, program_src, output_src):
    """Parse, compile (abc_tpu passes) and execute under RuntimeVisitor, as
    run_compiled does; returns the output ciphertext and the host-clock
    times (ms) of input encryption and computation."""
    from abc_tpu.parser import Parser
    from abc_tpu.passes.pipeline import (CompileOptions, compile_program,
                                         input_types_from_ast)
    from abc_tpu.runtime.executor import RuntimeVisitor

    inputs = Parser.parse(inputs_src)
    compiled = compile_program(program_src, input_types_from_ast(inputs),
                               CompileOptions())
    t0 = time.perf_counter()
    rv = RuntimeVisitor(factory, inputs, compiled.secret_tainted)
    t1 = time.perf_counter()
    rv.execute_ast(compiled.ast)
    ct = rv.get_output(Parser.parse(output_src))[0][1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ct, {"input_encryption": (t1 - t0) * 1e3,
                "computation": (t2 - t1) * 1e3}


def readme_hamming(factory):
    """The README quick start: compile_program (vectorized) → run_compiled
    with `factory`; returns the output ciphertext."""
    from abc_tpu.parser import Parser
    from abc_tpu.passes.pipeline import (CompileOptions, compile_program,
                                         input_types_from_ast, run_compiled)

    inputs = Parser.parse(HAMMING_INPUTS)
    compiled = compile_program(HAMMING, input_types_from_ast(inputs),
                               CompileOptions(vectorize=True))
    _, outputs = run_compiled(compiled, inputs, Parser.parse("hd = sum;"),
                              factory)
    return outputs[0][1]


def phase_hamming(dev):
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory as RefFactory
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import to_host
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    factory = BfvCiphertextFactory(slots=MAIN_N, seed=5, device=dev)
    for name in nk.launches:
        nk.launches[name] = 0
    t0 = time.perf_counter()
    ct = readme_hamming(factory)
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) * 1e3
    launches = dict(nk.launches)
    hd = factory.decrypt(ct)[0]
    ref_ct = readme_hamming(RefFactory(slots=MAIN_N, seed=5, engine="np64"))
    check(all(v > 0 for v in launches.values()),
          f"main path launched a kernel no time: {launches}")
    check(np.array_equal(to_host(ct.ct.data), ref_ct.ct.data),
          "hamming output != abc_tpu np64 factory")
    check(hd == 2, f"hamming decrypts to {hd}")
    print(f"  hamming n={MAIN_N}: decrypts to {hd}, word-identical to abc_tpu "
          f"np64; launches {launches}; counters {factory.context.counters}; "
          f"run_compiled {t_run:.1f} ms (host clock: encryption, switching-"
          f"key builds and evaluation)", flush=True)
    return launches


def phase_laplace(dev):
    import random

    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    size = 4
    rng = random.Random(7)
    img = [rng.randrange(0, 256) for _ in range(size * size)]
    inputs_src = ("secret int img = {" + ",".join(map(str, img)) + "};"
                  f" int imgSize = {size};")
    weights = [1, 1, 1, 1, -8, 1, 1, 1, 1]
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            conv = sum(weights[(i + 1) * 3 + j + 1] *
                       img[(x + i) * size + (y + j)]
                       for j in range(-1, 2) for i in range(-1, 2))
            want[x * size + y] = 2 * img[x * size + y] - conv

    before = dict(nk.launches)
    t0 = time.perf_counter()
    factory = BfvCiphertextFactory(slots=LAPLACE_N, seed=23, device=dev)
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
          f"{first['computation']:.1f} (includes host switching-key builds), "
          f"computation again with keys built {steady['computation']:.1f}, "
          f"decryption {t_dec:.1f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    # The np64 oracle (abc_tpu) probes JAX's trace state on each of its
    # cache lookups. With the import blocked it takes its no-JAX branch:
    # the same words, without its caches. Nothing of JAX is loaded.
    sys.modules["jax"] = None
    from abc_tpu.ops import native
    from abc_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"card: {smi[0]}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; reference host engine: "
          f"{'native C++' if native.available() else 'NumPy'}", flush=True)
    _build.build()
    print(f"kernel build: {_build.build_seconds:.1f} s (nvcc, sm_90a)",
          flush=True)
    print("\n".join("  " + ln for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    _build.load()

    print("phase 2: kernels vs plain", flush=True)
    stats = phase_kernels(dev)
    print("phase 3: mult+relin n=8192", flush=True)
    for k in (1, 2):
        phase_mult_relin(dev, k)
    print("phase 4: main path (README hamming, n=8192)", flush=True)
    launches = phase_hamming(dev)
    print("phase 5: LaplaceSharpening n=16384", flush=True)
    phase_laplace(dev)
    check(not any(v is not None and (m == "jax" or m.startswith("jax."))
                  for m, v in sys.modules.items()), "jax was imported")

    kernels = [{"name": name, "route": "cuda",
                "source": "abc_tpu_torch/csrc/ntt.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
                "device_ms": stats[name]["device_ms"],
                "plain_device_ms": stats[name]["plain_device_ms"],
                "at": list(JSON_SHAPE[name])}
               for name in ("ntt_fwd", "ntt_inv")]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
