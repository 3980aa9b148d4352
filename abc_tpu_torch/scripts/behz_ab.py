"""The BEHZ kernels of csrc/behz.cu on the card: what the compiler made of
each kernel, and device time beside another build of the same file.

    python -m abc_tpu_torch.scripts.behz_ab [--baseline DIR] [--rounds R]
                                            [--out PATH]

For every BEHZ kernel instantiation of the library: registers, shared
memory and spills (`ptxas -v`) and a SASS census (instructions in the code,
not executed: IMAD of every kind but IMAD.MOV, IMAD.WIDE, LDG, STG, LDS,
STS, BAR; ops/kernel_census.py). At each of SHAPES, every kernel's launch
(abc_behz_launch_info: template arguments, threads a block, blocks,
theoretical occupancy).

With --baseline, DIR holds another version of csrc/behz.cu (and the
headers it includes) with the same C entry points, such as an earlier
commit's, and, where its kernels read tables of another layout, the
ops/behz_kernels.py of the same commit, which then packs the baseline's
tables (BehzContext.kernel_words). It is built the same way and its
kernels are listed the same way, and at SHAPES both builds run every
kernel on the same inputs: the words must be equal, and the profiler's
device time of each is read in turns (baseline, this tree, this tree,
baseline), --rounds times (0: the words only). A shape the baseline
refuses (its return code) is run for this tree alone. behz_tensor runs
over both bases of a multiply (q and Bsk): one launch of
abc_behz_tensor_bases, or, in a baseline built before that entry point
(its abc_behz_tensor took one base a launch), two launches whose device
times add up. One JSON object per line; the last holds the medians.

Needs a CUDA device and raises without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from abc_tpu_torch.ops import _build
from abc_tpu_torch.ops import behz_kernels as bk
from abc_tpu_torch.ops import kernel_census as kc
from abc_tpu_torch.ops.modarith import as_residues

# (n, L, ciphertexts, t bits): t None takes BfvParams.create(n)'s chain,
# else L data primes of 30 bits and t of that many bits. B = 11 and 12 lie
# between the batches at which fast_floor and from_bsk (3 rows a
# ciphertext) and to_bsk (2) take the warp path (csrc/behz.cu: tile_shape)
SHAPES = [(8192, 6, 1, None), (8192, 6, 8, None), (8192, 6, 11, None),
          (8192, 6, 12, None), (8192, 6, 16, None), (8192, 6, 64, None),
          (32768, 27, 1, None), (4096, 65, 1, 20)]
KERNELS = ("behz_to_bsk", "behz_from_bsk", "behz_fast_floor", "behz_tensor")
REPS = 20           # launches under one profile


def operands(bz, batch, dev):
    """The BEHZ kernels' operands of one mult+relin of `batch` ciphertexts:
    random residues with 0 and q-1 among them."""
    n, qs, bsk = bz.params.n, bz.params.data_primes, bz.bsk
    lead = () if batch == 1 else (batch,)
    rng = np.random.default_rng(n + len(qs) + batch)

    def rand(moduli, comps):
        q = np.asarray(moduli, dtype=np.uint64).reshape(-1, 1)
        h = rng.integers(0, q, size=lead + (comps, len(moduli), n),
                         dtype=np.uint64)
        h[..., 0] = 0
        h[..., 1::257] = q - 1
        return torch.from_numpy(h.astype(np.uint32).view(np.int32)).to(dev)

    return {"x": rand(qs, 2), "e_q": rand(qs, 3), "e_b": rand(bsk, 3),
            "f1q": rand(qs, 2), "f2q": rand(qs, 2), "f1": rand(bsk, 2),
            "f2": rand(bsk, 2)}


# the one-base tensor entry point of builds before abc_behz_tensor_bases:
# f1, f2, out, q, ratio, rows1, rows2, D, logn, stream
_ONE_BASE = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]


def tensor_call(lib, bases, logn, stream):
    """launch() -> return code of the tensor product over `bases`, (f1, f2,
    out, q, ratio, rows, D) each: one launch, or one a base where the
    library predates abc_behz_tensor_bases."""
    ptrs = [[t.data_ptr() for t in b[:5]] + [b[5], b[5], b[6]]
            for b in bases]
    if hasattr(lib, "abc_behz_tensor_bases"):
        return lambda: lib.abc_behz_tensor_bases(*ptrs[0], *ptrs[1], logn,
                                                 stream)
    lib.abc_behz_tensor.argtypes, lib.abc_behz_tensor.restype = \
        _ONE_BASE, ctypes.c_int
    return lambda: max(lib.abc_behz_tensor(*p, logn, stream) for p in ptrs)


def calls(lib, bz, T, ops, stream):
    """{kernel: (launch() -> return code, output)} of one library, which
    reads the packed tables T."""
    L, n, K = bz.params.L, bz.params.n, len(bz.bsk)
    logn = n.bit_length() - 1
    x, e_q, e_b, f1, f2 = (ops[k] for k in ("x", "e_q", "e_b", "f1", "f2"))
    lead = tuple(x.shape[:-3])
    # rows of x ([..., 2, L, n]) and of e_q; the tensor product counts
    # pairs of rows
    rows2, rows3 = x.numel() // (L * n), e_q.numel() // (L * n)
    outs = {"behz_to_bsk": torch.empty(lead + (2, K, n), dtype=torch.int32,
                                       device=x.device),
            "behz_from_bsk": torch.empty(lead + (3, L, n), dtype=torch.int32,
                                         device=x.device),
            "behz_fast_floor": torch.empty_like(e_b)}
    p = {k: v.data_ptr() for k, v in outs.items()}
    t_q, t_b = (torch.empty(lead + (3, D, n), dtype=torch.int32,
                            device=x.device) for D in (L, K))
    outs["behz_tensor"] = (t_q, t_b)
    tensor = tensor_call(lib, [
        (ops["f1q"], ops["f2q"], t_q, bz.ntt_q.q_col, bz.ntt_q.ratio,
         rows2 // 2, L),
        (f1, f2, t_b, bz.ntt_bsk.q_col, bz.ntt_bsk.ratio, rows2 // 2, K)],
        logn, stream)
    return {
        "behz_to_bsk": (lambda: lib.abc_behz_to_bsk(
            x.data_ptr(), p["behz_to_bsk"], T["to_bsk"].data_ptr(), rows2, L,
            K, logn, stream), outs["behz_to_bsk"]),
        "behz_from_bsk": (lambda: lib.abc_behz_from_bsk(
            e_b.data_ptr(), p["behz_from_bsk"], T["from_bsk"].data_ptr(),
            rows3, K - 1, L, logn, stream), outs["behz_from_bsk"]),
        "behz_fast_floor": (lambda: lib.abc_behz_fast_floor(
            e_q.data_ptr(), e_b.data_ptr(), p["behz_fast_floor"],
            T["fast_floor"].data_ptr(), rows3, L, K, logn, stream),
            outs["behz_fast_floor"]),
        "behz_tensor": (tensor, outs["behz_tensor"]),
    }


def device_us(launch, reps=REPS):
    """(device µs of one launch() call, all its kernels, and the first
    kernel's name) over `reps` calls under torch.profiler: the mean kernel
    times the kernels a call launches, so that a dropped record (PERF.md)
    does not count as a faster call."""
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and "behz_" in ev.name]
    if not evs:
        return None, None
    per_call = max(1, round(len(evs) / reps))
    return (sum(ev.device_time_total for ev in evs) / len(evs) * per_call,
            kc.kernel_key(evs[0].name))


def baseline_packer(directory: str):
    """DIR/behz_kernels.py loaded as a module of its own, or None."""
    path = os.path.join(directory, "behz_kernels.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("behz_kernels_baseline",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_baseline(directory: str) -> tuple:
    """DIR/behz.cu built as this package builds csrc/ (nvcc, sm_90a, ptxas
    -v): (library, ptxas output, SASS)."""
    out_dir = os.path.join(_build.BUILD_DIR, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libbehz_baseline.so")
    nvcc = _build._nvcc()
    run = subprocess.run([nvcc] + _build.NVCC_FLAGS + [
        "-shared", f"-I{directory}", "-o", so,
        os.path.join(directory, "behz.cu")], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"baseline build failed:\n{run.stdout}"
                           f"{run.stderr}")
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    lib = ctypes.CDLL(so)
    _build.bind_behz(lib)
    return lib, run.stdout + run.stderr, sass


def words(out):
    """A kernel's outputs as a tuple."""
    return out if isinstance(out, tuple) else (out,)


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        out.write(line + "\n")


def run(args) -> int:
    from abc_tpu_torch.crypto.behz import BehzContext
    from abc_tpu_torch.crypto.ntt import NttContext
    if not torch.cuda.is_available():
        raise RuntimeError("behz_ab needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = open(args.out, "w") if args.out else None
    emit({"card": smi}, out)
    _build.build()
    lib = _build.load()
    builds = {"this": (lib, kc.kernel_table(_build.build_log,
                                            _build.sass()))}
    packers = {"this": bk}
    if args.baseline:
        base, log, sass = build_baseline(args.baseline)
        builds["baseline"] = (base, kc.kernel_table(log, sass))
        packers["baseline"] = baseline_packer(args.baseline) or bk
    for which, (_, table) in builds.items():
        for key, row in table.items():
            emit({"build": which, "kernel": key, **row}, out)
            print(f"  {which} {key}: {kc.fmt_kernel(row)}", flush=True)

    summary, stream = [], torch.cuda.current_stream(dev).cuda_stream
    for n, L, batch, t_bits in SHAPES:
        params = kc.shape_params(n, L, t_bits)
        bz = BehzContext(params, NttContext(n, params.data_primes, dev))
        ops = operands(bz, batch, dev)
        per = {which: calls(b[0], bz, {
            k: as_residues(v, dev) for k, v in bz.kernel_words(
                packers[which]).items()}, ops, stream)
               for which, b in builds.items()}
        for name in KERNELS:
            info = bk.launch_info(name, *kc.launch_of(name, L, len(bz.bsk),
                                                      batch), n)
            ok = {which: c[name][0]() == 0 for which, c in per.items()}
            torch.cuda.synchronize()
            if not ok["this"]:
                raise RuntimeError(f"{name} at {n, L, batch} failed to "
                                   "launch")
            if ok.get("baseline") and not all(
                    torch.equal(a, b) for a, b in zip(
                        words(per["baseline"][name][1]),
                        words(per["this"][name][1]))):
                raise AssertionError(f"{name} at {n, L, batch}: the two "
                                     "builds' words differ")
            times, names = {w: [] for w in per if ok[w]}, {}
            order = [w for w in ("baseline", "this", "this", "baseline")
                     if w in times]
            for _ in range(args.rounds):
                for which in order:
                    us, kname = device_us(per[which][name][0])
                    times[which].append(us)
                    names[which] = kname
            med = {w: statistics.median(t) for w, t in times.items()
                   if t and None not in t}
            rec = {"shape": [n, L, batch], "kernel": name, "launch": info,
                   "this_kernel": names.get("this"),
                   "this_compiled": builds["this"][1].get(
                       kc.launch_key(name, info), {}),
                   "device_us": times, "median_us": med}
            if "baseline" in times:
                rec["baseline_kernel"] = names.get("baseline")
                rec["baseline_compiled"] = builds["baseline"][1].get(
                    names.get("baseline"), {})
            emit(rec, out)
            summary.append({"shape": [n, L, batch], "kernel": name,
                            **{f"{w}_us": v for w, v in med.items()}})
            print(f"  n={n} L={L} B={batch} {name}: " + ", ".join(
                f"{w} {v:.2f} us" for w, v in med.items())
                + f"; launch {info}", flush=True)
        del bz, ops, per
        torch.cuda.empty_cache()
    emit({"card": smi, "medians": summary}, out)
    if out:
        out.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m abc_tpu_torch.scripts."
                                      "behz_ab", description=__doc__.split(
                                          "\n")[0])
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a directory holding another behz.cu (and the "
                         "headers it includes)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every JSON line there")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
