"""Where the time of key generation, encryption and decryption goes.

    python -m abc_tpu_torch.scripts.key_profile [--device cuda] [--n 16384]
        [--reps 3] [--out PATH]

LaplaceSharpening at the reference's parameters (benchsuite config 6: n =
16384, 13 + 1 primes, seed 23) needs 19 switching keys. This script builds
its program once to learn them and to warm every kernel up, then times
four set-up steps of a fresh factory on the host clock, the device drained
around each:

* `keygen`: BfvCiphertextFactory(...) (secret, public key);
* `key_build`: context.materialize_keys(the program's 19 key ids);
* `encrypt`: JittedProgram.encrypt_inputs of a fresh image;
* `decrypt`: JittedProgram.decrypt_outputs of one replay's output.

Each step runs `reps` times unprofiled (host clock, and the host time spent
in the named host functions: the numpy error and secret draws, the SHA-256
stream keys) and once under torch.profiler (device time of the kernels,
their count, and of the copies). What the host clock holds beyond those
is host issue and waits. Then config 6's CSV (benchsuite, the second of two
passes). One JSON object per step and one for the CSV, each on a line.

Every number comes from the card; a CPU run (`--device cpu`, a smaller
`--n`) only checks that the script runs, and its records say "cpu".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from contextlib import contextmanager

import torch

from abc_tpu_torch.benchsuite import (LAPLACE_PROGRAM, LAPLACE_SIZE,
                                      config6_laplace_n16384_e2e,
                                      device_label, require_device)
from abc_tpu_torch.crypto import rlwe
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.jit_executor import jit_compile_program

SEED = 23
# the host functions whose time is summed: (owner, attribute, label); the
# stream keys are derive_key one at a time in an older tree, derive_keys
# in batches here (whichever the module has is timed)
HOST_PARTS = ((rlwe.RlweKeys, "_ksk_errors", "key_errors_numpy"),
              (rlwe.RlweKeys, "_sample_ternary", "ternary_numpy"),
              (rlwe.RlweKeys, "_sample_error", "error_numpy"),
              (rlwe, "derive_key", "derive_key_sha256"),
              (rlwe, "derive_keys", "derive_key_sha256"))


@contextmanager
def host_timers(totals):
    """Wrap each HOST_PARTS function so that its host time adds to
    totals[label] while the block runs (summed over threads: the key errors
    may be drawn on several at once, so their sum can exceed the wall
    time)."""
    saved = []
    for owner, attr, label in HOST_PARTS:
        fn = getattr(owner, attr, None)
        if fn is None:
            continue
        saved.append((owner, attr, fn))

        def timed(*a, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                totals[_label] = totals.get(_label, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        setattr(owner, attr, timed)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def device_profile(run, dev):
    """(kernel ms, kernels, copy ms, copies) of one run() on the card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    kern = copy = 0.0
    n_kern = n_copy = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name.lower()
        if "memcpy" in name or "memset" in name:
            copy += ev.device_time_total / 1e3
            n_copy += 1
        else:
            kern += ev.device_time_total / 1e3
            n_kern += 1
    return kern, n_kern, copy, n_copy


def attribute(step, prepare, run, dev, reps):
    """Host-clock ms of run(prepare()) (median of reps, each on a fresh
    prepare()), the host parts' ms in the median run, and on the card the
    device split of one more run."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    runs = []
    for _ in range(reps):
        arg = prepare()
        totals = {}
        sync()
        with host_timers(totals):
            t0 = time.perf_counter()
            run(arg)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        runs.append((ms, totals))
    ms, totals = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    rec = {"step": step, "device": device_label(dev), "host_ms": ms,
           "host_ms_all": [r[0] for r in runs],
           "host_parts_ms": totals}
    if dev.type == "cuda":
        arg = prepare()
        kern, n_kern, copy, n_copy = device_profile(lambda: run(arg), dev)
        rec.update(kernel_ms=kern, kernels=n_kern, copy_ms=copy,
                   copies=n_copy, device_share=(kern + copy) / ms,
                   rest_ms=ms - kern - copy - sum(totals.values()))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if dev.type == "cuda":
        from abc_tpu_torch.ops import _build
        _build.load()
        print(json.dumps({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()}), flush=True)
    img = list(range(LAPLACE_SIZE * LAPLACE_SIZE))
    inputs_src = ("secret int img = {" + ",".join(map(str, img)) + "};"
                  f" int imgSize = {LAPLACE_SIZE};")

    def factory():
        return BfvCiphertextFactory(slots=args.n, seed=SEED, device=dev)

    # the program once: its key ids, and every kernel and table warmed up
    jp = jit_compile_program(LAPLACE_PROGRAM, inputs_src, "out = img2;",
                             factory=factory())
    ids = sorted(jp.factory.context._keys)
    raw = jp.run_raw(jp.secret_inputs)
    fresh = {"img": [(3 * v + 1) % 256 for v in img]}

    records = [
        attribute("keygen", lambda: None, lambda _: factory(), dev,
                  args.reps),
        attribute("key_build", lambda: factory().context,
                  lambda ctx: ctx.materialize_keys(ids), dev, args.reps),
        attribute("encrypt", lambda: None,
                  lambda _: jp.encrypt_inputs(fresh), dev, args.reps),
        attribute("decrypt", lambda: None,
                  lambda _: jp.decrypt_outputs(raw), dev, args.reps)]
    records[1]["keys"] = len(ids)
    for rec in records:
        print(json.dumps(rec), flush=True)
    if dev.type == "cuda":
        csv = config6_laplace_n16384_e2e(dev, slots=args.n)
        records.append({"step": "config6_csv", "device": device_label(dev),
                        **csv["csv_schema"],
                        "setup_phase_ms": csv["setup_phase_ms"]})
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"summary_host_ms": {
        r["step"]: r["host_ms"] for r in records if "host_ms" in r}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
