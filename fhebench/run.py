"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 -m fhebench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (setup_s, from the process's start to the first request of the
window): load the kernel library (built at the first run in a checkout),
the factory and its keys from the seed, the cell's DSL program compiled
and captured as one CUDA graph (jit_compile_program: warm-up walk and
capture), a pool of distinct requests drawn from the seed and encrypted by
the program (the clients' half), one warm pass over the pool. Window: the
closed loop of harness/serve.py for --seconds. After it: the kept answers
decrypted by the program and compared with the plain reference
(harness/check.py). With --trace 1 a slice of the window is profiled and
the cell's per-layer metrics are printed in place of its end-to-end ones.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits); the numbers compared are also the last lines
of standard error. Without a CUDA device, or with fewer than the cell
asks for, the run prints no result and exits 3; a run that loaded JAX or
the JAX package exits 4.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "abc_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = process_age_s()


def loaded_forbidden(modules=None) -> List[str]:
    """Top-level names of loaded modules (sys.modules by default) that are
    JAX or the JAX package, compared whole: abc_tpu_torch is not
    abc_tpu."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_settings() -> Dict[str, str]:
    """nvidia-smi's name, power limit and SM clocks, beside every number."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    fields = [f.strip() for f in out.splitlines()[0].split(",")] \
        if out.strip() else []
    return dict(zip(("name", "power_limit", "sm_clock", "sm_clock_max"),
                    fields))


SCHEMES = ("bfv", "ckks")


def make_factory(config: Dict, seed: int, device):
    """The configuration's ciphertext factory, its keys from the seed."""
    if config["scheme"] == "ckks":
        from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
        from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
        params = CkksParams.create(
            config["n"], levels=config["data_primes"], seed=seed,
            scale_bits=config["scale_bits"],
            ks_digits=config["special_primes"])
        return CkksCiphertextFactory(context=CkksContext(params, device),
                                     device=device)
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    return BfvCiphertextFactory(
        slots=config["n"], seed=seed, ks_digits=config["special_primes"],
        device=device, plain_bits=config["plain_bits"])


def _check_params(params, config: Dict) -> None:
    """The program's parameter set is the configuration's."""
    have = {"n": params.n, "data_primes": params.L,
            "special_primes": params.ks_digits,
            "prime_bits": sorted({q.bit_length()
                                  for q in params.coeff_modulus})}
    want = {"n": config["n"], "data_primes": config["data_primes"],
            "special_primes": config["special_primes"],
            "prime_bits": [config["prime_bits"]]}
    if config["scheme"] == "ckks":
        have["scale_bits"] = math.log2(params.scale)
        want["scale_bits"] = config["scale_bits"]
    else:
        have["plain_bits"] = params.plain_modulus.bit_length()
        want["plain_bits"] = config["plain_bits"]
    if have != want:
        raise ValueError(f"the program's parameters {have} are not the "
                         f"configuration's {want}")


def _rows(decrypted: Dict[str, list], batched: bool) -> Dict[str, list]:
    """{output: [rows of slots]} of decrypt_outputs' result."""
    return {name: (v if batched else [v]) for name, v in decrypted.items()}


def _sample(seed: int, expect: int, keep: int) -> frozenset:
    """The requests whose answers are kept for the check: `keep` drawn from
    the seed among the first `expect` of the window."""
    rng = np.random.default_rng([seed, 1])
    expect = max(expect, keep)
    return frozenset(int(i) for i in rng.choice(expect, size=keep,
                                                replace=False))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t0: float = _T0, age0: float = _AGE0
             ) -> Tuple[Dict, Dict[str, Dict]]:
    """One run of `cell` on `device`: (the result object, the numbers
    compared). `control`: judge the reference's control (reference
    module's control()) in the program's place."""
    import torch
    from abc_tpu_torch.parallel.sharding import make_mesh
    from abc_tpu_torch.passes.pipeline import CompileOptions
    from abc_tpu_torch.runtime.jit_executor import jit_compile_program
    from fhebench.harness import check, census, graph, readers, serve, \
        spec, trace as tracing, traffic as gen

    config, mix = cell.config, cell.traffic
    if config.get("scheme") not in SCHEMES:
        raise spec.SpecError(f"{cell.name}: the harness drives {SCHEMES} "
                             f"configurations, not {config.get('scheme')!r}")
    ckks = config["scheme"] == "ckks"
    on_card = device.type == "cuda"
    clock = time.perf_counter

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    parts = {"start": age0 + (clock() - t0)}
    mark = [clock()]

    def part(name):
        sync()
        now = clock()
        parts[name] = now - mark[0]
        mark[0] = now

    if on_card:
        from abc_tpu_torch.ops import _build
        _build.load()
    part("library")
    t = clock()
    factory = make_factory(config, seed, device)
    sync()
    factory_ms = (clock() - t) * 1e3
    part("factory")
    _check_params(factory.params, config)
    batch, in_flight = int(mix["batch"]), int(mix["in_flight"])
    values = gen.draw_pool(config, mix, seed)
    drawn = gen.draw_plain(config, seed)
    mesh = make_mesh(**mix["mesh"], device=device) if "mesh" in mix \
        else None
    if batch > 1 and mesh is None:
        raise spec.SpecError("a batch of requests a replay runs on the "
                             "program's mesh path: give the traffic a mesh")
    if ckks and (batch > 1 or mesh is not None):
        raise spec.SpecError("a CKKS program is walked once a row: its "
                             "traffic sends one request a replay, no mesh")
    first = {name: rows[0] for name, rows in values[0].items()}
    jp = jit_compile_program(
        cell.program_source(), gen.inputs_source(config, first, drawn),
        gen.output_source(config), factory=factory,
        options=CompileOptions(**config.get("compile", {})), mesh=mesh,
        batch_values=values[0] if mesh is not None else None)
    part("program")
    pool = [jp.encrypt_inputs(v if mesh is not None else
                              {name: rows[0] for name, rows in v.items()})
            for v in values]
    part("pool")
    # the warm pass keeps as many answers as the window will, so that the
    # window's kept clones find their memory in the allocator's cache
    n_warm = max(len(pool), 2 * in_flight, int(mix["keep"]))
    warm = serve.serve(jp.run_raw, pool, 600.0, in_flight, device,
                       keep=frozenset(range(n_warm)), max_requests=n_warm)
    if warm.failed:
        raise RuntimeError(f"the warm-up pass failed: {warm.error}")
    per_request = (warm.done[-1] - warm.submitted[0]) / len(warm.done)
    del warm
    expect = int(0.9 * seconds / per_request)
    keep = _sample(seed, expect, int(mix["keep"]))
    probe = None
    if trace:
        tracing.warm_profiler(lambda: jp.run_raw(pool[0]))
        probe = tracing.Slice(max(len(pool), expect // 3),
                              int(mix["trace_requests"]),
                              spec.kernel_families(cell.layers))
    part("warm")
    gc.collect()
    gc.freeze()
    setup_s = age0 + (clock() - t0)

    w = serve.serve(jp.run_raw, pool, seconds, in_flight, device, keep,
                    on_request=probe)
    if probe is not None:
        probe.close()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    record = None
    if trace:
        record = readers.RunRecord(
            phase_ms=dict(jp.phase_ms), factory_ms=factory_ms,
            graph_kernels=graph.graph_nodes(jp._graph)[0] if on_card
            else {},
            trace=probe.result, census=census.op_census(jp, pool[0]),
            shape={"n": config["n"], "L": config["data_primes"],
                   "k": config["special_primes"], "B": batch},
            layers=cell.layers)

    # the check: the kept answers decrypted by the program, the program's
    # state freed, then the plain reference
    reference = cell.reference()
    # a query as the reference reads it: the request's rows and the model
    # drawn from the seed
    queries = {j: dict(values[w.pool_of[j]], **drawn) for j in keep
               if j < len(w.pool_of)}
    if control:
        answers = _control_answers(reference, queries, config)
    else:
        answers = {j: _rows(jp.decrypt_outputs(out), mesh is not None)
                   for j, out in w.kept.items()}
    t_mod = getattr(factory.params, "plain_modulus", None)
    phase_ms = dict(jp.phase_ms, factory=factory_ms)
    del jp, pool, factory, w.kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    lengths = {name: int(o["length"]) for name, o in config["outputs"].items()}
    tolerance = config.get("tolerance") if ckks else None
    readings = check.judge(answers, queries, reference.answers, lengths,
                           t_mod, tolerance)
    table, correct = check.verdict(readings)
    correct = correct and not w.failed

    done = w.completed_in_window()
    latencies = w.latencies_s()
    measured = {
        "programs_per_s": (len(done) * batch / seconds, "programs/s"),
        "latency_p95_ms": (float(np.percentile(latencies, 95)) * 1e3
                           if latencies else float("nan"), "ms"),
        "setup_s": (setup_s, "s")}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        # a cell's own entry of a quantity carries a suffix after the dot
        # (programs_per_s.batch): each cell gets the bound of its spread
        for m in cell.end_to_end:
            value, unit = measured[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": len(w.submitted) * batch,
              "failed": w.failed * batch, "metrics": metrics, "device": dev}
    if trace and probe.result is not None:
        dev["busy_s"] = probe.result["busy_s"]
        dev["window_s"] = probe.result["window_s"]
        result["breakdown"] = {"device_ops": probe.result["device_ops"],
                               "idle_gaps": probe.result["idle_gaps"]}
    result["run"] = {"seed": seed, "seconds": seconds,
                     "requests_in_window": len(done), "batch": batch,
                     "kept": len(queries), "card": card_settings()
                     if on_card else {},
                     "census": record.census if record else None,
                     "setup_parts_s": parts,
                     "phase_ms": phase_ms,
                     "error": w.error or None}
    if "max_abs_error" in readings:
        result["run"]["max_abs_error"] = readings["max_abs_error"]
    result["checks"] = table
    return result, table


def _control_answers(reference, queries: Dict[int, Dict], config: Dict
                     ) -> Dict[int, Dict]:
    """The reference's control in the program's place: the kept requests
    answered as one batch, in request order, so that a control that answers
    a row from another row's query reaches across requests of one row."""
    order = sorted(queries)
    if not order:
        return {}
    inputs = sorted(config["inputs"])
    joint = dict(queries[order[0]])        # the model, which every query holds
    joint.update({name: [row for j in order for row in queries[j][name]]
                  for name in inputs})
    rows = reference.control(joint)
    answers, at = {}, 0
    for j in order:
        size = len(queries[j][inputs[0]])
        answers[j] = {name: [row[name] for row in rows[at:at + size]]
                      for name in config["outputs"]}
        at += size
    return answers


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m fhebench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference's control in the program's "
                         "place (a check of the check; the benchmark's own "
                         "runs never set it)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    from fhebench.harness import check, spec
    cell = spec.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"fhebench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}: no result",
              file=sys.stderr)
        return 3
    result, table = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             control=args.control)
    bad = loaded_forbidden()
    if bad:
        print(f"fhebench: the run loaded {bad} (JAX or the JAX package): "
              "no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    if "max_abs_error" in result["run"]:
        print(f"reading max_abs_error {result['run']['max_abs_error']} "
              f"tolerance {cell.config['tolerance']}", file=sys.stderr)
    for line in check.lines(table):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
