"""Benchmark CLI — the `ast_demo` equivalent.

Reference: examples/main.cpp (`ast_demo <benchmark_name> <output_filename>`,
:27-48). The reference's "demo" benchmark writes a HARDCODED CSV copied from
the authors' paper (comment at examples/main.cpp:39-40); this CLI runs the
named workload for real and writes measured timings in the same schema:
    t_keygen,t_input_encryption,t_computation,t_decryption
(milliseconds, examples/main.cpp:41-42; also the benchmark-fleet protocol,
Docker/run_all.sh:13-20).

Usage:
    python -m abc_tpu_torch <benchmark> <output.csv> [--backend bfv|dummy]
        [--slots N] [--runs K] [--device cuda|cpu] [--auto-params]
        [--profile DIR]
With no flags the workload runs encrypted on the card (`--backend bfv
--device cuda`) and fails where there is none; the host-only cleartext
simulator (`--backend dummy`) and the CPU (`--device cpu`) are explicit
choices.
Benchmarks: cardio | hamming | boxblur | dotproduct | l2distance | matvec
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Tuple

from abc_tpu_torch.parser import Parser
from abc_tpu_torch.passes.pipeline import (
    CompileOptions, Compiler, input_types_from_ast,
)
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.utils.profiling import SpanRecorder


def _workload(name: str) -> Tuple[str, str, str, CompileOptions]:
    """(inputs, program, outputs, options) per benchmark."""
    if name == "cardio":
        inputs = """
          int sex = 1; int antecedents = 1; int smoker = 0; int diabetes = 0;
          int high_blood_pressure = 1; int age = 22; int hdl_cholesterol = 12;
          int height = 53; int weight = 73; int phy_activity = 10;
          int drinking_habits = 0;
        """
        program = """
          int r = 0;
          if (sex == 1) { if (age > 50) { r = r + 1; } }
          if (sex == 0) { if (age > 60) { r = r + 1; } }
          r = r + antecedents; r = r + smoker; r = r + diabetes;
          r = r + high_blood_pressure;
          if (hdl_cholesterol < 40) { r = r + 1; }
          if (weight > height - 90) { r = r + 1; }
          if (phy_activity < 30) { r = r + 1; }
          if (sex == 1) { if (drinking_habits > 3) { r = r + 1; } }
          if (sex == 0) { if (drinking_habits > 2) { r = r + 1; } }
          return r;
        """
        return inputs, program, "riskScore = r;", CompileOptions()
    if name == "hamming":
        inputs = "secret int x = {1,1,0,1}; secret int y = {1,0,1,1};"
        program = """
          int sum = 0;
          for (int i = 0; i < 4; i = i + 1) {
            sum = sum + (x[i]-y[i])*(x[i]-y[i]);
          }
          return sum;
        """
        return inputs, program, "sum = sum;", CompileOptions(vectorize=True)
    if name == "dotproduct":
        inputs = "secret int x = {7,2,0,5}; secret int y = {1,3,4,2};"
        program = """
          int sum = 0;
          for (int i = 0; i < 4; i = i + 1) { sum = sum + x[i]*y[i]; }
          return sum;
        """
        return inputs, program, "sum = sum;", CompileOptions(vectorize=True)
    if name == "l2distance":
        inputs = "secret int x = {10,12,-4,7}; secret int y = {3,-2,9,1};"
        program = """
          int sum = 0;
          for (int i = 0; i < 4; i = i + 1) {
            sum = sum + (x[i]-y[i])*(x[i]-y[i]);
          }
          return sum;
        """
        return inputs, program, "sum = sum;", CompileOptions(vectorize=True)
    if name == "boxblur":
        img = ",".join(str((i * 37) % 256) for i in range(64))
        inputs = f"int img = {{{img}}}; int imgSize = 8;"
        program = """
          int weightMatrix = {1, 1, 1, 1, 1, 1, 1, 1, 1};
          int img2 = img;
          for (int x = 1; x < imgSize-1; x = x + 1) {
            for (int y = 1; y < imgSize-1; y = y + 1) {
              int value = 0;
              for (int j = -1; j < 2; j = j + 1) {
                for (int i = -1; i < 2; i = i + 1) {
                  value = value + weightMatrix[(i + 1)*3 +j + 1]
                      *img[((x + i)*imgSize + (y + j))];
                }
              }
              img2[imgSize*x + y] = value;
            }
          }
          return img2;
        """
        return inputs, program, "img2 = img2;", CompileOptions()
    if name == "matvec":
        # plain 8x8 matrix x secret packed vector: the vectorizer emits the
        # baby-step/giant-step diagonal form (O(sqrt k) key switches); the
        # client packs x REPLICATED per CompiledProgram.aux
        k = 8
        m_vals = [((i * 5 + j * 3) % 7) + 1 for i in range(k)
                  for j in range(k)]
        x_vals = [(i % 5) + 1 for i in range(k)]
        inputs = ("int M = {" + ",".join(map(str, m_vals)) + "};"
                  " secret int x = {" +
                  ",".join(map(str, x_vals + x_vals)) + "};")
        terms = " + ".join(f"M[{k}*s+{j}]*x[{j}]" for j in range(k))
        program = (
            "int y = 0;"
            f"for (int s = 0; s < {k}; s = s + 1) {{ y[s] = {terms}; }}"
            "return y;")
        return inputs, program, "y = y;", CompileOptions(vectorize=True)
    raise SystemExit(f"unknown benchmark {name!r}; see --help")


def run_benchmark(name: str, backend: str = "bfv", slots: int = 1024,
                  runs: int = 1, device="cuda", auto_params: bool = False,
                  tracer: Optional[SpanRecorder] = None) -> Dict[str, float]:
    """Run one workload through the per-op executor (not the whole-program
    graph of runtime/jit_executor.py) and time its four phases as spans of
    `tracer` (a fresh SpanRecorder by default), the device drained at both
    ends of each; with the tracer activated, what the library builds inside
    a phase is a span of it too. `device` is where the bfv backend
    evaluates; the dummy backend is host-only and does not read it."""
    inputs_src, program_src, output_src, options = _workload(name)
    input_ast = Parser.parse(inputs_src)
    output_ast = Parser.parse(output_src)
    compiled = Compiler(options).compile_source(
        program_src, input_types_from_ast(input_ast))

    chosen_params = None
    if auto_params:
        if backend != "bfv":
            raise SystemExit("--auto-params requires --backend bfv")
        # noise-driven parameter selection (crypto/noise.py): size the
        # modulus chain from the compiled circuit instead of the fixed
        # preset — the reference can only run SEAL's BFVDefault
        from abc_tpu_torch.crypto.noise import auto_params_report
        chosen_params, report = auto_params_report(compiled, seed=1)
        compiled.auto_params = report
        print(f"auto-params: n={report['n']} ({report['data_limbs']} data "
              f"limbs, {report['q_bits']} q-bits), predicted noise "
              f"{report['predicted_noise_bits']} bits, margin "
              f"{report['predicted_margin_bits']} bits, 128-bit-secure="
              f"{report['he_standard_128bit']}", file=sys.stderr)

    import torch
    if tracer is None:
        tracer = SpanRecorder()
    if backend == "bfv" and torch.device(device).type == "cuda" and \
            torch.cuda.is_available():
        tracer.sync = lambda: torch.cuda.synchronize(device)

    best: Dict[str, float] = {}
    for _ in range(max(1, runs)):
        with tracer.activated():
            with tracer.span("keygen") as keygen:
                if backend == "dummy":
                    from abc_tpu_torch.runtime.dummy import \
                        DummyCiphertextFactory
                    factory = DummyCiphertextFactory(slots)
                elif backend == "bfv":
                    from abc_tpu_torch.runtime.bfv_backend import \
                        BfvCiphertextFactory
                    if chosen_params is not None:
                        from abc_tpu_torch.crypto.bfv import BfvContext
                        factory = BfvCiphertextFactory(
                            context=BfvContext(chosen_params, device))
                    else:
                        factory = BfvCiphertextFactory(slots=slots, seed=1,
                                                       device=device)
                else:
                    raise SystemExit(f"unknown backend {backend!r}")

            with tracer.span("input_encryption") as encrypt:
                rv = RuntimeVisitor(factory, input_ast,
                                    compiled.secret_tainted)

            with tracer.span("computation") as compute:
                rv.execute_ast(compiled.ast)
                outputs = rv.get_output(output_ast)

            from abc_tpu_torch.runtime.values import AbstractCiphertext
            with tracer.span("decryption") as decrypt:
                decrypted = {ident: (factory.decrypt(v)
                                     if isinstance(v, AbstractCiphertext)
                                     else v.values)
                             for ident, v in outputs}

        timings = {"t_keygen": keygen.ms,
                   "t_input_encryption": encrypt.ms,
                   "t_computation": compute.ms,
                   "t_decryption": decrypt.ms}
        if not best or timings["t_computation"] < best["t_computation"]:
            best = timings
            best["_outputs"] = decrypted
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="abc_tpu_torch",
                                 description="FHE benchmark CLI of the "
                                             "PyTorch/CUDA port (ast_demo "
                                             "equivalent)")
    ap.add_argument("benchmark",
                    choices=["cardio", "hamming", "boxblur", "dotproduct",
                             "l2distance", "matvec"])
    ap.add_argument("output", help="CSV output path ('-' for stdout)")
    ap.add_argument("--backend", default="bfv", choices=["bfv", "dummy"],
                    help="bfv: encrypted, on --device; dummy: the host-only "
                         "cleartext simulator")
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=1,
                    help="repetitions; best computation time is reported "
                         "(fleet protocol uses NUM_RUNS=10, benchmarks.yml:27)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the bfv backend evaluates; cuda without a "
                         "GPU is an error")
    ap.add_argument("--auto-params", action="store_true",
                    help="size the BFV parameter set from the compiled "
                         "circuit's noise profile (crypto/noise.py) "
                         "instead of the fixed --slots preset; warns when "
                         "the chosen set is below 128-bit security")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the run to "
                         "DIR/trace.json and the program's spans (the four "
                         "phases, key builds, Galois tables, each "
                         "encryption's draws and device pass) to "
                         "DIR/spans.json (open with Perfetto)")
    args = ap.parse_args(argv)

    import contextlib
    tracer = SpanRecorder()
    if args.profile:
        from abc_tpu_torch.utils.profiling import device_trace
        trace_cm = device_trace(args.profile, tracer)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm:
        result = run_benchmark(args.benchmark, args.backend, args.slots,
                               args.runs, args.device,
                               auto_params=args.auto_params, tracer=tracer)
    outputs = result.pop("_outputs", {})
    header = "t_keygen,t_input_encryption,t_computation,t_decryption"
    row = ",".join(f"{result[k]:.3f}" for k in header.split(","))
    csv = f"{header}\n{row}\n"
    if args.output == "-":
        sys.stdout.write(csv)
    else:
        with open(args.output, "w") as f:
            f.write(csv)
    for ident, vals in outputs.items():
        shown = list(vals[:8])
        print(f"{ident}: {shown}{'...' if len(vals) > 8 else ''}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
