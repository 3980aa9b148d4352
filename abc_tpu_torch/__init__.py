"""abc_tpu_torch — the PyTorch/CUDA port of abc_tpu's encrypted execution path.

The JAX package `abc_tpu` stays the reference, and this package imports
nothing of it (and never `jax`): it keeps its own copy of the host-only
layers (utils, ast_ir, parser, passes, the runtime executor; the same files
with the import lines renamed) and its own BFV and CKKS: parameters, number
theory, the counter PRNG, keygen, switching keys, encode, encrypt, decrypt,
and the evaluation (modular arithmetic, the negacyclic NTT as hand-written
CUDA kernels for Hopper in csrc/ntt.cu, BEHZ ct·ct multiplication for BFV,
leveled tensor products and exact rescaling for CKKS, hybrid key switching,
Galois rotations), all on the device the caller names.

Storage rule: residues are `torch.int32` tensors holding values in [0, q)
with every prime below 2^30; arithmetic widens to int64, and the CUDA
kernels reinterpret the storage as uint32.

Layout (module for module the reference's):
  utils/ ast_ir/ parser/ passes/   — the compiler, host only
  runtime/executor.py, values.py, backend.py, dummy.py — program execution
  runtime/bfv_backend.py — BFV ciphertext factory for RuntimeVisitor
  runtime/ckks_backend.py — CKKS ciphertext factory (float/double programs)
  runtime/host_constants.py — the tape of host-made values a captured run
                         reads back (both factories)
  runtime/jit_executor.py — whole-program execution: jit_compile_program,
                         JittedProgram (one CUDA graph per program)
  ops/modarith.py      — elementwise RNS arithmetic (torch engine)
  ops/ntt_kernels.py   — NTT kernel wrappers + their plain torch versions
  crypto/numthy.py, params.py — primes and parameter presets
  crypto/prng.py       — Threefry-2x32 streams (numpy words, torch polynomials)
  crypto/ntt.py        — twiddle tables, NttContext over [..., L, n] residues,
                         leveled views (subset)
  crypto/rlwe.py       — what BFV and CKKS share: randomness, keygen, the
                         switching-key composition, Galois tables
  crypto/behz.py       — BEHZ full-RNS ct·ct multiply
  crypto/bfv.py        — BFV: encode/encrypt/decrypt, evaluation
  crypto/ckks.py       — CKKS: encode/encrypt/decrypt, leveled evaluation
  crypto/linalg.py     — packed BSGS matrix-vector product (BFV and CKKS)
  crypto/noise.py      — circuit noise analysis, auto-chosen parameter sets
  circuits.py          — DSL source generators for the benchmark programs
  cli.py, __main__.py  — `python -m abc_tpu_torch <benchmark> <out.csv>`
  utils/profiling.py   — PhaseTimer, ProfilingFactory, device_trace
  convert.py           — context_from_reference, ckks_context_from_reference:
                         a reference context's state (numpy arrays, plain
                         values) → a port context
  utils/checkpoint.py  — circuits, contexts (keys, seeded or full, with or
                         without the secret) and ciphertexts in files, in
                         the reference's format: a client/server split
  parallel/            — meshes of shards (mesh.py: LocalComm on one device,
                         DistComm over torch.distributed), the limb-sharded
                         key switch, the coefficient-sharded NTT and CKKS
                         multiply, the dryrun, multi-process workers
"""

__version__ = "0.3.0"

# the one-stop API: parse → compile → run (see README)
from abc_tpu_torch.parser import Parser  # noqa: F401,E402
from abc_tpu_torch.passes.pipeline import (  # noqa: F401,E402
    CompileOptions, Compiler, compile_program, input_types_from_ast,
    run_compiled,
)
from abc_tpu_torch.runtime.jit_executor import (  # noqa: F401,E402
    JittedProgram, jit_compile_program,
)
