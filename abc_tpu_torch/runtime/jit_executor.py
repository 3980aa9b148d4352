"""Whole-program execution: a DSL circuit as ONE CUDA graph (port of
abc_tpu/runtime/jit_executor.py, single device).

The reference runs its tree-walking executor once as the JAX tracer and gets
one XLA executable. Here the same executor runs once under
`torch.cuda.graph`: every kernel the program launches (the hand-written NTT
kernels and the elementwise RNS chains alike) is recorded into one graph
that reads static input tensors and writes static output tensors. A run is
then `copy_` of the fresh ciphertexts into the inputs, one `graph.replay()`,
and clones of the outputs: no tree walk and no Python per op. Cleartext
control flow (loop bounds, literal indices) is evaluated while capturing, as
it is at trace time in JAX.

What a capture needs of the code it records (crypto/bfv.py's module note has
the context's side of it):

* no host-to-device copy and no host synchronisation between
  `ensure_eval_ready` and the decrypt boundary. Whatever the evaluation
  makes from host data is made by one eager warm-up run first: lazily built
  tables and keys stay in the context, plaintext operands and in-program
  encryptions go onto a HostConstants tape (runtime/host_constants.py) that
  the capture run reads back. The capture uses the default error mode, so a
  stray copy raises;
* the context's identity-keyed caches are emptied around every run
  (BfvContext.fresh_caches), or the capture run would find the warm-up's
  operand transforms under the same static tensor and leave them out of the
  graph;
* Python-side counters (`context.counters`, `ntt_kernels.launches`) move
  while capturing and not at replay. A replay that changes either walked the
  tree again.

On a CPU device there is nothing to capture: `run_raw` runs the executor
eagerly on the tensors it is given, the first run recording the tape and
later runs reading it (so in-program encryptions are constants of the
program on both devices). That is the caller's choice of device, never a
fallback: a CUDA device captures or raises.

Both schemes run this way: a BfvCiphertextFactory's ciphertexts carry no
metadata, a CkksCiphertextFactory's carry (level, scale), which are Python
values and so constants of the captured program, as they are trace-time
constants in the reference. `run_raw` on fresh inputs needs ciphertexts of
the inputs' own level and scale, which `encrypt_inputs` gives (full level,
base scale).

Mesh execution (`mesh=`, `batch_values=`; parallel/mesh.py): a BATCH of
independent input sets is sharded over the mesh's "dp" axis and, for BFV,
every key switch of the program over its "limb" axis
(BfvContext.set_limb_sharding: each shard lifts, transforms and multiplies
its digit rows of the switching key, one modular psum combines them). The dp
axis is the leading batch axis of BfvContext's evaluation half, so a BFV
program is walked once over [B, 2, L, n] tensors; CKKS contexts take one
ciphertext, so a CKKS program is walked once per row of the batch (and is
dp-only, as in the reference: the leveled digit count varies per switch).
On a LocalComm mesh the walk is captured as ONE CUDA graph like any other;
a DistComm rank runs its share eagerly (its collectives are NCCL or gloo
calls, which the graph does not hold) and, limb-sharded, holds only its
digit rows of each switching key (BfvContext.shard_keys).

Protocol mirrors the reference's three-AST harness: input declarations /
program / output assignments.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List

import torch

from abc_tpu_torch.ast_ir.nodes import (
    Block, ExpressionList, Literal, VariableDeclaration,
)
from abc_tpu_torch.passes.pipeline import CompiledProgram
from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
from abc_tpu_torch.runtime.host_constants import HostConstants
from abc_tpu_torch.runtime.executor import RuntimeVisitor
from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu_torch.utils.errors import RuntimeExecutionError
from abc_tpu_torch.utils.timing import capture_graph


class JittedProgram:
    """A compiled DSL program as one CUDA graph.

    run() executes the program on the encrypted inputs of the input AST and
    returns decrypted outputs; run_raw(tensors) executes it on fresh
    ciphertext tensors of the same shapes without walking the tree again.

    phase_ms: host-clock milliseconds of the set-up, the device drained at
    each mark. `key_census` + `key_build` are keygen (the reference CSV's
    t_keygen), `encrypt` is input encryption, `warmup` the eager run that
    fills every lazily built table and the host-constants tape, `capture`
    the recording and instantiation of the graph.
    device_bytes: on a CUDA device, what the set-up left on the card:
    `total` (allocated after minus before: keys, tape, static inputs and the
    live outputs) and `graph_pool` (memory the capture reserved: the graph's
    private pool, which keeps the program's peak of temporaries between
    replays).
    """

    def __init__(self, compiled: CompiledProgram,
                 factory: AbstractCiphertextFactory,
                 input_ast: Block, output_ast: Block,
                 mesh=None, batch_values=None):
        """mesh: an optional parallel.mesh.Mesh with axes ("dp", "limb") on
        the factory's device (module note). batch_values: {input_name: [B
        value-vectors]}, per-row secret input values (names omitted repeat
        the input AST's declaration); B must be divisible by the dp axis.
        A rank of a DistComm mesh holds, encrypts into its inputs and
        returns its own dp rows (`rows`: their indices in the batch)."""
        if not isinstance(factory, (BfvCiphertextFactory,
                                    CkksCiphertextFactory)):
            raise RuntimeExecutionError(
                f"{type(factory).__name__} does not implement the "
                "whole-program protocol (jit_pack/jit_unpack on device "
                "tensors); abc_tpu_torch has it for BFV and CKKS")
        self.factory = factory
        self.compiled = compiled
        self.input_ast = input_ast
        self.output_ast = output_ast
        self.auto_params = None
        self.device_bytes = None
        ctx = factory.context
        self.device = ctx.device
        on_card = self.device.type == "cuda"
        self.mesh = mesh
        self.batch: int = 0
        self.rows = None
        if mesh is not None:
            from abc_tpu_torch.parallel.mesh import Mesh, same_device
            if not isinstance(mesh, Mesh) or "dp" not in mesh.shape \
                    or "limb" not in mesh.shape:
                raise RuntimeExecutionError(
                    'mesh execution needs a parallel.mesh.Mesh with axes '
                    '("dp", "limb")')
            if not same_device(mesh.device, self.device):
                raise RuntimeExecutionError(
                    f"the mesh's shards are on {mesh.device}, the factory's "
                    f"context on {self.device}")
        elif batch_values is not None:
            raise RuntimeExecutionError(
                "batch_values= needs mesh= (the batch is sharded over its "
                "dp axis)")
        # a DistComm rank's collectives are process-group calls: it runs
        # eagerly, a LocalComm mesh is captured like a single device
        capture = on_card and (mesh is None or mesh.is_local)
        self.phase_ms: Dict[str, float] = {}
        if on_card:
            torch.cuda.synchronize(self.device)
            allocated0 = torch.cuda.memory_allocated(self.device)
        _t0 = time.perf_counter()

        def _mark(phase):
            nonlocal _t0
            if on_card:
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            self.phase_ms[phase] = self.phase_ms.get(phase, 0.0) + \
                (now - _t0) * 1e3
            _t0 = now

        # scheme tables built at first use (BFV's BEHZ context) and the
        # kernel library, outside any capture
        ctx.ensure_eval_ready()
        _mark("eval_ready")

        # input preparation: evaluate declarations, encrypt all secrets in
        # one batched device pass
        self.secret_inputs: Dict[str, torch.Tensor] = {}
        self._input_meta: Dict[str, object] = {}
        self._plain_entries = []
        self._secret_types = {}
        self._input_dtype: Dict[str, object] = {}
        secret_decls = []
        for decl in input_ast.children():
            if not isinstance(decl, VariableDeclaration) or decl.value is None:
                raise RuntimeExecutionError(
                    "input AST must be initialized VariableDeclarations")
            cleartext = _static_cleartext(decl)
            name = decl.target.identifier
            if decl.datatype.secret:
                secret_decls.append((name, decl.datatype, cleartext))
            else:
                self._plain_entries.append((name, decl.datatype, cleartext))
        if secret_decls and mesh is None:
            handles = factory.create_many([c for _, _, c in secret_decls])
            for (name, dt, ctext), handle in zip(secret_decls, handles):
                tensor, meta = factory.jit_pack(handle)
                self.secret_inputs[name] = tensor
                self._input_meta[name] = meta
                self._secret_types[name] = dt
                self._input_dtype[name] = ctext.dtype
        elif mesh is not None:
            batch_values = dict(batch_values or {})
            dp = int(mesh.shape["dp"])
            sizes = {len(v) for v in batch_values.values()}
            if len(sizes) > 1:
                raise RuntimeExecutionError(
                    f"batch_values row counts differ: {sorted(sizes)}")
            B = sizes.pop() if sizes else dp
            if B % dp:
                raise RuntimeExecutionError(
                    f"batch {B} must be divisible by dp={dp}")
            self.batch = B
            self._rows = mesh.local_slice("dp", B)
            self.rows = list(range(B))[self._rows]
            for name, dt, ctext in secret_decls:
                self._secret_types[name] = dt
                self._input_dtype[name] = ctext.dtype
            # every process encrypts the whole batch in one order (the same
            # words on every rank) and keeps its dp rows
            self.secret_inputs = self._encrypt_batch(
                {name: batch_values.get(name) or [list(ctext.values)] * B
                 for name, _, ctext in secret_decls})
        _mark("encrypt")

        tainted = compiled.secret_tainted
        self._out_meta: Dict[str, object] = {}
        self._out_is_ct: Dict[str, bool] = {}
        self._tape = HostConstants()

        def fn(secret_tensors: Dict[str, torch.Tensor]):
            rv = RuntimeVisitor(factory, Block([]), tainted)
            for name, dt, ctext in self._plain_entries:
                rv.globals.declare(name, dt, ctext)
            for name, tensor in secret_tensors.items():
                handle = factory.jit_unpack(tensor, self._input_meta[name])
                rv.globals.declare(name, self._secret_types[name], handle)
            rv.execute_ast(compiled.ast)
            out = {}
            for name, value in rv.get_output(output_ast):
                if isinstance(value, AbstractCiphertext):
                    out[name], self._out_meta[name] = factory.jit_pack(value)
                    self._out_is_ct[name] = True
                elif isinstance(value, Cleartext):
                    out[name] = list(value.values)
                    self._out_is_ct[name] = False
                else:
                    raise RuntimeExecutionError(
                        f"unsupported output value for {name!r}")
            return out

        self._fn = fn if mesh is None else self._mesh_walk(fn)

        # Keys are not arguments of the graph: it reads the context's key
        # tensors. Which keys the program needs is answered by a run on the
        # dummy backend; a key the census missed is built by the warm-up run.
        requests = self._census_key_ids(compiled, input_ast, output_ast)
        _mark("key_census")
        ctx.materialize_keys(sorted(requests or ()))
        _mark("key_build")
        self._limb_ok = mesh is not None and \
            isinstance(factory, BfvCiphertextFactory)
        if self._limb_ok:
            # the "limb" axis shards each switching key's α digit rows; an α
            # the axis does not divide cannot be laid out, and the program
            # runs dp-only with whole keys (the preset chains have α in
            # {5, 6, 13, 27}, rarely divisible by a power-of-two axis)
            limb_ax = int(mesh.shape["limb"])
            alpha = ctx.params.num_ks_digits
            if alpha % limb_ax:
                warnings.warn(
                    f"switching-key digit count does not divide the limb "
                    f"mesh axis ({limb_ax}); keys stay replicated and the "
                    f"limb axis is idle — size the axis to divide the key "
                    f"decomposition rows ([{alpha}])", stacklevel=3)
                self._limb_ok = False
        if self._limb_ok and not mesh.is_local:
            # a rank keeps only its α/limb digit rows of each key (under
            # LocalComm every shard's rows live in this process anyway)
            ctx.shard_keys(mesh)

        self._graph = None
        if not capture:
            _mark("setup_other")
            return
        self._static_in = {name: t.clone()
                           for name, t in self.secret_inputs.items()}
        _mark("setup_other")

        # eager warm-up on a side stream: builds what is built lazily (Galois
        # tables, keys the census missed), loads every kernel the program
        # launches, and records the tape
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.run_eager(self._static_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            _mark("warmup")

            # torch.cuda.graph empties the allocator's cache as it starts; do
            # it here, so that the reserved bytes read before it are the
            # ones left
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(self.device)
            self._graph = torch.cuda.CUDAGraph()
            with capture_graph(self._graph):
                self._static_out = self.run_eager(self._static_in)
            _mark("capture")
        self.device_bytes = {
            "total": torch.cuda.memory_allocated(self.device) - allocated0,
            "graph_pool": torch.cuda.memory_reserved(self.device) - reserved0}

    def _census_key_ids(self, compiled, input_ast, output_ast):
        """Which switching keys will the encrypted run request? Answered by
        executing the compiled circuit on a recording dummy backend:
        rotate_rows(steps) maps to galois element 3^(steps mod n/2) mod 2n
        over the ring degree n in both schemes (BfvContext.rotate_rows,
        CkksContext.rotate), any ct·ct multiply implies the relin key
        (lazy relinearization can only ever key-switch toward s²). Returns
        None if the census cannot run.

        Over-approximation (e.g. a multiply whose relin never fires) only
        costs one unused key build; a key the census misses is built by the
        warm-up run, before the capture — correct, just later."""
        from abc_tpu_torch.runtime.dummy import DummyCiphertext, \
            DummyCiphertextFactory

        ring_n = self.factory.params.n
        census = {"rot": set(), "mult": False}

        class _Ct(DummyCiphertext):
            def multiply(self, other):
                census["mult"] = True
                return super().multiply(other)

            def rotate_rows(self, steps: int):
                census["rot"].add(int(steps))
                return super().rotate_rows(steps)

        class _Factory(DummyCiphertextFactory):
            handle_cls = _Ct

        try:
            # reduced-width shadow: the census needs the SET of rotation
            # steps and whether any ct·ct multiply happens — both
            # independent of the slot count — while every dummy op costs
            # O(slots) numpy work. Any out-of-range index raises, and the
            # warm-up run then builds the keys.
            shadow = _Factory(slots=min(self.factory.slot_count, 2048))
            rv = RuntimeVisitor(shadow, Block([]), compiled.secret_tainted)
            for name, dt, ctext in self._plain_entries:
                rv.globals.declare(name, dt, ctext)
            for decl in input_ast.children():
                if decl.datatype.secret:
                    ct = shadow.create_ciphertext(_static_cleartext(decl))
                    rv.globals.declare(decl.target.identifier, decl.datatype,
                                       ct)
            rv.execute_ast(compiled.ast)
            rv.get_output(output_ast)
        except Exception:
            return None
        requests = set()
        half = ring_n // 2
        for steps in census["rot"]:
            s = steps % half
            if s:
                requests.add(f"galois_{pow(3, s, 2 * ring_n)}")
        if census["mult"]:
            requests.add("relin")
        return requests

    def _mesh_walk(self, walk):
        """The program walk on a mesh: BFV once over the batch rows, with
        limb-sharded key switching when the keys allow it; CKKS once per
        row, the outputs stacked. Cleartext outputs repeat per row."""
        ctx = self.factory.context

        def bfv(secret_tensors):
            rows = len(self.rows)
            if self._limb_ok:
                with ctx.limb_sharded(self.mesh):
                    out = walk(secret_tensors)
            else:
                out = walk(secret_tensors)
            return {name: v if self._out_is_ct[name] else [v] * rows
                    for name, v in out.items()}

        def ckks(secret_tensors):
            outs = [walk({name: t[i] for name, t in secret_tensors.items()})
                    for i in range(len(self.rows))]
            return {name: torch.stack([o[name] for o in outs])
                    if self._out_is_ct[name] else [o[name] for o in outs]
                    for name in outs[0]}

        return bfv if isinstance(self.factory, BfvCiphertextFactory) \
            else ckks

    def _encrypt_batch(self, rows_of: Dict[str, list]
                       ) -> Dict[str, torch.Tensor]:
        """{name: [B value-vectors]} → {name: this process's dp rows of the
        encrypted batch, [rows, 2, L, n]}; one create_many in name order."""
        names = list(rows_of)
        for n in names:
            if len(rows_of[n]) != self.batch:
                raise RuntimeExecutionError(
                    f"{n}: expected {self.batch} rows, got "
                    f"{len(rows_of[n])}")
        handles = self.factory.create_many(
            [Cleartext(list(v), self._input_dtype[n])
             for n in names for v in rows_of[n]])
        out = {}
        for i, n in enumerate(names):
            packed = [self.factory.jit_pack(h)
                      for h in handles[i * self.batch:(i + 1) * self.batch]]
            self._input_meta[n] = packed[0][1]
            out[n] = torch.stack([t for t, _ in packed])[
                self._rows].contiguous()
        return out

    def encrypt_inputs(self, values: Dict[str, object]
                       ) -> Dict[str, torch.Tensor]:
        """Encrypt FRESH input values for run_raw — the serving pattern:
        compile once, then stream new inputs through the same graph.
        values: {input_name: value-vector} (on a mesh: {input_name: [B
        value-vectors]}); names omitted reuse the originally encrypted
        inputs. Returns a dict accepted by run_raw."""
        unknown = set(values) - set(self.secret_inputs)
        if unknown:
            raise RuntimeExecutionError(
                f"unknown secret inputs: {sorted(unknown)}")
        out = dict(self.secret_inputs)
        names = sorted(values)
        if self.batch:
            out.update(self._encrypt_batch({n: values[n] for n in names}))
            return out
        handles = self.factory.create_many(
            [Cleartext(list(values[n]), self._input_dtype[n]) for n in names])
        for n, h in zip(names, handles):
            out[n], _ = self.factory.jit_pack(h)
        return out

    def run_eager(self, secret_tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, object]:
        """The program walked by the executor on these tensors, op by op, as
        a pure function of them: the context's identity caches empty, the
        host-made constants from the program's tape (recorded by the first
        run). This is what run_raw does on a CPU device, what the warm-up
        and the capture run, and what a replay can be held against."""
        with self.factory.context.fresh_caches(), \
                self.factory.host_constants(self._tape):
            return self._fn(secret_tensors)

    def run_raw(self, secret_tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, object]:
        """Execute on ciphertext tensors ({input_name: [2, L, n] int32 on the
        program's device, [rows, 2, L, n] on a mesh}, every secret input
        named). On a CUDA device, but for a DistComm rank:
        copies into the graph's inputs, one replay, fresh clones of its
        outputs. Cleartext outputs are the constants fixed at capture."""
        if set(secret_tensors) != set(self.secret_inputs):
            raise RuntimeExecutionError(
                f"run_raw takes exactly the secret inputs "
                f"{sorted(self.secret_inputs)}, got {sorted(secret_tensors)}")
        for name, t in secret_tensors.items():
            want = self.secret_inputs[name]
            if (t.shape, t.dtype, t.device) != (want.shape, want.dtype,
                                                want.device):
                raise RuntimeExecutionError(
                    f"input {name!r}: expected {tuple(want.shape)} "
                    f"{want.dtype} on {want.device}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
        if self._graph is None:
            return self.run_eager(secret_tensors)
        for name, t in secret_tensors.items():
            self._static_in[name].copy_(t)
        self._graph.replay()
        return {name: v.clone() if self._out_is_ct[name] else list(v)
                for name, v in self._static_out.items()}

    def run(self) -> Dict[str, List]:
        """Execute and decrypt all outputs (host-side decrypt boundary)."""
        return self.decrypt_outputs(self.run_raw(self.secret_inputs))

    def decrypt_outputs(self, raw: Dict[str, object]) -> Dict[str, List]:
        """Decrypt raw outputs (the host decrypt boundary, timeable
        separately from run_raw)."""
        out: Dict[str, List] = {}
        for name, value in raw.items():
            if self._out_is_ct[name] and self.batch:
                # mesh mode: one decrypt per row this process holds
                out[name] = [self.factory.decrypt(self.factory.jit_unpack(
                    value[i], self._out_meta[name]))
                    for i in range(len(self.rows))]
            elif self._out_is_ct[name]:
                handle = self.factory.jit_unpack(value, self._out_meta[name])
                out[name] = self.factory.decrypt(handle)
            else:
                out[name] = list(value)
        return out


def _static_cleartext(decl: VariableDeclaration) -> Cleartext:
    value = decl.value
    if isinstance(value, Literal):
        return Cleartext.from_scalar(value.value, value.literal_type)
    if isinstance(value, ExpressionList):
        vals = []
        dtype = None
        for e in value.expressions:
            if not isinstance(e, Literal):
                raise RuntimeExecutionError(
                    "input declarations must use literal values")
            vals.append(e.value)
            dtype = e.literal_type
        return Cleartext(vals, dtype)
    raise RuntimeExecutionError("input declarations must use literal values")


def jit_compile_program(program_src: str, inputs_src: str, output_src: str,
                        factory: AbstractCiphertextFactory = None,
                        options=None, mesh=None, batch_values=None,
                        auto_params: bool = False, device="cuda",
                        seed=None, plain_bits: int = 20,
                        security_strict: bool = False) -> JittedProgram:
    """Parse + compile + capture in one call.

    mesh/batch_values: run on a ("dp", "limb") mesh (parallel/mesh.py) — see
    JittedProgram.

    auto_params=True sizes the parameter set from the compiled circuit and
    builds the factory itself, on `device`; `factory` must then be None.
    Integer inputs go to BFV (crypto/noise.py choose_parameters, from the
    noise profile), float/double inputs to CKKS (choose_ckks_parameters:
    levels and scale_bits from the multiplicative depth). The chosen
    set + predicted budget land in CompiledProgram.auto_params and
    JittedProgram.auto_params. With a factory given, the program runs on
    the factory's device and `device` is not read.
    """
    from abc_tpu_torch.parser import Parser
    from abc_tpu_torch.passes.pipeline import Compiler, input_types_from_ast

    t0 = time.perf_counter()
    input_ast = Parser.parse(inputs_src)
    output_ast = Parser.parse(output_src)
    compiled = Compiler(options).compile_source(
        program_src, input_types_from_ast(input_ast))
    if auto_params:
        if factory is not None:
            raise RuntimeExecutionError(
                "auto_params=True builds the factory itself; pass "
                "factory=None")
        from abc_tpu_torch.utils.datatype import Type
        if any(dt.type in (Type.FLOAT, Type.DOUBLE)
               for dt in compiled.input_types.values()):
            # approximate circuit → CKKS with per-circuit levels/scale_bits
            from abc_tpu_torch.crypto.ckks import CkksContext
            from abc_tpu_torch.crypto.noise import choose_ckks_parameters
            params, report = choose_ckks_parameters(
                compiled, seed=seed, security_strict=security_strict)
            compiled.auto_params = report
            factory = CkksCiphertextFactory(
                context=CkksContext(params, device))
        else:
            from abc_tpu_torch.crypto.bfv import BfvContext
            from abc_tpu_torch.crypto.noise import auto_params_report
            params, report = auto_params_report(
                compiled, t_bits=plain_bits, seed=seed,
                security_strict=security_strict)
            compiled.auto_params = report
            factory = BfvCiphertextFactory(
                context=BfvContext(params, device))
    elif factory is None:
        raise RuntimeExecutionError(
            "pass a factory or set auto_params=True")
    compile_ms = (time.perf_counter() - t0) * 1e3
    jp = JittedProgram(compiled, factory, input_ast, output_ast,
                       mesh=mesh, batch_values=batch_values)
    jp.phase_ms["parse_compile"] = compile_ms
    jp.auto_params = compiled.auto_params
    return jp
