"""Compilation pipeline.

The reference has NO single compile() entry point — every e2e test assembles
passes manually (SURVEY.md §3.2); the intended order is named by the staged
test stubs (CardioTest.cpp:56-79): typeCheck → CTES → secretBranchingRemoval
→ loopUnrolling → statementVectorization. This module provides that pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from abc_tpu_torch.ast_ir.nodes import AbstractNode, Block, VariableDeclaration
from abc_tpu_torch.parser import Parser
from abc_tpu_torch.passes.ctes import run_ctes
from abc_tpu_torch.passes.secret_branching import run_secret_branching
from abc_tpu_torch.passes.type_checking import TypeCheckingVisitor, run_type_checking
from abc_tpu_torch.passes.unroll import run_loop_unrolling
from abc_tpu_torch.utils.datatype import Datatype


@dataclass
class CompileOptions:
    ctes: bool = True
    secret_branching: bool = True
    loop_unrolling: bool = True
    vectorize: bool = False        # batching pass (off by default, like the
                                   # reference's WIP Vectorizer)
    cone_rewriting: bool = False   # multiplicative-depth reduction
    dead_store_elimination: bool = True   # DFG-backed DSE (passes/dse.py)
    live_out: Optional[set] = None  # output identifiers the client decrypts;
                                    # None keeps every variable's final write
    max_unroll_iterations: int = 65536


@dataclass
class CompiledProgram:
    ast: Block
    tcv: TypeCheckingVisitor
    input_types: Dict[str, Datatype]
    # the vectorizer's packing report (AuxiliaryInformation), or None when
    # batching did not run — carries input packings, result strides,
    # zero-tail and replication contracts for the client
    aux: object = None
    # noise-driven parameter selection record (crypto/noise.py
    # auto_params_report), set by jit_compile_program(auto_params=True) /
    # the CLI's --auto-params: chosen set + predicted budget + security flag
    auto_params: object = None

    @property
    def secret_tainted(self) -> Dict[str, bool]:
        return self.tcv.get_secret_tainted_nodes()


class Compiler:
    """parse → typecheck → CTES → secret-branch lowering → unroll [→ batch]."""

    def __init__(self, options: Optional[CompileOptions] = None):
        self.options = options or CompileOptions()

    def compile_source(self, program_src: str,
                       input_types: Dict[str, Datatype]) -> CompiledProgram:
        return self.compile_ast(Parser.parse(program_src), input_types)

    def compile_ast(self, ast: Block,
                    input_types: Dict[str, Datatype]) -> CompiledProgram:
        opts = self.options
        tcv = run_type_checking(ast, input_types)

        if opts.ctes:
            ast = run_ctes(ast)
            tcv = run_type_checking(ast, input_types)

        if opts.secret_branching:
            run_secret_branching(ast, tcv.get_secret_tainted_nodes(),
                                 input_types.keys())
            tcv = run_type_checking(ast, input_types)

        if opts.loop_unrolling:
            ast = run_loop_unrolling(ast, opts.max_unroll_iterations)
            if opts.ctes:
                ast = run_ctes(ast)   # fold the literal indices just created
            tcv = run_type_checking(ast, input_types)

        if opts.dead_store_elimination:
            # DFG consumer: drop stores no read (or live-out) ever sees,
            # BEFORE batching so the vectorizer never packs dead slots
            from abc_tpu_torch.passes.dse import run_dead_store_elimination
            if run_dead_store_elimination(ast, input_types.keys(),
                                          opts.live_out):
                tcv = run_type_checking(ast, input_types)

        aux = None
        if opts.vectorize:
            from abc_tpu_torch.passes.vectorizer import run_vectorizer_with_aux
            ast, aux = run_vectorizer_with_aux(ast, input_types, tcv)
            tcv = run_type_checking(ast, input_types)

        if opts.cone_rewriting:
            from abc_tpu_torch.passes.cone_rewriter import run_cone_rewriting
            run_cone_rewriting(ast)
            tcv = run_type_checking(ast, input_types)

        return CompiledProgram(ast=ast, tcv=tcv,
                               input_types=dict(input_types), aux=aux)


def compile_program(program_src: str, input_types: Dict[str, Datatype],
                    options: Optional[CompileOptions] = None) -> CompiledProgram:
    return Compiler(options).compile_source(program_src, input_types)


def input_types_from_ast(input_ast: Block) -> Dict[str, Datatype]:
    """Extract {identifier: Datatype} from an input-declarations AST."""
    return {d.target.identifier: d.datatype for d in input_ast.children()
            if isinstance(d, VariableDeclaration)}


def run_compiled(compiled: CompiledProgram, input_ast: Block, output_ast: Block,
                 factory):
    """Execute a compiled program with the three-AST protocol; returns
    (RuntimeVisitor, output pairs)."""
    from abc_tpu_torch.runtime.executor import RuntimeVisitor

    rv = RuntimeVisitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    return rv, rv.get_output(output_ast)
