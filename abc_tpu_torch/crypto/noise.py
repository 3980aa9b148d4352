"""Noise estimation + automatic parameter selection.

SURVEY.md §7 hard part #6: the reference delegates modulus sizing entirely to
SEAL's defaults (CoeffModulus::BFVDefault) and gives the user no way to know
whether a circuit will decrypt. Here we own it:

  * analyze_circuit — walks a compiled program and extracts the noise-relevant
    shape: secret multiplicative depth, plaintext-multiply count on the
    deepest path, rotation count; residual For loops (unrolling off or
    non-static bounds) are iterated to a depth fixpoint, bounded by the
    static trip count when the header is evaluable;
  * estimate_noise_bits — a conservative per-op bit-growth model calibrated
    against measured invariant-noise budgets (each BFV ct·ct or ct·plain
    multiply costs ≈ log2(2·t·n) bits; rotations/adds cost ~1 bit);
  * choose_parameters — smallest (n, limb-count) whose budget
    q_bits − noise − margin > 0, preferring presets that satisfy the
    HE-standard modulus cap.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from abc_tpu_torch.ast_ir.nodes import (
    Assignment, BinaryExpression, Block, Call, For, OperatorExpression,
    Return, UnaryExpression, Variable, VariableDeclaration,
)
from abc_tpu_torch.crypto.params import BfvParams, _DEFAULT_CHAIN
from abc_tpu_torch.utils.errors import CompilerError
from abc_tpu_torch.utils.operators import Op


# fixpoint cap for loops left in the analyzed program (unrolling off /
# non-static bounds): a body still deepening after this many passes prices
# the circuit past every preset, surfacing a CompilerError instead of a
# silently under-sized chain
_RESIDUAL_LOOP_DEPTH_CAP = 64


def _static_trip_count(loop, cap: int) -> Optional[int]:
    """Trip count of a residual For with a statically-evaluable plain
    header (int i = a; i < b; i = i + c), by interpreting the header with
    the unroller's constant evaluator; None when any part is non-static
    or the count exceeds `cap`."""
    from abc_tpu_torch.passes.unroll import _eval_static

    env: Dict[str, int] = {}

    def run_header_block(block) -> bool:
        for s in block.children():
            if not isinstance(s, (Assignment, VariableDeclaration)) \
                    or not isinstance(s.target, Variable) or s.value is None:
                return False
            v = _eval_static(s.value, env)
            if v is None:
                return False
            env[s.target.identifier] = v
        return True

    if not run_header_block(loop.initializer):
        return None
    trips = 0
    while trips <= cap:
        c = _eval_static(loop.condition, env)
        if c is None:
            return None
        if not c:
            return trips
        trips += 1
        if not run_header_block(loop.update):
            return None
    return None


@dataclass
class CircuitStats:
    mult_depth: int = 0          # ct·ct multiplies on the deepest secret path
    plain_mult_depth: int = 0    # ct·plain multiplies on the deepest path
    rotations: int = 0
    secret_ops: int = 0


def analyze_circuit(compiled) -> CircuitStats:
    """Depth analysis over a compiled program using its taint map."""
    tainted = compiled.secret_tainted
    stats = CircuitStats()
    # variable → (ct_depth, plain_depth) of its current value
    depth: Dict[str, Tuple[int, int]] = {}
    for name, dt in compiled.input_types.items():
        depth[name] = (0, 0)

    def is_secret(node) -> bool:
        return tainted.get(node.unique_node_id, False)

    def expr_depth(node) -> Tuple[int, int]:
        if isinstance(node, Variable):
            return depth.get(node.identifier, (0, 0))
        if isinstance(node, Call) and node.identifier == "rotate":
            if is_secret(node):
                stats.rotations += 1
            return expr_depth(node.arguments[0])
        if isinstance(node, BinaryExpression):
            lc, lp = expr_depth(node.left)
            rc, rp = expr_depth(node.right)
            c, p = max(lc, rc), max(lp, rp)
            op = node.operator.as_plain().op
            if op == Op.MUL and is_secret(node):
                stats.secret_ops += 1
                if is_secret(node.left) and is_secret(node.right):
                    return c + 1, p
                return c, p + 1
            if is_secret(node):
                stats.secret_ops += 1
            return c, p
        if isinstance(node, OperatorExpression):
            ds = [expr_depth(o) for o in node.operands if o is not None]
            c = max((d[0] for d in ds), default=0)
            p = max((d[1] for d in ds), default=0)
            if node.operator.as_plain().op == Op.MUL and is_secret(node):
                k = len(node.operands)
                return c + max(1, math.ceil(math.log2(max(k, 2)))), p
            return c, p
        if isinstance(node, UnaryExpression):
            return expr_depth(node.operand)
        ds = [expr_depth(c) for c in node.children()]
        return (max((d[0] for d in ds), default=0),
                max((d[1] for d in ds), default=0))

    def walk(stmt) -> None:
        if isinstance(stmt, Block):
            for s in stmt.children():
                walk(s)
        elif isinstance(stmt, (Assignment, VariableDeclaration)):
            value = stmt.value
            if value is None:
                return
            d = expr_depth(value)
            target = stmt.target
            if isinstance(target, Variable):
                depth[target.identifier] = d
            stats.mult_depth = max(stats.mult_depth, d[0])
            stats.plain_mult_depth = max(stats.plain_mult_depth, d[1])
        elif isinstance(stmt, Return) and stmt.value is not None:
            d = expr_depth(stmt.value)
            stats.mult_depth = max(stats.mult_depth, d[0])
            stats.plain_mult_depth = max(stats.plain_mult_depth, d[1])
        elif isinstance(stmt, For):
            # residual loop (analysis on a program compiled WITHOUT
            # unrolling, or with non-static bounds): iterate the body to a
            # variable-depth FIXPOINT. Accumulative bodies (sum = sum + x)
            # converge in ≤2 passes; a multiplicative accumulation
            # (acc = acc * x) grows per pass and hits the cap, escalating
            # the chain (ultimately a clear CompilerError) rather than
            # silently under-sizing it — the pre-fix single-pass walk
            # priced such loops at depth 1 regardless of trip count.
            # Statically-evaluable headers bound the passes at the real
            # trip count so small static loops are priced exactly.
            trips = _static_trip_count(stmt, _RESIDUAL_LOOP_DEPTH_CAP)
            walk(stmt.initializer)
            for _ in range(trips if trips is not None
                           else _RESIDUAL_LOOP_DEPTH_CAP):
                before = dict(depth)
                walk(stmt.body)
                walk(stmt.update)
                if depth == before:
                    break
        else:
            for c in stmt.children():
                walk(c) if isinstance(c, Block) else None
    walk(compiled.ast)
    return stats


def estimate_noise_bits(stats: CircuitStats, n: int, t_bits: int) -> int:
    """Conservative invariant-noise estimate (bits consumed from the budget).

    Calibration (measured on this implementation, tests/test_noise.py):
    fresh encryption ≈ log2(B·√(2n)) + t_bits consumed against log2(q);
    each multiply (ct·ct or ct·plain) ≈ t_bits + log2(n) + 2;
    each rotation/key-switch ≈ 2 bits; adds ≈ 1 bit amortized.
    """
    logn = n.bit_length() - 1
    fresh = 6 + (logn + 1) // 2 + 1                 # error·expansion
    per_mult = t_bits + logn + 2
    mults = stats.mult_depth + stats.plain_mult_depth
    return fresh + mults * per_mult + 2 * min(stats.rotations, 8) \
        + max(0, stats.secret_ops.bit_length() - 1)


def choose_parameters(compiled, t_bits: int = 20, engine: str = "np64",
                      seed: Optional[int] = None,
                      security_strict: bool = False) -> BfvParams:
    """Pick the smallest preset that decrypts the circuit with margin.

    security_strict=True skips the dev-grade presets (n ≤ 4096 exceed the
    128-bit modulus budget, crypto/params.py note).
    """
    stats = analyze_circuit(compiled)
    margin = 10
    for n in sorted(_DEFAULT_CHAIN):
        if security_strict and n <= 4096:
            continue
        data_limbs = len(_DEFAULT_CHAIN[n][0])
        q_bits = 30 * data_limbs
        need = estimate_noise_bits(stats, n, t_bits) + t_bits + margin
        if q_bits >= need:
            return BfvParams.create(n, engine=engine, plain_bits=t_bits,
                                    seed=seed)
    raise CompilerError(
        f"no parameter preset large enough: circuit needs ~"
        f"{estimate_noise_bits(stats, 32768, t_bits) + t_bits + margin} bits "
        f"(depth {stats.mult_depth}+{stats.plain_mult_depth})")


def auto_params_report(compiled, t_bits: int = 20, engine: str = "np64",
                       seed: Optional[int] = None,
                       security_strict: bool = False):
    """choose_parameters + a client-facing record of WHY (the round-5 user
    surface: CLI --auto-params / jit_compile_program(auto_params=True)).

    Returns (params, report): report carries the chosen set, the predicted
    noise consumption, the remaining decryption margin in bits, and whether
    the set satisfies the HE-standard 128-bit budget (sub-128-bit sets are
    flagged AND warned via check_modulus_budget's warning path)."""
    from abc_tpu_torch.crypto.params import HE_STANDARD_BUDGET_BITS

    params = choose_parameters(compiled, t_bits=t_bits, engine=engine,
                               seed=seed, security_strict=security_strict)
    stats = analyze_circuit(compiled)
    q_bits = sum(q.bit_length() for q in
                 params.coeff_modulus[:params.L])
    noise = estimate_noise_bits(stats, params.n, t_bits)
    total_bits = sum(q.bit_length() for q in params.coeff_modulus)
    budget = HE_STANDARD_BUDGET_BITS.get(params.n)
    secure = budget is not None and total_bits <= budget
    if not secure:
        import warnings
        warnings.warn(
            f"auto-chosen parameters (n={params.n}, {total_bits} modulus "
            f"bits) exceed the HE-standard 128-bit-security budget"
            + (f" of {budget} bits" if budget is not None else "")
            + "; they carry NO security claim", stacklevel=2)
    report = {
        "n": params.n,
        "data_limbs": params.L,
        "ks_digits": params.ks_digits,
        "plain_bits": t_bits,
        "q_bits": q_bits,
        "predicted_noise_bits": noise,
        "predicted_margin_bits": q_bits - noise - t_bits,
        "mult_depth": stats.mult_depth,
        "plain_mult_depth": stats.plain_mult_depth,
        "rotations": stats.rotations,
        "he_standard_128bit": secure,
    }
    return params, report


def choose_ckks_parameters(compiled, engine: str = "np64",
                           seed: Optional[int] = None,
                           security_strict: bool = False):
    """CKKS analogue of choose_parameters (round-5; closes the "per-circuit
    scale_bits selection" gap, crypto/ckks.py:95-103): pick (n, levels,
    scale_bits) from the compiled circuit's shape.

      levels     = total multiplicative depth (ct·ct + ct·plain each cost
                   one rescale level) + 1 working level
      scale_bits = the smallest value keeping the FINAL scale (after
                   `depth` rescales by ~30-bit primes,
                   ≈ 2^(scale_bits·(depth+1) − 30·depth)) at least
                   ~6 bits above the ~2^17 absolute noise floor (n·B_err
                   — the crypto/ckks.py:95-101 precision hazard, found
                   live by tests/test_auto_params_fuzz.py: at the old
                   fixed 25 a depth-2 circuit's scale fell to 2^15,
                   under the floor), and never below 25 nor above 29
                   (the scale must stay under the 30-bit primes);
                   rotating circuits keep the prime-sized-29 rule
      n          = smallest ring with levels+1 30-bit primes inside the
                   HE-standard 128-bit budget (security_strict skips
                   dev-grade sets that overflow it)

    Returns (CkksParams, report dict)."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.params import HE_STANDARD_BUDGET_BITS

    stats = analyze_circuit(compiled)
    depth = stats.mult_depth + stats.plain_mult_depth
    levels = max(2, depth + 1)
    # final scale ≈ 2^(s·(depth+1) − 30·depth) must clear the noise floor
    # (~2^17 absolute) with ~6 bits of headroom; solve for s
    target_final_bits = 17 + 6
    scale_bits = max(25, math.ceil(
        (target_final_bits + 30 * depth) / (depth + 1)))
    # capacity cap: the final scale must also leave the LAST limb ≥5 bits
    # of coefficient headroom (q0 is 30-bit), i.e. final ≤ 25 bits
    scale_bits = min(scale_bits, max(25, (25 + 30 * depth) // (depth + 1)))
    if stats.rotations > 0 and depth > 0:
        scale_bits = max(scale_bits, 29)      # prime-sized: stays put
    scale_bits = min(scale_bits, 29)          # must stay under the primes
    bits_needed = 30 * (levels + 1)           # + the special prime
    chosen_n = None
    for n, budget in sorted(HE_STANDARD_BUDGET_BITS.items()):
        if n < 2048:
            continue
        if budget >= bits_needed:
            chosen_n = n
            break
    secure = chosen_n is not None
    if chosen_n is None:
        # over-budget dev fallback: biggest table ring, warned
        chosen_n = max(HE_STANDARD_BUDGET_BITS)
        if security_strict:
            raise CompilerError(
                f"no 128-bit-secure CKKS preset holds {levels} levels "
                f"({bits_needed} modulus bits)")
        import warnings
        warnings.warn(
            f"auto-chosen CKKS parameters (n={chosen_n}, {bits_needed} "
            "modulus bits) exceed the HE-standard 128-bit budget; they "
            "carry NO security claim", stacklevel=2)
    params = CkksParams.create(chosen_n, levels=levels, engine=engine,
                               seed=seed, scale_bits=scale_bits)
    report = {
        "scheme": "ckks", "n": chosen_n, "levels": levels,
        "scale_bits": scale_bits, "mult_depth": depth,
        "rotations": stats.rotations, "he_standard_128bit": secure,
    }
    return params, report
