"""Named benchmark circuits for the cone-rewriting config (BASELINE
config 4: "Boolean circuit with cone-rewriting mult-depth reduction
(chi-squared / sorting)").

The reference documents the Aubry et al. pass against exactly these circuit
families (README.md cone-rewriting section; its legacy fixtures are
commented out in test/AstTestingGenerator.cpp:921-986) but ships neither
the pass nor the circuits. These generators emit them as DSL source:

* chi_squared       — the HE-standard chi-squared test statistic (genome-
                      wide association workload): alpha = (4*n0*n2 - n1^2)^2
                      and the three beta terms, written as the naive
                      left-leaning arithmetic the surface syntax produces.
* sorting_comparator— the b-bit greater-than ripple comparator, the core
                      gate of boolean sorting networks: one AND per bit on
                      the carry chain, multiplicative depth b. Written in
                      XOR/AND basis over 0/1 bits (XOR is depth-free).
* sorting_network   — odd-even transposition network over k elements of
                      b bits each, comparators inlined: the depth stacks
                      network stages x comparator depth.
"""

from __future__ import annotations


def chi_squared() -> str:
    """chi-squared statistic circuit over secret genotype counts n0,n1,n2.

    alpha = (4*n0*n2 - n1*n1)^2; beta1 = 2*(2*n0 + n1)^2;
    beta2 = (2*n0 + n1)*(2*n2 + n1); beta3 = 2*(2*n2 + n1)^2.
    Parenthesized exactly as the naive surface form (left-leaning products)
    so the rebalancer + cone rewriter have real work to do."""
    return """
      secret int alpha = (4 *** n0 *** n2 --- n1 *** n1)
                     *** (4 *** n0 *** n2 --- n1 *** n1);
      secret int b12 = 2 *** n0 +++ n1;
      secret int b32 = 2 *** n2 +++ n1;
      secret int beta1 = 2 *** b12 *** b12;
      secret int beta2 = b12 *** b32;
      secret int beta3 = 2 *** b32 *** b32;
      return alpha;
    """


def sorting_comparator(bits: int = 16, a: str = "a", b: str = "b") -> str:
    """gt(a, b) over `bits`-bit operands as the ripple carry chain

        gt_i = (a_i & (b_i ^ 1)) ^ ((a_i ^ b_i ^ 1) & gt_{i-1})

    — one AND per bit on the chain, multiplicative depth = bits. This is
    the canonical linear-depth circuit the Aubry et al. paper reduces to
    O(log bits); every sorting network is a composition of it."""
    expr = f"({a}0 & ({b}0 ^ 1))"
    for i in range(1, bits):
        term_hi = f"({a}{i} & ({b}{i} ^ 1))"
        term_eq = f"(({a}{i} ^ {b}{i} ^ 1) & ({expr}))"
        expr = f"{term_hi} ^ {term_eq}"
    return f"secret int gt = {expr}; return gt;"


def sorting_comparator_inputs(bits: int = 16, a: str = "a", b: str = "b"
                              ) -> str:
    decls = []
    for i in range(bits):
        decls.append(f"secret int {a}{i} = {i % 2};")
        decls.append(f"secret int {b}{i} = {(i + 1) % 2};")
    return " ".join(decls)


def cardio_netlist(bits: int = 8, conditions: int = 10) -> str:
    """The cardio risk score as a BOOLEAN netlist (the form Aubry et al.
    benchmark; the reference's Cardio workload is the arithmetic variant,
    test/end-to-end/CardioTest.cpp): `conditions` risk flags, each a
    `bits`-bit greater-than ripple comparator over secret inputs
    (x{c}_{i} vs t{c}_{i}), summed by a ripple popcount into a 4-bit
    accumulator, and the final verdict is count > threshold (th_{i}).

    Heterogeneous depth profile (deep comparator chains feeding a deep
    ripple adder feeding a final comparator) — the structure where
    minimum-cut cone selection has genuinely different choices from
    deepest-first greedy."""
    stmts = []
    flags = []
    for c in range(conditions):
        expr = f"(x{c}_0 & (t{c}_0 ^ 1))"
        for i in range(1, bits):
            hi = f"(x{c}_{i} & (t{c}_{i} ^ 1))"
            eq = f"((x{c}_{i} ^ t{c}_{i} ^ 1) & ({expr}))"
            expr = f"{hi} ^ {eq}"
        stmts.append(f"secret int f{c} = {expr};")
        flags.append(f"f{c}")
    # ripple popcount: 4-bit accumulator s3..s0, add one flag at a time
    acc = ["z", "z", "z", "z"]      # s0..s3; z is a secret zero input
    tmp = 0
    for c, f in enumerate(flags):
        carry = f
        new_acc = []
        for i in range(4):
            s_n, c_n = f"s{tmp}_{i}", f"c{tmp}_{i}"
            stmts.append(f"secret int {s_n} = {acc[i]} ^ {carry};")
            stmts.append(f"secret int {c_n} = {acc[i]} & {carry};")
            new_acc.append(s_n)
            carry = c_n
        acc = new_acc
        tmp += 1
    # verdict: count > threshold (4-bit gt ripple over secret threshold)
    expr = f"({acc[0]} & (th_0 ^ 1))"
    for i in range(1, 4):
        hi = f"({acc[i]} & (th_{i} ^ 1))"
        eq = f"(({acc[i]} ^ th_{i} ^ 1) & ({expr}))"
        expr = f"{hi} ^ {eq}"
    stmts.append(f"secret int risk = {expr};")
    stmts.append("return risk;")
    return " ".join(stmts)


def cardio_netlist_inputs(bits: int = 8, conditions: int = 10) -> str:
    decls = ["secret int z = 0;"]
    for c in range(conditions):
        for i in range(bits):
            decls.append(f"secret int x{c}_{i} = {(c + i) % 2};")
            decls.append(f"secret int t{c}_{i} = {(c * i) % 2};")
    for i in range(4):
        decls.append(f"secret int th_{i} = {i % 2};")
    return " ".join(decls)


def sorting_network(k: int = 4, bits: int = 4) -> str:
    """Odd-even transposition sort over k single-expression elements of
    `bits` bits: each comparator's swap flag is the inlined gt chain, and
    min/max muxes feed the next stage. Emitted as straight-line statements
    (stage outputs named), so the depth accumulates stage x comparator."""
    stmts = []
    # elements are pre-bound names e{j}_{i} (bit i of element j)
    cur = [[f"e{j}_{i}" for i in range(bits)] for j in range(k)]
    tmp = 0
    for stage in range(k):
        start = stage % 2
        nxt = [list(row) for row in cur]
        for j in range(start, k - 1, 2):
            a, b = cur[j], cur[j + 1]
            # swap flag: a > b (ripple chain over the bit names)
            expr = f"({a[0]} & ({b[0]} ^ 1))"
            for i in range(1, bits):
                hi = f"({a[i]} & ({b[i]} ^ 1))"
                eq = f"(({a[i]} ^ {b[i]} ^ 1) & ({expr}))"
                expr = f"{hi} ^ {eq}"
            flag = f"f{tmp}"
            stmts.append(f"secret int {flag} = {expr};")
            lo, hi_row = [], []
            for i in range(bits):
                # min = f ? b : a = (f & (a_i ^ b_i)) ^ a_i ; max symmetric
                lo_n, hi_n = f"v{tmp}_{i}", f"w{tmp}_{i}"
                stmts.append(f"secret int {lo_n} = ({flag} & ({a[i]} ^ {b[i]})) ^ {a[i]};")
                stmts.append(f"secret int {hi_n} = ({flag} & ({a[i]} ^ {b[i]})) ^ {b[i]};")
                lo.append(lo_n)
                hi_row.append(hi_n)
            nxt[j], nxt[j + 1] = lo, hi_row
            tmp += 1
        cur = nxt
    stmts.append(f"return {cur[0][0]};")
    return " ".join(stmts)
