"""The card's rates and the least time of a launch: frozen copies of
chip_smoke.py's `bound`, `ntt_bound`, `behz_imads` and `ks_imads` (reviewed
with the kernels they bound; tests/test_fhebench_bounds.py holds them equal
to chip_smoke.py's at the kernel table's shapes). Frozen here so that a
change to the program cannot change what it is measured against.

HBM_BYTES_S is NVIDIA's data-sheet rate of one H100 SXM (3.35 TB/s). The
integer rates are derived from a clock, not published: 132 SMs x 64 32-bit
multiply-adds (IMAD_S) or 128 integer instructions (INT_ISSUE_S) a clock at
the 1.98 GHz SM clock read under load; a run records `nvidia-smi`'s clocks
and power limit beside them.
"""

HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
INT_ISSUE_S = 132 * 128 * 1.98e9
IMAD_PER_BUTTERFLY = 3                   # one Shoup product
# slots of the multiply-add pipe a step takes: a 32x32 -> 64-bit
# multiply-add, a Shoup product by a table constant, reduce64
BEHZ_IMAD = {"wide": 1, "shoup": 3, "reduce64": 5}


def bound(n_bytes, imads, int_ops=0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate,
    the multiply-adds over IMAD_S and all integer operations over
    INT_ISSUE_S."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = max(imads / IMAD_S, (imads + int_ops) / INT_ISSUE_S) * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def ntt_bound(n, L, rows, inverse):
    """One transform launch of `rows` rows of n over a table of L primes:
    rows in and out, the [L, n] twiddles and companions and q (and n^-1
    with its companion) read once; n/2 log2(n) butterflies a row, and the
    n^-1 scale of the inverse."""
    n_bytes = 4 * (2 * rows * n + 2 * L * n + L + (2 * L if inverse else 0))
    products = rows * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))
    return bound(n_bytes, IMAD_PER_BUTTERFLY * products)


def behz_imads(kernel, K, D):
    """Multiply-adds per coefficient of one row of a BEHZ kernel: K source
    residues, D destinations, each conversion sum reduced once per 16
    products and at its end; behz_tensor counts one limb."""
    w, sh, red = (BEHZ_IMAD[k] for k in ("wide", "shoup", "reduce64"))

    def conv(terms):
        return terms * w + -(-terms // 16) * red

    if kernel == "behz_to_bsk":
        return K * (sh + 1) + 1 + D * (conv(K + 1) + sh)
    if kernel == "behz_fast_floor":
        return K * sh + D * (conv(K + 1) + sh)
    if kernel == "behz_from_bsk":
        return K * (sh + w) + -(-K // 16) * red + sh + D * conv(K + 1)
    return 4 * w + 3 * red


def ks_imads(name, R, A=0, K=1, k=1, Lo=0, halves=2):
    """Multiply-adds per coefficient of one row of a key-switch kernel: R
    columns, A digits of K sources (the lift), key halves (the
    contraction), k primes divided out of Lo + k rows (the mod switch
    down)."""
    w, sh, red = (BEHZ_IMAD[x] for x in ("wide", "shoup", "reduce64"))
    if name == "ks_decompose":
        return 0 if K == 1 else A * (K * sh + R * (K * w + -(-K // 16) *
                                                   red))
    if name == "ks_contract":
        return R * halves * (A * w + -(-A // 16) * red)
    return (Lo * k + k * (k - 1) // 2) * sh
