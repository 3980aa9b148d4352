"""The least time of each FHE operation of a BFV or CKKS program, split by
layer and keyed by the operation: the work that a layer's roofline share is
measured against. Counted from the operation, not from the kernels that
run it, so a later change that fuses or replaces kernels is charged the
same work.

An operation's bytes are what no fusion can keep off the card's memory:
its operands from outside it, its result, its switching key and the
transforms' twiddle tables. What it makes and uses inside itself (a
decomposition's digits, the Bsk forms, the accumulators) may stay on
chip, and counting it would let a kernel that finds it in the 50 MB L2
read above 100%. Its operations are all its integer multiply-adds, by the
kernels' own arithmetic (bounds.py). Other tables (a few words a prime)
are left out: the least time stays a least time.

Shape: ring degree n, L data primes, k special primes (R = L + k columns
of the extended base, A = ceil(L / k) digits), B ciphertexts a replay; the
BEHZ base Bsk holds K = L + 2 primes.

Operations (harness/census.py counts them in one walk of the program):
  operand       a ciphertext lifted to Bsk and transformed over q and Bsk
                (BEHZ multiply's per-operand half);
  multiply      the BEHZ tensor product: product, inverse transforms,
                fast floor and the conversion back to q;
  decompose     a key switch's digit lift and its forward transforms
                (shared by rotations of one ciphertext);
  key_switch    the contraction with the key, the accumulators' inverse
                transform and the mod switch down with its tail (a
                relinearization's adds or a rotation's gather of c0);
  plain_product a ciphertext times a plaintext vector: the ciphertext
                read and transformed forward, the pointwise product with
                the plaintext's NTT form (a constant of the program, read
                once), the inverse transforms, the result written;
  plain_scalar  a ciphertext times a scalar constant (a plaintext whose
                slots all hold one value is that constant polynomial):
                one elementwise pass, the ciphertext read and written once
                and each word multiplied by the constant; no transform.

CKKS operations run at falling levels: the census keys them
`<operation>@<level>`, and the level l takes L's place (R = l + k, A =
ceil(l / k)); ckks.py's algorithm, at B = 1:
  ckks_multiply       a ct x ct product: both operands read and
                      transformed forward, the tensor product (behz_tensor,
                      BEHZ's kernel) and the inverse transform of its three
                      components, written;
  ckks_plain_product  a ciphertext times a plaintext vector, as
                      plain_product;
  ckks_plain_scalar   a ciphertext times a scalar constant, as plain_scalar:
                      one elementwise pass;
  ckks_decompose      as decompose (a relinearization's or a rotation's);
  ckks_key_switch     as key_switch;
  ckks_rescale        the last data prime divided out of both components
                      (ks_mod_down at k = 1: the key switch's layer), read
                      at l primes and written at l - 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from fhebench.rooflines.bounds import BEHZ_IMAD, IMAD_PER_BUTTERFLY, \
    behz_imads, bound, ks_imads

OPS = ("operand", "multiply", "decompose", "key_switch", "plain_product",
       "plain_scalar")
CKKS_OPS = ("ckks_multiply", "ckks_plain_product", "ckks_plain_scalar",
            "ckks_decompose", "ckks_key_switch", "ckks_rescale")


def _ntt(n, table, rows, inverse, rows_bytes=0):
    """A transform of `rows` rows of n over a table of `table` primes: its
    twiddles and companions read once, and `rows_bytes` of its rows that
    come from or go to outside the operation; n/2 log2(n) butterflies a
    row, and the n^-1 scale of the inverse (bounds.ntt_bound, which counts
    every row read and written)."""
    n_bytes = rows_bytes + 4 * (2 * table * n + table
                                + (2 * table if inverse else 0))
    products = rows * ((n // 2) * (n.bit_length() - 1)
                       + (n if inverse else 0))
    return ("ntt", bound(n_bytes, IMAD_PER_BUTTERFLY * products)[0])


def launches(op: str, n: int, L: int, k: int, B: int
             ) -> List[Tuple[str, float]]:
    """[(layer, least ms)] of the launches one `op` needs at this shape (a
    CKKS `op` names its level: `ckks_multiply@7`)."""
    if op.startswith("ckks_"):
        return _ckks(op, n, k)
    K, R, A = L + 2, L + k, -(-L // k)
    words = B * L * n                      # one component of B ciphertexts
    if op == "operand":
        return [("behz", bound(4 * 2 * words,
                               B * 2 * n * behz_imads("behz_to_bsk", L,
                                                      K))[0]),
                _ntt(n, L, 2 * B * L, False), _ntt(n, K, 2 * B * K, False)]
    if op == "multiply":
        return [("behz", bound(0,
                               B * (L + K) * n * behz_imads("behz_tensor", 2,
                                                            1))[0]),
                _ntt(n, L, 3 * B * L, True), _ntt(n, K, 3 * B * K, True),
                ("behz", bound(0,
                               B * 3 * n * behz_imads("behz_fast_floor", L,
                                                      K))[0]),
                ("behz", bound(4 * 3 * words,
                               B * 3 * n * behz_imads("behz_from_bsk", K - 1,
                                                      L))[0])]
    if op == "decompose":
        return [("keyswitch", bound(4 * words,
                                    B * n * ks_imads("ks_decompose", R, A,
                                                     k))[0]),
                _ntt(n, R, B * A * R, False)]
    if op == "key_switch":
        return [("keyswitch", bound(4 * 2 * A * R * n,
                                    B * n * ks_imads("ks_contract", R,
                                                     A))[0]),
                _ntt(n, R, 2 * B * R, True),
                # the tail's operand (a rotation's c0, the lesser of the
                # two tails) and the ciphertext written
                ("keyswitch", bound(4 * 3 * words,
                                    2 * B * n * ks_imads("ks_mod_down", R,
                                                         k=k, Lo=L))[0])]
    if op == "plain_product":
        return [_ntt(n, L, 2 * B * L, False, rows_bytes=4 * 2 * words),
                ("elementwise", bound(4 * L * n, 2 * words * (
                    BEHZ_IMAD["wide"] + BEHZ_IMAD["reduce64"]))[0]),
                _ntt(n, L, 2 * B * L, True, rows_bytes=4 * 2 * words)]
    if op == "plain_scalar":
        return [("elementwise", bound(4 * 2 * 2 * words,
                                      2 * words * BEHZ_IMAD["shoup"])[0])]
    raise ValueError(f"unknown FHE operation {op!r} (known: {OPS})")


def _ckks(key: str, n: int, k: int) -> List[Tuple[str, float]]:
    """launches() of a CKKS operation `<op>@<level>`."""
    op, _, level = key.partition("@")
    if op not in CKKS_OPS or not level.isdigit() or int(level) < 1:
        raise ValueError(f"unknown FHE operation {key!r} (known: "
                         f"{CKKS_OPS}, each @<level>)")
    lv = int(level)
    if op == "ckks_multiply":
        words = lv * n
        return [_ntt(n, lv, 4 * lv, False, rows_bytes=4 * 4 * words),
                ("behz", bound(0, words * behz_imads("behz_tensor", 2,
                                                     1))[0]),
                _ntt(n, lv, 3 * lv, True, rows_bytes=4 * 3 * words)]
    if op == "ckks_rescale":
        return [("keyswitch", bound(4 * 2 * (2 * lv - 1) * n,
                                    2 * n * ks_imads("ks_mod_down", lv, k=1,
                                                     Lo=lv - 1))[0])]
    # the others are the BFV operations' formulas at this level
    return launches(op[len("ckks_"):], n, lv, k, 1)


def least_ms(layer: str, census: Dict[str, int], n: int, L: int, k: int,
             B: int) -> float:
    """The least time in ms of `layer`'s work in one replay whose FHE
    operations are `census` ({op: count})."""
    return sum(count * ms for op, count in census.items()
               for lay, ms in launches(op, n, L, k, B) if lay == layer)
