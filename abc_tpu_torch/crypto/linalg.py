"""Packed linear algebra on BFV and CKKS ciphertexts (port of
abc_tpu/crypto/linalg.py): diagonal-method matrix-vector product with
baby-step/giant-step rotation structure and hoisted key switching. Pure
orchestration over the contexts' hoisted_rotations, multiply_plain and
rotations; the diagonals are encoded on the host, one plaintext each.

The reference's MatrixVectorProductTest (test/end-to-end/
MatrixVectorProductTest.cpp) evaluates the product SCALAR-wise in the DSL;
this module is the packed counterpart: one ciphertext holds the
whole vector, and the product is

    y = Σ_{d=0}^{k−1} diag_d ⊙ rot(x, d)                (diagonal method)

restructured BSGS-style (d = g·i + j, g ≈ √k):

    y = Σ_i rot( Σ_j pt_{i,j} ⊙ rot(x, j), g·i ),
    pt_{i,j} = rot⁻¹_{g·i}(diag_{g·i+j})

so only g baby rotations of x (computed with ONE hoisted key-switch
decomposition, BfvContext.hoisted_rotations) plus ~k/g giant rotations are
needed — O(√k) key switches instead of O(k).

Requires the vector length k to equal the batching row size n/2 so slot
rotation wraparound coincides with the cyclic indexing of the diagonals.
"""

from __future__ import annotations

import math

import numpy as np

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.utils.errors import RuntimeExecutionError


def _diag(mat: np.ndarray, d: int) -> np.ndarray:
    k = mat.shape[0]
    t = np.arange(k)
    return mat[t, (t + d) % k]


def matvec_bsgs(ctx: BfvContext, ct: BfvCiphertext,
                mat: np.ndarray) -> BfvCiphertext:
    """Encrypted y = mat·x for x packed in ct's first batching row.

    mat: [k, k] integer matrix with k == n/2 (the batching row size).
    Returns a ciphertext whose row-0 slots hold y.
    """
    mat = np.asarray(mat)
    k = mat.shape[0]
    n = ctx.params.n
    if mat.shape != (k, k) or k != n // 2:
        raise RuntimeExecutionError(
            f"matvec_bsgs needs a square matrix of size n/2={n // 2}, "
            f"got {mat.shape}")
    g = max(1, int(math.isqrt(k)))
    n_giant = (k + g - 1) // g

    # baby rotations of x: ONE hoisted decomposition for all g of them
    baby = ctx.hoisted_rotations(ct, list(range(g)))

    total = None
    giant_steps = []
    partials = []
    for i in range(n_giant):
        acc = None
        for j in range(g):
            d = g * i + j
            if d >= k:
                break
            # pt[u] = diag_d[(u − g·i) mod k] (right-roll): after the giant
            # LEFT rotation by g·i, slot t reads pt[(t+g·i) mod k] = diag_d[t].
            # Both batching rows get the diagonal so row 1 stays well-defined.
            dd = np.roll(_diag(mat, d), g * i)
            pt = ctx.encode(list(dd) + list(dd))
            term = ctx.multiply_plain(baby[j], pt)
            acc = term if acc is None else ctx.add(acc, term)
        if acc is not None:
            giant_steps.append(g * i)
            partials.append(acc)
    # giant rotations (hoisting across DIFFERENT ciphertexts is not
    # applicable; each partial needs its own decomposition)
    for step, part in zip(giant_steps, partials):
        rotated = ctx.rotate_rows(part, step) if step else part
        total = rotated if total is None else ctx.add(total, rotated)
    return total


def matvec_naive(ctx: BfvContext, ct: BfvCiphertext,
                 mat: np.ndarray) -> BfvCiphertext:
    """Plain diagonal method (k key switches) — oracle for the BSGS path."""
    mat = np.asarray(mat)
    k = mat.shape[0]
    total = None
    rots = ctx.hoisted_rotations(ct, list(range(k)))
    for d in range(k):
        dd = _diag(mat, d)
        pt = ctx.encode(list(dd) + list(dd))
        term = ctx.multiply_plain(rots[d], pt)
        total = term if total is None else ctx.add(total, term)
    return total


def matvec_bsgs_ckks(ctx, ct, mat: np.ndarray):
    """CKKS counterpart of matvec_bsgs: encrypted y = mat·x for a real
    matrix over the n/2 complex slots — same baby-step/giant-step rotation
    structure (g baby rotations sharing ONE hoisted decomposition,
    CkksContext.hoisted_rotations; ~k/g giant rotations), diagonals encoded
    as CKKS plaintexts and applied via multiply_plain (size-preserving, no
    relinearization). Result scale = x.scale · plaintext scale; decode uses
    the tracked scale."""
    mat = np.asarray(mat, dtype=np.float64)
    k = mat.shape[0]
    n = ctx.params.n
    if mat.shape != (k, k) or k != n // 2:
        raise RuntimeExecutionError(
            f"matvec_bsgs_ckks needs a square matrix of size n/2={n // 2}, "
            f"got {mat.shape}")
    g = max(1, int(math.isqrt(k)))
    n_giant = (k + g - 1) // g

    baby = ctx.hoisted_rotations(ct, list(range(g)))
    level = ct.level

    total = None
    for i in range(n_giant):
        acc = None
        for j in range(g):
            d = g * i + j
            if d >= k:
                break
            dd = np.roll(_diag(mat, d), g * i)
            pt = ctx.encode(list(dd), level=level)
            term = ctx.multiply_plain(baby[j], pt)
            acc = term if acc is None else ctx.add(acc, term)
        if acc is not None:
            rotated = ctx.rotate(acc, g * i) if i else acc
            total = rotated if total is None else ctx.add(total, rotated)
    return total
