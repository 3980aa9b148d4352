"""Plain reference of programs/laplace.fhe, the reference compiler's
LaplaceSharpening end-to-end test: a 4x4 image sharpened by the 3x3
Laplacian, out[x, y] = 2 img[x, y] - sum_{i, j} w[i, j] img[x + i, y + j]
on the inner pixels (w: 1 around, -8 at the centre), the border copied.
Plain NumPy; imports nothing of the program under test.

answers() computes in int64, exact for every input of the configuration's
domain (BFV's answers are its residues modulo t). control() is the same
function in 16-bit words, the integer width next below the configuration's
20-bit plaintext modulus, put in the program's place to show that the
check fails it."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SIZE = 4
WEIGHTS = np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]])


def sharpen(img: np.ndarray) -> np.ndarray:
    """The program's function on one flat image, in img's dtype (wrapping
    as that dtype wraps)."""
    src = img.reshape(SIZE, SIZE)
    out = src.copy()
    w = WEIGHTS.astype(img.dtype)
    with np.errstate(over="ignore"):
        for x in range(1, SIZE - 1):
            for y in range(1, SIZE - 1):
                conv = (w * src[x - 1:x + 2, y - 1:y + 2]).sum(
                    dtype=img.dtype)
                out[x, y] = src[x, y] * img.dtype.type(2) - conv
    return out.reshape(-1)


def _rows(query: Dict[str, List[List[int]]], dtype) -> List[Dict]:
    return [{"out": [int(v) for v in sharpen(
        np.array(img, dtype=np.int64).astype(dtype))]}
        for img in query["img"]]


def answers(query: Dict[str, List[List[int]]]) -> List[Dict]:
    """One {"out": 16 slots} a row of the request."""
    return _rows(query, np.int64)


def control(query: Dict[str, List[List[int]]]) -> List[Dict]:
    """answers() computed in int16: 16-bit pixels wrap."""
    return _rows(query, np.int16)
