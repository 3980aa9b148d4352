"""Plain reference of programs/logreg.fhe, encrypted logistic-regression
scoring as in Kim, Song, Kim, Lee, Cheon, "Logistic regression model
training based on the approximate homomorphic encryption" (BMC Medical
Genomics 11(Suppl 4):83, 2018): for each record x of 18 features and the
model (w, b), u = (w.x + b) / 8 and the score 0.5 + c1 u - c3 u^3, the
paper's degree-3 sigmoid approximation g3 on [-8, 8] written in u. Plain
NumPy; imports nothing of the program under test.

answers() computes in float64. control() is the same function with every
value and every operation's result rounded to bfloat16 (8 significant
bits): over 262144 scores its widest gap from answers() reads about 0.01,
and float16's (11 bits, about 0.0013) would lie too close to what a
program at a 2^30 scale leaves to tell the two apart."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

FEATURES = 18
# fit_g3()'s coefficients, as the program states them
C1 = 1.2009097281231012
C3 = 0.8154999022184148


def fit_g3(points: int = 16001):
    """(c1, c3): the least-squares cubic fit of the sigmoid on [-8, 8]
    (Kim et al.'s g3: 0.5 + 0.15012 x - 0.001593 x^3; its even terms
    vanish), written in u = x / 8."""
    x = np.linspace(-8.0, 8.0, points)
    a = np.polynomial.polynomial.polyfit(x, 1.0 / (1.0 + np.exp(-x)), 3)
    return 8.0 * a[1], -512.0 * a[3]


def _bf16(a) -> np.ndarray:
    """The nearest bfloat16 value of each value (8 significant bits, ties
    to even; the scores' magnitudes lie far inside its range), as
    float64."""
    a = np.asarray(a, dtype=np.float64)
    step = np.ldexp(1.0, np.frexp(a)[1] - 8)
    return np.round(a / step) * step


def scores(x: np.ndarray, w: np.ndarray, rnd=lambda v: v) -> np.ndarray:
    """g3 of each record of x ([FEATURES, records]) under the model w
    (FEATURES weights, then the bias), in the program's order of
    operations, each result passed through rnd."""
    x, w = rnd(x), rnd(w)
    u = rnd(x[0] * rnd(w[0] * 0.125))
    for i in range(1, FEATURES):
        u = rnd(u + rnd(x[i] * rnd(w[i] * 0.125)))
    u = rnd(u + rnd(w[FEATURES] * 0.125))
    u3 = rnd(rnd(u * u) * u)
    return rnd(rnd(0.5 + rnd(rnd(C1) * u)) - rnd(rnd(C3) * u3))


def _rows(query: Dict[str, List], rnd) -> List[Dict]:
    w = np.asarray(query["w"], dtype=np.float64)
    rows = len(query["x00"])
    return [{"out": scores(np.array([query[f"x{i:02d}"][r]
                                      for i in range(FEATURES)],
                                     dtype=np.float64), w, rnd).tolist()}
            for r in range(rows)]


def answers(query: Dict[str, List]) -> List[Dict]:
    """One {"out": a score a record} a row of the request; the query holds
    the request's features (x00..x17, each [rows of records]) and the
    model (w)."""
    return _rows(query, lambda v: v)


def control(query: Dict[str, List]) -> List[Dict]:
    """answers() computed in bfloat16."""
    return _rows(query, _bf16)
