"""Plain reference of programs/hamming.fhe, the reference compiler's
HammingDistance end-to-end test: sum_i (x_i - y_i)^2 over two 4-element
vectors, for bit vectors the hamming distance. Plain Python; imports
nothing of the program under test.

control() breaks a guarantee that the configuration states, since no
narrower arithmetic changes an answer here (bits, distances of 0 to 4):
each row of a batch must be answered from its own query, and the control
answers each row from the next row's query."""

from __future__ import annotations

from typing import Dict, List


def distance(x: List[int], y: List[int]) -> int:
    return sum((a - b) * (a - b) for a, b in zip(x, y))


def answers(query: Dict[str, List[List[int]]]) -> List[Dict]:
    """One {"out": [distance]} a row of the request."""
    return [{"out": [distance(x, y)]} for x, y in zip(query["x"],
                                                       query["y"])]


def control(query: Dict[str, List[List[int]]]) -> List[Dict]:
    """answers() with the rows of the batch shifted by one."""
    rows = answers(query)
    return rows[1:] + rows[:1]
