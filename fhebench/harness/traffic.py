"""The one traffic generator: a pool of distinct requests drawn from the
seed, by the configuration's input domains and the traffic's sizes. Every
seed gives the same sizes, batch and pool; only the values differ, and the
work of an FHE program does not depend on its values.

Configuration keys read: `inputs` ({name: {"length", "low", "high"}}: each
secret input a vector of `length` integers drawn uniformly from [low,
high)), `plain_inputs` ({name: int}). Traffic keys read: `batch` (requests
a replay), `pool` (replays' worth of distinct requests the clients cycle
through)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def draw_pool(config: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """`pool` entries of `batch` rows each: [{name: [batch value-vectors]}].
    No row repeats in the pool while the inputs' domain has rows to spare
    (a small domain, such as two 4-bit vectors, is then drawn whole, in
    the seed's order)."""
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    inputs = config["inputs"]
    names = sorted(inputs)
    domain = 1
    for name in names:
        spec = inputs[name]
        domain *= (int(spec["high"]) - int(spec["low"])) ** int(
            spec["length"])
    want = batch * pool
    if want > domain:
        raise ValueError(f"{want} distinct requests asked of a domain of "
                         f"{domain}")
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < want:
        row = {name: [int(v) for v in rng.integers(
            inputs[name]["low"], inputs[name]["high"],
            int(inputs[name]["length"]))] for name in names}
        key = tuple(tuple(row[name]) for name in names)
        if key in seen:
            continue
        seen.add(key)
        rows.append(row)
    return [{name: [rows[p * batch + r][name] for r in range(batch)]
             for name in names} for p in range(pool)]


def inputs_source(config: Dict, row: Dict[str, List[int]]) -> str:
    """The DSL input declarations of one request: its secret vectors and
    the configuration's plain inputs."""
    parts = [f"secret int {name} = {{{','.join(map(str, row[name]))}}};"
             for name in sorted(row)]
    parts += [f"int {name} = {int(v)};"
              for name, v in sorted(config.get("plain_inputs", {}).items())]
    return " ".join(parts)


def output_source(config: Dict) -> str:
    """The DSL output assignments: `out_name = program_variable;`."""
    return " ".join(f"{name} = {spec['from']};"
                    for name, spec in sorted(config["outputs"].items()))
