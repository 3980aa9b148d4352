"""The one traffic generator: a pool of distinct requests drawn from the
seed, by the configuration's input domains and the traffic's sizes. Every
seed gives the same sizes, batch and pool; only the values differ, and the
work of an FHE program does not depend on its values.

Configuration keys read: `inputs` ({name: {"length", "low", "high"}}: each
secret input a vector of `length` integers drawn uniformly from [low,
high), or with `"kind": "real"` of reals drawn uniformly from [low, high),
declared `secret double`), `plain_inputs` ({name: int}, or a domain as an
input's with `"kind": "real"` and optionally `l1_norm`: a vector drawn
once a run from the seed, scaled so that its absolute values sum to
`l1_norm`, and declared `double`: a model that the program holds as
constants). Traffic keys read: `batch` (requests a replay), `pool`
(replays' worth of distinct requests the clients cycle through)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _real(spec: Dict) -> bool:
    return spec.get("kind") == "real"


def draw_pool(config: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """`pool` entries of `batch` rows each: [{name: [batch value-vectors]}].
    No row repeats in the pool while the inputs' domain has rows to spare
    (a small domain, such as two 4-bit vectors, is then drawn whole, in
    the seed's order; real inputs leave the domain unbounded)."""
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    inputs = config["inputs"]
    names = sorted(inputs)
    domain = 1
    for name in names:
        spec = inputs[name]
        if not _real(spec):
            domain *= (int(spec["high"]) - int(spec["low"])) ** int(
                spec["length"])
    want = batch * pool
    if want > domain and not any(_real(inputs[n]) for n in names):
        raise ValueError(f"{want} distinct requests asked of a domain of "
                         f"{domain}")
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < want:
        row = {name: _draw(rng, inputs[name]) for name in names}
        key = tuple(tuple(row[name]) for name in names)
        if key in seen:
            continue
        seen.add(key)
        rows.append(row)
    return [{name: [rows[p * batch + r][name] for r in range(batch)]
             for name in names} for p in range(pool)]


def _draw(rng, spec: Dict) -> list:
    if _real(spec):
        return rng.uniform(float(spec["low"]), float(spec["high"]),
                           int(spec["length"])).tolist()
    return [int(v) for v in rng.integers(spec["low"], spec["high"],
                                         int(spec["length"]))]


def draw_plain(config: Dict, seed: int) -> Dict[str, List[float]]:
    """The plain inputs drawn from the seed ({name: values}; none for a
    configuration whose plain inputs are all fixed), from a generator of
    their own, so that they leave the requests' draws as they are."""
    rng = np.random.default_rng([seed, 2])
    out = {}
    for name, spec in sorted(config.get("plain_inputs", {}).items()):
        if not isinstance(spec, dict):
            continue
        values = np.asarray(_draw(rng, spec), dtype=np.float64)
        if "l1_norm" in spec:
            values *= float(spec["l1_norm"]) / np.abs(values).sum()
        out[name] = values.tolist()
    return out


def inputs_source(config: Dict, row: Dict[str, List[int]],
                  plain: Optional[Dict[str, List[float]]] = None) -> str:
    """The DSL input declarations of one request: its secret vectors, the
    configuration's fixed plain inputs and the drawn ones (`plain`,
    draw_plain's)."""
    parts = []
    for name in sorted(row):
        if _real(config["inputs"][name]):
            parts.append(f"secret double {name} = "
                         f"{{{','.join(map(repr, row[name]))}}};")
        else:
            parts.append(f"secret int {name} = "
                         f"{{{','.join(map(str, row[name]))}}};")
    parts += [f"int {name} = {int(v)};"
              for name, v in sorted(config.get("plain_inputs", {}).items())
              if not isinstance(v, dict)]
    parts += [f"double {name} = {{{','.join(map(repr, v))}}};"
              for name, v in sorted((plain or {}).items())]
    return " ".join(parts)


def output_source(config: Dict) -> str:
    """The DSL output assignments: `out_name = program_variable;`."""
    return " ".join(f"{name} = {spec['from']};"
                    for name, spec in sorted(config["outputs"].items()))
