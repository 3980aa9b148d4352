"""Collective-traffic census of a sharded run (port of
abc_tpu/parallel/report.py).

The reference reads the census from the optimized HLO of a compiled
program (hlo_collective_stats); the port has no HLO. Its meshes count the
collectives as they run them instead (parallel/mesh.py: Mesh.census), by
the reference's kind names — `all-reduce` (the key switch's modular psum),
`collective-permute` (the distributed NTT's exchanges), `all-gather` (a
rank gathering a sharded result) — each with its number of ops and the
bytes of one shard's payload per op. A captured CUDA graph runs no Python,
so the census of a program is that of the walk that was captured (or of
any eager walk: they run the same collectives).
"""

from __future__ import annotations

from typing import Callable, Dict


def collective_report(mesh, fn: Callable, *args) -> Dict[str, Dict[str, int]]:
    """{kind: {"ops": count, "bytes": payload bytes}} of the collectives that
    one call fn(*args) runs on `mesh` (run eagerly, here)."""
    before = {k: dict(v) for k, v in mesh.census.items()}
    fn(*args)
    stats = {}
    for kind, v in mesh.census.items():
        b = before.get(kind, {"ops": 0, "bytes": 0})
        if v["ops"] > b["ops"]:
            stats[kind] = {"ops": v["ops"] - b["ops"],
                           "bytes": v["bytes"] - b["bytes"]}
    return stats

