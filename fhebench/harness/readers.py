"""What the per-layer metrics' readers (metrics/<name>.py) share. A
reader takes the run (RunRecord) and returns a number, or None where it
finds nothing to read: the harness then leaves the metric out."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from fhebench.harness.spec import kernel_families
from fhebench.harness.trace import family
from fhebench.rooflines.fhe_ops import least_ms


@dataclass
class RunRecord:
    """phase_ms: JittedProgram.phase_ms; factory_ms: the factory's
    constructor (its keys); graph_kernels: {kernel: nodes} of the captured
    graph; trace: trace.reduce_profile of the slice (None: not measured);
    census: {FHE operation: count a replay}; shape: n, L, k, B; layers:
    {layer id: layers/<id>.json}."""
    phase_ms: Dict[str, float]
    factory_ms: float
    graph_kernels: Dict[str, int] = field(default_factory=dict)
    trace: Optional[Dict] = None
    census: Dict[str, int] = field(default_factory=dict)
    shape: Dict[str, int] = field(default_factory=dict)
    layers: Dict[str, Dict] = field(default_factory=dict)


def layer_device_ms(run: RunRecord, layer_id: str) -> Optional[float]:
    """Device ms a replay of the layer's kernels: each kernel family's mean
    time in the slice times its nodes in the graph (so a record the
    profiler lost costs nothing); None where the slice saw none of them."""
    if run.trace is None:
        return None
    bases = kernel_families(run.layers)
    mine = set(run.layers[layer_id]["kernels"])
    nodes: Dict[str, int] = {}
    for name, c in run.graph_kernels.items():
        fam = family(name, bases)
        if fam in mine:
            nodes[fam] = nodes.get(fam, 0) + c
    seen = {fam: run.trace["mean_s"][fam] for fam in nodes
            if fam in run.trace["mean_s"]}
    if not seen or len(seen) < len(nodes):
        return None
    return sum(seen[fam] * nodes[fam] for fam in nodes) * 1e3


def roofline_pct(run: RunRecord, layer_id: str) -> Optional[float]:
    """100 x the least time of the layer's work a replay (its FHE
    operations at their shapes, rooflines/fhe_ops.py) over its kernels'
    device time a replay."""
    ms = layer_device_ms(run, layer_id)
    least = least_ms(run.layers[layer_id]["roofline"], run.census,
                     **run.shape)
    if ms is None or ms <= 0 or least <= 0:
        return None
    return 100.0 * least / ms


def kernels_per_replay(run: RunRecord) -> Optional[int]:
    """Kernel nodes of the captured graph."""
    return sum(run.graph_kernels.values()) or None
