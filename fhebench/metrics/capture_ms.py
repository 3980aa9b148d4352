def read(run):
    """The warm-up walk and the graph's capture, ms (phase_ms warmup +
    capture)."""
    if "capture" not in run.phase_ms:
        return None
    return run.phase_ms.get("warmup", 0.0) + run.phase_ms["capture"]
