from fhebench.harness.readers import kernels_per_replay


def read(run):
    """Kernel nodes of the captured graph (program_counter)."""
    return kernels_per_replay(run)
