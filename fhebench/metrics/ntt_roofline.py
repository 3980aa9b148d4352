from fhebench.harness.readers import roofline_pct


def read(run):
    """The transforms' least time over the NTT kernels' device time, %."""
    return roofline_pct(run, "ntt")
