from fhebench.harness.readers import roofline_pct


def read(run):
    """The key switches' least time over their kernels' device time, %."""
    return roofline_pct(run, "keyswitch")
