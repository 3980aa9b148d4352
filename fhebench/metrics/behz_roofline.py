from fhebench.harness.readers import roofline_pct


def read(run):
    """The BEHZ multiplies' least time over their kernels' device time,
    %."""
    return roofline_pct(run, "behz")
