"""The B4 GF chain launches' least time (edbench.roofline, which counts every chain of a launch) over their kernels' device time in the kanamori3 trace, per cent."""
from edbench import readers


def read(run):
    return readers.roofline_pct(run, ("B4",))
