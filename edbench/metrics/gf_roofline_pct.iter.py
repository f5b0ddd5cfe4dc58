"""The B4 GF chain launches' least time (edbench.roofline) over their kernels' device time in the trace, per cent."""
from edbench import readers


def read(run):
    return readers.roofline_pct(run, ("B4",))
