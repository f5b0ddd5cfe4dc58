"""Per cent of the traced kanamori3 window in which the card ran no kernel, copy or set (torch.profiler, CUDA activity)."""
from edbench import readers


def read(run):
    return readers.idle_pct(run)
