"""Wall seconds per DMFT iteration: the window over its iterations (host clock)."""
from edbench import readers


def read(run):
    return readers.per_iteration(run)
