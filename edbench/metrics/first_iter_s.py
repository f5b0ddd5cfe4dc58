"""Wall seconds per cold first iteration (new solver, full scan): the window over its iterations (host clock)."""
from edbench import readers


def read(run):
    return readers.per_iteration(run)
