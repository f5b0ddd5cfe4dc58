"""Seconds from process start to the window's start: imports, the card, the kernel library, the model and the warm-up iteration (host clock)."""
from edbench import readers


def read(run):
    return run.setup_s
