"""Seconds of the f64 eigenpair polish per window iteration of kanamori3: the change of ops.lanczos.polish_counts["s"] (program counter)."""
from edbench import readers


def read(run):
    return readers.mean_field(run, "polish_s")
