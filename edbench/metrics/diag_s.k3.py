"""Seconds of the sector scan per window iteration of kanamori3: SolveResult.timings["diag"] (the program's synchronized span)."""
from edbench import readers


def read(run):
    return readers.mean_timing(run, "diag")
