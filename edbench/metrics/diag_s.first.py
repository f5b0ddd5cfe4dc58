"""Seconds of the cold sector scan per window iteration: SolveResult.timings["diag"] (the program's synchronized span)."""
from edbench import readers


def read(run):
    return readers.mean_timing(run, "diag")
