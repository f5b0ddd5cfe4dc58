"""Seconds of the Green's function per window iteration of kanamori3 (three orbitals): SolveResult.timings["gf"] (the program's synchronized span)."""
from edbench import readers


def read(run):
    return readers.mean_timing(run, "gf")
