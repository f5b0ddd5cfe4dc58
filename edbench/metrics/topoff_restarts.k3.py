"""Mean thick restarts of the two-stage solve's mixed top-off per window iteration of kanamori3: SolveResult.timings["topoff_restarts"] (program counter; absent, and the metric left out, where the program does not report it)."""
from edbench import readers


def read(run):
    return readers.mean_timing(run, "topoff_restarts")
