"""Seconds of fit.chi2_fitgf (three orbitals) per window iteration of kanamori3: the benchmark's own span around the call (host clock)."""
from edbench import readers


def read(run):
    return readers.mean_field(run, "fit_s")
