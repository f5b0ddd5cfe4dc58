"""Seconds of fit.chi2_fitgf per window iteration: the benchmark's own span around the call (host clock)."""
from edbench import readers


def read(run):
    return readers.mean_field(run, "fit_s")
