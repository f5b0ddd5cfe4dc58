"""Helpers the metric readers (``metrics/<name>.py``) share. Each reader
is ``read(run) -> float | None``; None leaves the metric out of the
result line."""
from __future__ import annotations

from typing import Optional

import numpy as np


def per_iteration(run) -> Optional[float]:
    """Seconds per iteration: the window over the iterations it ran."""
    return run.window_s / len(run.window) if run.window else None


def mean_timing(run, key: str) -> Optional[float]:
    vals = [r["timings"][key] for r in run.window if key in r["timings"]]
    return float(np.mean(vals)) if vals else None


def mean_field(run, key: str) -> Optional[float]:
    vals = [r[key] for r in run.window]
    return float(np.mean(vals)) if vals else None


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(run, kernels) -> Optional[float]:
    """The least time of the window's launches of `kernels` over their
    device time in the trace, in per cent."""
    if run.trace is None or run.launches is None:
        return None
    busy = sum(run.trace["by_class"].get(k, 0.0) for k in kernels)
    bound = run.launches.bound_s(kernels)
    if busy <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / busy
