"""Tracing, profiling and counters (port of
``dmft_lanc_ed_tpu/utils/observability.py``).

Replaces the reference's SF_TIMER wall-clock timers, matvec iteration
counter and sp_spy_matrix gnuplot dumps with:

- :class:`Timer` — nested phase timers;
- :class:`KernelStats` — the module-level matvec / nonzero counters
  ``kernel_stats``, reset at the start of every ``EDSolver.solve`` and
  folded into its ``timings["kernel_*"]``. A matvec is recorded once, where
  the solver runs it: a thick-restart build (``ops/lanczos.py``), a batched
  bucket restart (``ops/batched.py``), a GF chain of the dense scan, the
  sharded scan or B4 (``gf.py``), a B2 or B3 seed chain
  (``ops/bs_chain.py``). B1 and B5 calls run inside a thick restart and
  count there;
- :func:`profile_trace` — a ``torch.profiler`` trace (CPU and, with a
  card, CUDA activity) written to a directory, viewable in TensorBoard or
  Perfetto;
- :func:`spy_matrix` — a sector factor's sparsity pattern as a portable
  bitmap (sp_spy_matrix analogue, no gnuplot needed).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class KernelStats:
    """Global counters for the hot kernels (reset per solve)."""
    matvecs: int = 0
    nnz_applied: int = 0
    seconds: float = 0.0

    def record(self, n_matvecs: int, nnz_per_mv: int, seconds: float = 0.0):
        self.matvecs += n_matvecs
        self.nnz_applied += n_matvecs * nnz_per_mv
        self.seconds += seconds

    def reset(self):
        self.matvecs = 0
        self.nnz_applied = 0
        self.seconds = 0.0

    def summary(self) -> Dict[str, float]:
        out = dict(matvecs=self.matvecs, nnz_applied=self.nnz_applied)
        if self.seconds > 0:
            out["matvecs_per_s"] = self.matvecs / self.seconds
            out["nnz_per_s"] = self.nnz_applied / self.seconds
        return out


kernel_stats = KernelStats()


class Timer:
    """Nested phase timing: with Timer.phase('diag'): ..."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """A torch.profiler trace written to `logdir` (TensorBoard's trace
    handler), CUDA activity included where a card is present; a no-op
    without a logdir."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def spy_matrix(cols: np.ndarray, vals: np.ndarray, n: int, path: str) -> None:
    """Write the sparsity pattern of an ELL factor as a PBM bitmap
    (sp_spy_matrix analogue, ED_SPARSE_MATRIX.f90:452-565)."""
    img = np.zeros((n, n), dtype=np.int8)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    for k in range(cols.shape[1]):
        nz = vals[:, k] != 0
        img[np.nonzero(nz)[0], cols[nz, k]] = 1
    with open(path, "w") as fh:
        fh.write(f"P1\n{n} {n}\n")
        for row in img:
            fh.write(" ".join(str(int(x)) for x in row) + "\n")
