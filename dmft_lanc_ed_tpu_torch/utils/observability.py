"""Tracing, profiling and counters (port of
``dmft_lanc_ed_tpu/utils/observability.py``).

Replaces the reference's SF_TIMER wall-clock timers, matvec iteration
counter and sp_spy_matrix gnuplot dumps with:

- :data:`trace` — the solve's spans and counters (:class:`Tracer`), off
  unless a caller turns it on with ``trace.recording()``. Spans sit at the
  solve's layer boundaries (``ed.solve`` and its ``ed.diag``, ``ed.gf``,
  ``ed.observables``, ``ed.sigma``, ``ed.chi``; per sector ``ed.sector``;
  ``ed.bucket``, ``ed.op_build`` with its ``ed.upload``, ``ed.eigh``, the
  two-stage solve's ``ed.seed``, ``ed.topoff``, ``ed.polish``,
  ``ed.unpad``; the GF's ``ed.gf_excite``, ``ed.gf_chains``,
  ``ed.gf_poles``), counters beside them (``op_builds.<site>``,
  ``h2d_bytes``, ``d2h_bytes``). A span records what the host did and
  never synchronises the device; the card's side comes from a profiler.
  Its clock is ``time.perf_counter_ns``, the host clock that a
  ``torch.profiler`` trace is aligned to by timing one marker kernel
  between two synchronisations, so every span lands on the device
  timeline with that one offset;
- :class:`Timer` — nested phase timers;
- :class:`KernelStats` — the module-level matvec / nonzero counters
  ``kernel_stats``, reset at the start of every ``EDSolver.solve`` and
  folded into its ``timings["kernel_matvecs"]`` and
  ``timings["kernel_nnz_applied"]``. A matvec is recorded once, where
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
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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


class Span:
    """One recorded span: its name, start and end (``perf_counter_ns``),
    the index of its parent in the record's spans (-1 for a root), the
    number of the solve it belongs to (its root's) and its attributes.
    Set an attribute known only inside the span with ``span[key] = value``.
    """
    __slots__ = ("name", "start", "end", "parent", "solve", "attrs",
                 "_tracer")

    def __init__(self, name: str, start: int = 0, end: int = 0,
                 parent: int = -1, solve: int = 0,
                 attrs: Optional[Dict[str, Any]] = None, tracer=None):
        self.name = name
        self.start = start
        self.end = end
        self.parent = parent
        self.solve = solve
        self.attrs = attrs if attrs is not None else {}
        self._tracer = tracer

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._tracer._open(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        self._tracer._close()


class _NoSpan:
    """The span that tracing off hands out: one shared object that
    records nothing."""
    __slots__ = ()

    def __setitem__(self, key, value) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NO_SPAN = _NoSpan()


@dataclass
class Record:
    """What one ``trace.recording()`` block saw: the spans in the order
    they opened, and the counters' sums."""
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)


class Tracer:
    """Spans and counters of the solve, kept in memory while
    :meth:`recording` is on and not at all otherwise: off, :meth:`span`
    tests one flag and returns the shared :data:`NO_SPAN`, and
    :meth:`count` returns at once (no clock read, no allocation of its
    own). A root span opens a new solve number, which its descendants
    carry. Spans nest by a stack, so one thread records at a time."""

    def __init__(self):
        self.on = False
        self._record: Optional[Record] = None
        self._stack: List[int] = []
        self._solves = 0

    def span(self, name: str, **attrs):
        """A context manager timing its block as the span `name`."""
        if not self.on:
            return NO_SPAN
        return Span(name, attrs=attrs, tracer=self)

    def add(self, name: str, start: int, end: int, **attrs) -> None:
        """Record a span whose clock reads the caller took itself
        (``perf_counter_ns``), as a child of the open span."""
        if not self.on:
            return
        sp = Span(name, start, end, attrs=attrs)
        self._open(sp)
        self._stack.pop()

    def count(self, name: str, n: float = 1) -> None:
        """Add `n` to the counter `name`."""
        if not self.on:
            return
        c = self._record.counters
        c[name] = c.get(name, 0) + n

    def _open(self, sp: Span) -> None:
        spans = self._record.spans
        if self._stack:
            sp.parent = self._stack[-1]
            sp.solve = spans[sp.parent].solve
        else:
            self._solves += 1
            sp.solve = self._solves
        self._stack.append(len(spans))
        spans.append(sp)

    def _close(self) -> None:
        self._stack.pop()

    @contextlib.contextmanager
    def recording(self):
        """Turn recording on for the block; yields its :class:`Record`."""
        if self.on:
            raise RuntimeError("trace.recording() is already on")
        self._record = Record()
        self._stack = []
        self.on = True
        try:
            yield self._record
        finally:
            self.on = False
            self._stack = []
            self._record = None


trace = Tracer()


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
