"""Device time of a call on the card, without the host's enqueue time.

A probe's kernels take tens of microseconds, about what Python takes to
enqueue them, so CUDA events around a loop of calls would time the host.
:func:`device_ms` captures the calls into a CUDA graph and times the
graph's replay, so the card runs them back to back with no host in the
loop (the counterpart of the JAX probes' jitted scans).
"""
from __future__ import annotations

from typing import Callable

import torch


def device_ms(fn: Callable[[], object], reps: int = 1, repeat: int = 3
              ) -> float:
    """Device milliseconds per fn(): `reps` calls captured into one CUDA
    graph, the least of `repeat` timed replays after a warm-up. fn must be
    capturable (no host synchronization). Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up off the main stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeat):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best
