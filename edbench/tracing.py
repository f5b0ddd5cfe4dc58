"""The traced run's instruments: wrappers that record each chain launch
of the port's kernels B2-B4 with its least time (:mod:`.roofline`), and
the reduction of a ``torch.profiler`` trace of the card to busy seconds,
seconds by kernel and idle seconds by host phase, in memory."""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import roofline

# the port's chain entry points and what each launch computes
WRAPPED = {"tridiag_call": ("B2", "lanczos"), "cheb_call": ("B3", "chebyshev"),
           "gf_tridiag_call": ("B4", "lanczos")}

# tc_step<BN, MODE, P> / tc_pass1<P> of csrc/bs_chain_tc.cu: MODE 0 is a
# Lanczos step, 1 a Chebyshev step; P = 2 parts for B2/B3, 3 for B4
_STEP = re.compile(r"tc_step\s*<\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*>")
_PASS1 = re.compile(r"tc_pass1\s*<\s*(\d+)\s*>")
_STEP_M = re.compile(r"tc_stepILi(\d+)ELi(\d+)ELi(\d+)E")
_PASS1_M = re.compile(r"tc_pass1ILi(\d+)E")


def kernel_class(name: str) -> Optional[str]:
    """"B2", "B3" or "B4" for a chain kernel's (demangled or mangled)
    name, else None."""
    m = _STEP.search(name) or _STEP_M.search(name)
    if m:
        mode, parts = int(m.group(2)), int(m.group(3))
        if mode == 1:
            return "B3"
        if mode == 0:
            return "B2" if parts == 2 else "B4"
        return None
    m = _PASS1.search(name) or _PASS1_M.search(name)
    if m:
        return "B2" if int(m.group(1)) == 2 else "B4"
    return None


class Launches:
    """Within the block, every B2/B3/B4 launch the port makes is recorded
    as (kernel, least seconds, chains). The wrappers replace the names in
    ``ops.bs_chain``, where the port's callers look them up."""

    def __init__(self):
        self.records: List[Tuple[str, float, int]] = []

    @contextlib.contextmanager
    def installed(self):
        from dmft_lanc_ed_tpu_torch.ops import bs_chain
        saved = {n: getattr(bs_chain, n) for n in WRAPPED}

        def wrap(name, fn):
            kernel, kind = WRAPPED[name]

            def call(op, v, kk, *a, **k):
                out = fn(op, v, kk, *a, **k)
                if v.is_cuda:
                    pop = bs_chain._pop(op)
                    nb = int(v.shape[0]) if kernel == "B4" else 1
                    sec, _ = roofline.launch_seconds(
                        tuple(pop.padded_shape), int(pop.diag_a.shape[1]),
                        roofline.kept_tiles(pop.trim_runs), int(kk), nb, kind)
                    self.records.append((kernel, sec, nb))
                return out
            return call
        for n, fn in saved.items():
            setattr(bs_chain, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(bs_chain, n, fn)

    def bound_s(self, kernels) -> float:
        return sum(s for k, s, _ in self.records if k in kernels)


def _get(ev, names):
    for n in names:
        f = getattr(ev, n, None)
        if f is not None:
            return f() if callable(f) else f
    raise AttributeError(names)


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation the card ran (kernels,
    copies, sets) in a finished torch.profiler session."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if _get(ev, ("device_type",)) != DeviceType.CUDA:
            continue
        try:
            t0 = int(_get(ev, ("start_ns",)))
            dur = int(_get(ev, ("duration_ns",)))
        except AttributeError:
            t0 = int(_get(ev, ("start_us",)) * 1000)
            dur = int(_get(ev, ("duration_us",)) * 1000)
        out.append((_get(ev, ("name",)), t0, t0 + dur))
    return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, t0_dev: int, t1_dev: int, spans=(), offset: int = 0
              ) -> Dict:
    """Busy seconds inside [t0_dev, t1_dev], seconds by kernel name and
    by chain kernel class, and the idle seconds of each host phase
    (spans on the host clock, device = host + offset)."""
    clipped = [(max(a, t0_dev), min(b, t1_dev)) for _, a, b in events
               if b > t0_dev and a < t1_dev]
    busy = _merge(clipped)
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    for name, a, b in events:
        by_name[name] += (b - a) * 1e-9
        k = kernel_class(name)
        if k:
            by_class[k] += (b - a) * 1e-9
    idle_by_phase: Dict[str, float] = defaultdict(float)
    gaps = []
    prev = t0_dev
    for a, b in busy + [[t1_dev, t1_dev]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((s + offset, e + offset, p) for p, s, e in spans)
    for g0, g1 in gaps:
        rest = g1 - g0
        for s, e, p in host:
            lap = min(e, g1) - max(s, g0)
            if lap > 0:
                idle_by_phase[p] += lap * 1e-9
                rest -= lap
        if rest > 0:
            idle_by_phase["between phases"] += rest * 1e-9
    return dict(busy_s=busy_ns * 1e-9, window_s=(t1_dev - t0_dev) * 1e-9,
                by_name=dict(by_name), by_class=dict(by_class),
                idle_by_phase=dict(idle_by_phase), events=len(events))
