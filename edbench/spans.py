"""The port's own spans and counters in a traced run: the program's
recorder (``dmft_lanc_ed_tpu_torch.utils.observability.trace``) turned on
around the traced window, the card's idle time given to the innermost
program span open at each idle instant, and the readers of the metrics
that those spans and counters give.

The recorder's clock is ``time.perf_counter_ns``, the host clock that
``harness._window`` aligns to the card with its marker kernel, so the
program's spans take the offset the loop's own phases take.

    python3 -m edbench.spans --workload <cell> --seed <n> --seconds <s>
    python3 -m edbench.spans --workload <cell> --seed <n> --cost <k>

from the repository root, on a card. The first runs one traced window
(``torch.profiler`` and the recorder) and prints, as one JSON line, the
span metrics, the idle split by span, each span's self seconds and the
counters per iteration. The second runs `k` window iterations with the
recorder on and off in turn (on, off, off, on, ...) without the profiler,
and prints each iteration's seconds: what the recorder costs.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import harness, spec, tracing

OUTSIDE = "outside program spans"
BUILD = "ed.op_build"


@dataclass
class TracedRun(harness.Run):
    """A traced run with the program's record (``observability.Record``)
    and the card's idle seconds given to each of its spans."""
    record: Optional[object] = None
    span_idle: Optional[List[float]] = None


def _idle_clock(events, t0_dev: int, t1_dev: int):
    """The card's idle nanoseconds in [t0_dev, t] as a function of t."""
    busy = tracing._merge([(max(a, t0_dev), min(b, t1_dev))
                           for _, a, b in events if b > t0_dev and a < t1_dev])
    starts = [a for a, _ in busy]
    before = [0]
    for a, b in busy:
        before.append(before[-1] + b - a)

    def idle(t: int) -> int:
        t = min(max(t, t0_dev), t1_dev)
        i = bisect.bisect_right(starts, t) - 1
        held = before[i] + min(t, busy[i][1]) - busy[i][0] if i >= 0 else 0
        return t - t0_dev - held
    return idle


def self_idle(events, t0_dev: int, t1_dev: int, spans: Sequence,
              offset: int) -> Tuple[List[float], float]:
    """Idle seconds of the card in each span's self time (its interval
    less its children's, device = host + offset), and those outside every
    span. Spans nest, so each idle instant falls to exactly one span, the
    innermost open one, or outside: the values sum to the idle seconds of
    [t0_dev, t1_dev]."""
    idle = _idle_clock(events, t0_dev, t1_dev)
    kids: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for sp in spans:
        if sp.parent >= 0:
            kids[sp.parent].append((sp.start + offset, sp.end + offset))
    out = []
    covered = 0
    for i, sp in enumerate(spans):
        s, e = sp.start + offset, sp.end + offset
        ns = 0
        for c0, c1 in sorted(kids.get(i, ())):
            c0, c1 = max(c0, s), min(c1, e)
            if c0 > s:
                ns += idle(c0) - idle(s)
            s = max(s, c1)
        if e > s:
            ns += idle(e) - idle(s)
        out.append(ns * 1e-9)
        if sp.parent < 0:
            covered += idle(sp.end + offset) - idle(sp.start + offset)
    return out, (idle(t1_dev) - covered) * 1e-9


def idle_by_span(events, t0_dev: int, t1_dev: int, spans: Sequence,
                 offset: int) -> Dict[str, float]:
    """The card's idle seconds by the name of the innermost program span
    open at each idle instant, and :data:`OUTSIDE` for the rest; each idle
    second once."""
    per, outside = self_idle(events, t0_dev, t1_dev, spans, offset)
    return _by_name(per, outside, spans)


def _by_name(per: List[float], outside: float, spans) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for sp, s in zip(spans, per):
        out[sp.name] += s
    out[OUTSIDE] = outside
    return dict(out)


def _under(spans, name: str) -> List[bool]:
    """Whether each span is `name` or lies inside one."""
    inside: List[bool] = []
    for sp in spans:
        inside.append(sp.name == name or (sp.parent >= 0
                                          and inside[sp.parent]))
    return inside


def self_seconds(spans) -> Dict[str, float]:
    """Each span name's self seconds: durations less the children's."""
    out: Dict[str, float] = defaultdict(float)
    for sp in spans:
        d = (sp.end - sp.start) * 1e-9
        out[sp.name] += d
        if sp.parent >= 0:
            out[spans[sp.parent].name] -= d
    return dict(out)


# -- the metric readers: None where the run holds no record ---------------
def _record(run):
    rec = getattr(run, "record", None)
    return rec if rec is not None and run.window else None


def build_s(run) -> Optional[float]:
    """Seconds of host operator builds (``ed.op_build``, every site) per
    window iteration."""
    rec = _record(run)
    if rec is None:
        return None
    inside = _under(rec.spans, BUILD)
    ns = sum(sp.end - sp.start for sp in rec.spans
             if sp.name == BUILD and not (sp.parent >= 0
                                          and inside[sp.parent]))
    return ns * 1e-9 / len(run.window)


def builds_per_sector(run) -> Optional[float]:
    """Operator builds (``op_builds.<site>``) over the distinct sectors
    each solve scanned (``ed.sector``) or took as GF targets
    (``ed.gf_chains``)."""
    rec = _record(run)
    if rec is None:
        return None
    builds = sum(v for k, v in rec.counters.items()
                 if k.startswith("op_builds."))
    sectors = {(sp.solve, sp.attrs.get("qn")) for sp in rec.spans
               if sp.name in ("ed.sector", "ed.gf_chains")}
    return builds / len(sectors) if sectors else None


def h2d_mb(run) -> Optional[float]:
    """Megabytes the port copied host to device (``h2d_bytes``) per window
    iteration."""
    rec = _record(run)
    if rec is None:
        return None
    return rec.counters.get("h2d_bytes", 0) / 1e6 / len(run.window)


def eigh_s(run) -> Optional[float]:
    """Seconds of host ``eigh`` (``ed.eigh``) per window iteration."""
    rec = _record(run)
    if rec is None:
        return None
    return sum(sp.end - sp.start for sp in rec.spans
               if sp.name == "ed.eigh") * 1e-9 / len(run.window)


def bucket_restarts(run) -> Optional[float]:
    """Thick restarts of the batched buckets per window iteration: the
    change of ``ops.batched.bucket_counts["restarts"]`` over each bucket
    (``ed.bucket``'s ``restarts``)."""
    rec = _record(run)
    if rec is None:
        return None
    return sum(sp.attrs.get("restarts", 0) for sp in rec.spans
               if sp.name == "ed.bucket") / len(run.window)


def idle_build_pct(run) -> Optional[float]:
    """Per cent of the traced window in which the card is idle and the
    innermost program span is ``ed.op_build`` or inside one."""
    rec = _record(run)
    per = getattr(run, "span_idle", None)
    if rec is None or per is None or not run.trace or \
            run.trace["window_s"] <= 0:
        return None
    inside = _under(rec.spans, BUILD)
    return 100.0 * sum(s for s, u in zip(per, inside) if u) \
        / run.trace["window_s"]


READERS = {"build_s": build_s, "builds_per_sector": builds_per_sector,
           "h2d_mb": h2d_mb, "eigh_s": eigh_s,
           "bucket_restarts": bucket_restarts,
           "idle_build_pct": idle_build_pct}


# -- the traced window and the recorder's cost -----------------------------
def traced_run(loop, seconds: float, setup_s: float = 0.0) -> TracedRun:
    """``harness._window``'s traced window with the program's recorder on
    around it; the device events that the window's summary reduces are
    kept to give the idle time to the program's spans."""
    from dmft_lanc_ed_tpu_torch.utils.observability import trace
    seen = {}
    summarize = tracing.summarize

    def keep(events, t0_dev, t1_dev, phases, offset):
        seen.update(events=events, t0=t0_dev, t1=t1_dev, offset=offset)
        return summarize(events, t0_dev, t1_dev, phases, offset)
    tracing.summarize = keep
    try:
        with trace.recording() as record:
            window_s, window, summary, launches = harness._window(
                loop, seconds, True)
    finally:
        tracing.summarize = summarize
    per = None
    if seen:
        per, outside = self_idle(seen["events"], seen["t0"], seen["t1"],
                                 record.spans, seen["offset"])
        summary["idle_by_span"] = _by_name(per, outside, record.spans)
    return TracedRun(setup_s=setup_s, window_s=window_s, window=window,
                     trace=summary, launches=launches, record=record,
                     span_idle=per)


def split(run: TracedRun) -> Dict:
    """What one traced run shows: the span metrics, the idle split (top
    10 names), the share of the solve's idle time left in the self time
    of ``ed.solve``, ``ed.diag`` and ``ed.gf``, and per iteration each
    name's self seconds, the counters and the spans."""
    n = len(run.window)
    rec = run.record
    out = {"iterations": n, "window_s": run.window_s,
           "metrics": {k: f(run) for k, f in READERS.items()},
           "self_s": {k: v / n for k, v in sorted(
               self_seconds(rec.spans).items(), key=lambda kv: -kv[1])},
           "counters": {k: v / n for k, v in rec.counters.items()},
           "spans": len(rec.spans) / n,
           "spans_by_name": {k: v / n for k, v in
                             Counter(sp.name for sp in rec.spans).items()}}
    if run.span_idle is not None:
        by = run.trace["idle_by_span"]
        out["idle_spans"] = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        out["idle_s"] = run.trace["window_s"] - run.trace["busy_s"]
        solve = _under(rec.spans, "ed.solve")
        in_solve = sum(s for s, u in zip(run.span_idle, solve) if u)
        opaque = sum(s for s, sp in zip(run.span_idle, rec.spans)
                     if sp.name in ("ed.solve", "ed.diag", "ed.gf"))
        out["idle_in_solve_s"] = in_solve
        out["opaque_share"] = opaque / in_solve if in_solve else None
        out["idle_by_phase"] = run.trace["idle_by_phase"]
    return out


def off_cost_ns(calls: int = 200000) -> Dict[str, float]:
    """Nanoseconds a ``span`` (bare and with three attributes), ``count``
    and ``add`` call takes with the recorder off, on this host's CPU: a
    loop of calls less the empty loop."""
    from dmft_lanc_ed_tpu_torch.utils.observability import trace
    q = ((6,), (6,))

    def empty(n):
        for _ in range(n):
            pass

    def span(n):
        for _ in range(n):
            with trace.span("ed.x"):
                pass

    def span_attrs(n):
        for _ in range(n):
            with trace.span("ed.x", qn=q, dim=853776, route="chain"):
                pass

    def count(n):
        for _ in range(n):
            trace.count("h2d_bytes", 8)

    def add(n):
        for _ in range(n):
            trace.add("ed.x", 0, 1)

    def clock(fn):
        t0 = time.perf_counter_ns()
        fn(calls)
        return time.perf_counter_ns() - t0
    base = min(clock(empty) for _ in range(3))
    return {fn.__name__: (min(clock(fn) for _ in range(3)) - base) / calls
            for fn in (span, span_attrs, count, add)}


def cost(loop, iterations: int) -> Dict:
    """`iterations` window iterations with the recorder on and off in turn
    (on, off, off, on, ...); each iteration's seconds by side, and the
    recorder's spans and counter calls per traced iteration."""
    from dmft_lanc_ed_tpu_torch.utils.observability import trace
    walls = {"on": [], "off": []}
    spans = calls = 0
    count = trace.count

    def counted(name, n=1):
        nonlocal calls
        calls += trace.on
        count(name, n)
    trace.count = counted
    try:
        for i in range(iterations):
            on = (i % 4) in (0, 3)
            if on:
                with trace.recording() as rec:
                    r = loop.window_iteration()
                spans += len(rec.spans)
            else:
                r = loop.window_iteration()
            walls["on" if on else "off"].append(r["wall_s"])
    finally:
        del trace.count
    n_on = max(len(walls["on"]), 1)
    return {"wall_s": walls, "spans": spans / n_on,
            "counter_calls": calls / n_on}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m edbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0)
    args = ap.parse_args(argv)
    cache = os.path.join(spec.ROOT, ".edbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    import torch
    if not torch.cuda.is_available():
        harness.say("edbench.spans: no CUDA device (no CPU fallback)")
        return 2
    from .loop import Loop
    cell = spec.load_cell(args.workload)
    loop = Loop(cell.config, cell.traffic, args.seed, "cuda")
    loop.run_warmup()
    out = {"cell": cell.name, "seed": args.seed, "card": harness.card_info()}
    if args.cost:
        out.update(cost(loop, args.cost))
        out["off_cost_ns"] = off_cost_ns()
    else:
        run = traced_run(loop, args.seconds, time.perf_counter() - t_start)
        out.update(split(run))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
