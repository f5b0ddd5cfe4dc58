"""One run of one cell: set-up, the measured window, the metrics, and the
check against the plain reference. ``run.py`` is its command line."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import check, spec
from .loop import Loop

FORBIDDEN = {"jax", "jaxlib", "flax", "dmft_lanc_ed_tpu"}
MARKER = "spin_kernel"       # torch.cuda._sleep's kernel: aligns the clocks
WINDOW_SAMPLES = 1           # window iterations the reference redoes


@dataclass
class Run:
    """What the metric readers read: the set-up and window seconds, the
    window's iteration records, and in a traced run the trace's summary
    and the chain launches."""
    setup_s: float
    window_s: float
    window: List[Dict]
    trace: Optional[Dict] = None
    launches: Optional[object] = None


def parse(argv):
    ap = argparse.ArgumentParser(prog="edbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi not read ({exc})"
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _window(loop: Loop, seconds: float, traced: bool):
    """Whole iterations until `seconds` have passed; returns (window
    seconds, its records, trace summary, launches)."""
    import torch
    from . import tracing as trace
    cuda = str(loop.device).startswith("cuda")
    n0 = len(loop.records)
    spans: Optional[list] = [] if traced else None
    launches = trace.Launches() if traced else None
    prof = _profiler() if traced and cuda else None
    if prof is not None:
        prof.start()
        torch.cuda.synchronize()
        h_marker = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with launches.installed() if traced else contextlib.nullcontext():
        h0 = time.perf_counter_ns()
        t0 = time.perf_counter()
        while True:
            loop.window_iteration(spans)
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        h1 = time.perf_counter_ns()
    summary = None
    if prof is not None:
        prof.stop()
        events = trace.device_events(prof)
        marks = [a for name, a, _ in events if MARKER in name]
        offset = (marks[0] - h_marker) if marks else (
            min(a for _, a, _ in events) - h0)
        if not marks:
            say("trace: no marker kernel; device clock aligned to the first "
                "operation")
        events = [e for e in events if MARKER not in e[0]]
        summary = trace.summarize(events, h0 + offset, h1 + offset, spans,
                                  offset)
        del prof
    return window_s, loop.records[n0:], summary, launches


def _metrics(cell: spec.Cell, run: Run, traced: bool) -> Dict:
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        val = spec.reader(m["name"], cell.parts)(run)
        if val is not None:
            out[m["name"]] = {"value": float(val), "unit": m["unit"]}
    return out


def _breakdown(summary: Dict) -> Dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_phase"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def main(argv, t_process: float, root: str = spec.ROOT,
         parts: Optional[str] = None, device: str = "cuda",
         require_card: bool = True, workers: int = 0) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload, root, parts)
    traced = bool(args.trace)
    import torch
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            say(f"edbench: {cell.name} needs {cell.chips} CUDA device(s); "
                f"this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " (no CPU fallback)")
            return 2
        say(f"card: {card_info()}; devices {torch.cuda.device_count()}")
    import dmft_lanc_ed_tpu_torch as pt
    pkg = os.path.dirname(os.path.abspath(pt.__file__))
    if os.path.commonpath([pkg, spec.ROOT]) != spec.ROOT:
        say(f"edbench: the port was imported from {pkg}, outside the "
            f"checkout {spec.ROOT}")
        return 2

    loop = Loop(cell.config, cell.traffic, args.seed, device)
    loop.run_warmup()
    say(f"warm-up: {len(loop.records)} iteration(s), "
        f"{[round(r['wall_s'], 3) for r in loop.records]} s")
    setup_s = time.perf_counter() - t_process
    window_s, window, summary, launches = _window(loop, args.seconds, traced)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device.startswith("cuda") else 0)
    found = forbidden_modules()
    if found:
        say(f"edbench: modules loaded that the benchmark forbids: {found}")
        return 3
    run = Run(setup_s=setup_s, window_s=window_s, window=window,
              trace=summary, launches=launches)
    say(f"window: {len(window)} iterations in {window_s:.3f} s")
    for r in window:
        t = r["timings"]
        say(f"  iteration {r['wall_s']:.3f} s: diag {t['diag']:.3f}, gf "
            f"{t['gf']:.3f}, fit {r['fit_s']:.3f}, polish {r['polish_s']:.3f}"
            f", sectors {len(r['sectors'])}, ground {r['ground']}")
    metrics = _metrics(cell, run, traced)
    records = list(loop.records)
    loop.release()
    del loop

    # the check: window iterations drawn from the seed, each redone by
    # the reference from the bath it took
    rng = np.random.default_rng(args.seed % (1 << 63))
    nwin = len(window)
    picks = sorted(len(records) - nwin + int(i) for i in rng.choice(
        nwin, size=min(nwin, WINDOW_SAMPLES),
        replace=False))
    t_ref = time.perf_counter()
    worst: Dict[str, float] = {}
    failed = 0
    for i in picks:
        vals = check.check_record(cell.config, cell.traffic, records[i],
                                  args.seed + i, workers, log=say)
        verdict = check.judge(vals, cell.limits)
        failed += not all(ok for _, _, ok in verdict.values())
        for k, v in vals.items():
            worst[k] = max(worst.get(k, -np.inf), v)
    say(f"reference: iterations {picks} checked in "
        f"{time.perf_counter() - t_ref:.1f} s")
    verdict = check.judge(worst, cell.limits)
    correct = all(ok for _, _, ok in verdict.values())

    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = _breakdown(summary)
        say(f"trace: {summary['events']} device operations; chain kernels "
            f"{summary['by_class']}")
    result["checks"] = {k: [v, lim] for k, (v, lim, _) in verdict.items()}
    for k, (v, lim, ok) in verdict.items():
        say(f"check {k}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
