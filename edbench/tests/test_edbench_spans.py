"""The program spans' idle attribution and span readers (CPU)."""
import json
import os

import pytest

from dmft_lanc_ed_tpu_torch.utils.observability import Span
from edbench import spans, spec
from edbench.loop import Loop
from edbench.tests import toycell


def _synthetic():
    """Window [0, 100] on the device clock, busy [10, 20] and [50, 60];
    host spans 5 earlier than the device (offset 5): A [2, 80] holds B
    [5, 30] (which holds C [25, 30], ending with it) and D [40, 55]."""
    events = [("k1", 10, 20), ("k2", 50, 60), ("late", 120, 130)]
    sp = [Span("A", -3, 75), Span("B", 0, 25, parent=0),
          Span("C", 20, 25, parent=1), Span("D", 35, 50, parent=0)]
    return events, sp


def test_idle_goes_to_the_innermost_span_once():
    events, sp = _synthetic()
    by = spans.idle_by_span(events, 0, 100, sp, 5)
    # A's self time [2,5] [30,40] [55,80]: 3 + 10 + 20 idle; B's [5,25]
    # less the busy [10,20]; C [25,30] (ends with B); D [40,55] less
    # [50,55]; outside [0,2] and [80,100]
    assert by == pytest.approx({"A": 33e-9, "B": 10e-9, "C": 5e-9,
                                "D": 10e-9, spans.OUTSIDE: 22e-9})
    assert sum(by.values()) == pytest.approx(80e-9)


def test_idle_split_sums_to_the_window_idle_with_repeated_names():
    events, sp = _synthetic()
    sp.append(Span("B", 78, 90))            # a second root, past A
    sp.append(Span("C", 78, 90, parent=4))  # ends with its parent
    per, outside = spans.self_idle(events, 0, 100, sp, 5)
    assert per[4] == 0 and per[5] == pytest.approx(12e-9)
    assert sum(per) + outside == pytest.approx(80e-9)
    by = spans.idle_by_span(events, 0, 100, sp, 5)
    assert by["C"] == pytest.approx(17e-9)
    assert by[spans.OUTSIDE] == pytest.approx(10e-9)
    inside = spans._under(sp, "B")
    assert inside == [False, True, True, False, True, True]


def test_span_readers_on_a_toy_traced_run(tmp_path):
    """On the CPU: the span and counter readers read the record; the idle
    metrics find no device trace and read None, as every reader does on a
    run without a record."""
    from dmft_lanc_ed_tpu_torch.ops.batched import bucket_counts
    root, parts = toycell.make(tmp_path)
    path = os.path.join(parts, "configs", "toy.json")
    with open(path) as fh:
        cfg = json.load(fh)
    # Krylov sectors above 10 states go to dense buckets, the rest to eigh
    cfg["ed"].update(ed_backend="dense", lanc_dim_threshold=10)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    cell = spec.load_cell("toy.cold-scan", root, parts)
    loop = Loop(cell.config, cell.traffic, 2 ** 31 + 9, "cpu")
    loop.run_warmup()
    restarts = bucket_counts["restarts"]
    run = spans.traced_run(loop, 0.5)
    n = len(run.window)
    rec = run.record
    builds = [s for s in rec.spans if s.name == "ed.op_build"]
    assert n >= 1 and builds
    assert spans.build_s(run) == pytest.approx(
        sum(s.end - s.start for s in builds) * 1e-9 / n)
    assert spans.eigh_s(run) > 0
    assert spans.bucket_restarts(run) * n == \
        bucket_counts["restarts"] - restarts > 0
    scanned = {(s.solve, s.attrs["qn"]) for s in rec.spans
               if s.name == "ed.sector"}
    assert len(scanned) == 25 * n             # nbath 3: every sector
    # one build a scanned sector (bucket or eigh), one a GF target
    assert spans.builds_per_sector(run) == pytest.approx(
        len(builds) / len(scanned))
    assert spans.h2d_mb(run) == 0.0           # nothing crosses to a card
    assert spans.idle_build_pct(run) is None and run.span_idle is None
    bare = spans.harness.Run(setup_s=0.0, window_s=run.window_s,
                             window=run.window)
    assert all(f(bare) is None for f in spans.READERS.values())
    out = spans.split(run)
    assert out["spans"] == pytest.approx(len(rec.spans) / n)
    assert "idle_spans" not in out
