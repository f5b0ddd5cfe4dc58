"""The solve's spans and counters (``utils.observability.trace``): off
they record nothing; on they nest, carry the solve number, and sit at the
solve's layer boundaries, one ``ed.sector`` a scanned sector, one
``op_builds`` count a host operator build and one ``op_cache`` count a
miss, refill or reuse of the solver's band-sparse operators."""
import time
from collections import Counter

import numpy as np
import pytest

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch import diag, gf
from dmft_lanc_ed_tpu_torch.ops import op_cache
from dmft_lanc_ed_tpu_torch.ops.lanczos import polish_counts
from dmft_lanc_ed_tpu_torch.utils.observability import NO_SPAN, trace


def _solver(**kw):
    cfg = pt.EDConfig(norb=1, nbath=4, uloc=(2.0,), lmats=32, lreal=16,
                      lanc_dim_threshold=20, ed_batch_dim_max=40, **kw)
    return pt.EDSolver(cfg, device="cpu")


def test_off_records_nothing_and_hands_out_the_shared_no_op():
    assert not trace.on
    assert trace.span("ed.x") is NO_SPAN
    assert trace.span("ed.x", qn=((1,), (2,)), dim=3) is NO_SPAN
    with trace.span("ed.x") as sp:
        sp["route"] = "eigh"
        trace.count("h2d_bytes", 8)
        trace.add("ed.y", 0, 1)
    s = _solver(ed_backend="dense")
    s.solve(s.init_bath())
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert not trace.on


def test_nesting_gives_parents_and_the_solve_number():
    with trace.recording() as rec:
        with trace.span("a", k=1):
            with trace.span("b") as b:
                b["late"] = 2
                trace.add("c", 5, 7, n=3)
            trace.count("n")
            trace.count("n", 2)
        with trace.span("d"):
            with trace.span("e"):
                pass
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, -1, 3]
    solves = [s.solve for s in rec.spans]
    assert solves[:3] == [solves[0]] * 3 and solves[3:] == [solves[0] + 1] * 2
    assert rec.spans[0].attrs == {"k": 1}
    assert rec.spans[1].attrs == {"late": 2}
    assert (rec.spans[2].start, rec.spans[2].end) == (5, 7)
    assert rec.counters == {"n": 3}
    assert not trace.on


def test_span_times_lie_between_the_clock_reads_around_them():
    with trace.recording() as rec:
        t0 = time.perf_counter_ns()
        with trace.span("outer"):
            t1 = time.perf_counter_ns()
            with trace.span("inner"):
                time.sleep(0.001)
            t2 = time.perf_counter_ns()
        t3 = time.perf_counter_ns()
    outer, inner = rec.spans
    assert t0 <= outer.start <= t1 <= inner.start < inner.end <= t2 \
        <= outer.end <= t3
    assert inner.end - inner.start >= 1_000_000


@pytest.mark.parametrize("backend,routes", [
    ("dense", {"eigh", "batched", "serial"}),
    ("pallas", {"eigh", "batched", "chain"}),
])
def test_solve_spans_cover_the_routes_and_count_the_builds(
        monkeypatch, backend, routes):
    """nbath 4 with Krylov above 20 states, buckets up to 40: the 36
    sectors go to host eigh, the dense buckets and, above 40 states, the
    serial Lanczos (dense) or the two-stage band-sparse solve (pallas,
    its plain versions on the CPU)."""
    made = Counter()

    def counting(site, fn):
        def call(*a, **k):
            made[site] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(diag, "make_sector_op",
                        counting("diag", diag.make_sector_op))
    # the solver's op cache builds the scan's band-sparse ops itself (the
    # GF's band-sparse targets here are the scan's, reused)
    monkeypatch.setattr(op_cache, "build_blocksparse_op",
                        counting("diag", op_cache.build_blocksparse_op))
    monkeypatch.setattr(diag, "build_dense_op",
                        counting("bucket", diag.build_dense_op))
    monkeypatch.setattr(diag, "build_sector_hamiltonian",
                        counting("eigh", diag.build_sector_hamiltonian))
    monkeypatch.setattr(gf.HCache, "_build",
                        counting("gf", gf.HCache._build))
    s = _solver(ed_backend=backend, ed_gf_chain_min_dim=60)
    polish0 = polish_counts["s"]
    with trace.recording() as rec:
        res = s.solve(s.init_bath())
    sp = rec.spans
    by = Counter(x.name for x in sp)

    # one ed.solve root; its children are the timings' blocks
    assert by["ed.solve"] == 1 and sp[0].name == "ed.solve"
    assert len({x.solve for x in sp}) == 1
    assert {x.name for x in sp if x.parent == 0} == {
        "ed.diag", "ed.gf", "ed.observables", "ed.sigma"}
    d = next(x for x in sp if x.name == "ed.diag")
    assert abs((d.end - d.start) * 1e-9 - res.timings["diag"]) < 5e-4
    g = next(x for x in sp if x.name == "ed.gf")
    assert abs((g.end - g.start) * 1e-9 - res.timings["gf"]) < 5e-4

    # one ed.sector a scanned sector, with its route
    sectors = [x for x in sp if x.name == "ed.sector"]
    scanned = [q for q, _, _ in res.state_list.diag_log]
    assert [x.attrs["qn"] for x in sectors] == scanned and len(scanned) == 36
    assert {x.attrs["route"] for x in sectors} == routes
    for x in sectors:
        assert (x.attrs["route"] == "eigh") == (x.attrs["dim"] <= 20)
    assert by["ed.eigh"] == sum(x.attrs["route"] == "eigh" for x in sectors)
    bucket = [x for x in sp if x.name == "ed.bucket"]
    assert sum(x.attrs["sectors"] for x in bucket) == sum(
        x.attrs["route"] == "batched" for x in sectors)

    # op_builds by site: the builds made; under the band-sparse backend
    # the solver's op cache builds each chain sector's op (a miss) and
    # hands the GF the scan's op of a band-sparse target (a reuse, no span)
    expected_cache = {}
    if backend == "pallas":
        big = {x.attrs["qn"] for x in sp if x.name == "ed.gf_chains"
               and x.attrs["route"] == "B4"}
        expected_cache = {"op_cache.miss": made["diag"],
                          "op_cache.reuse": len(big)}
        # the mixed top-off's restarts: a counter, each ed.topoff's
        # attribute, and the solve's timings; the guard's counters where
        # it fired
        expected_cache["topoff.restarts"] = res.timings["topoff_restarts"]
        assert res.timings["topoff_restarts"] == sum(
            x.attrs["restarts"] for x in sp if x.name == "ed.topoff") > 0
        for k in ("parity_splits", "f64_topoffs"):
            if res.timings[k]:
                expected_cache[k] = res.timings[k]
        assert [x.attrs["cache"] for x in sp if x.name == "ed.op_build"
                and x.attrs["site"] == "diag"] == ["miss"] * made["diag"]
    assert rec.counters == {
        **{f"op_builds.{k}": v for k, v in made.items()}, **expected_cache}
    assert sum(made.values()) == by["ed.op_build"]
    assert all(sp[x.parent].name == "ed.gf_chains"
               for x in sp if x.name == "ed.op_build"
               and x.attrs["site"] == "gf")
    chains = [x for x in sp if x.name == "ed.gf_chains"]
    assert {x.attrs["qn"] for x in chains} <= set(scanned)
    assert sum(x.attrs["chains"] for x in chains) == sum(
        x.attrs["chains"] for x in sp if x.name == "ed.gf_poles")
    if backend == "pallas":
        # the two-stage solve's stages, one each a chain sector, and the
        # polish on polish_counts' own clock reads
        n = sum(x.attrs["route"] == "chain" for x in sectors)
        assert by["ed.seed"] == by["ed.topoff"] == by["ed.unpad"] == n > 0
        assert {x.attrs["route"] for x in chains} == {"B4", "scan"}
        polish = sum(x.end - x.start for x in sp if x.name == "ed.polish")
        assert polish * 1e-9 == pytest.approx(polish_counts["s"] - polish0,
                                              rel=1e-9)
    assert np.isfinite(res.observables.dens).all()
