"""The solver's cache of band-sparse sector operators (``ops/op_cache.py``):
a refill equals a fresh build of the new bath field by field, a changed
amplitude pattern builds afresh, a solver's second solve equals a new
solver's, the solve evicts what it did not touch, and a refill never hands
out a tensor of an earlier op. ``ed_backend="pallas"`` on the CPU."""
import gc
import weakref
from functools import partial

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.hamiltonian import build_sector_hamiltonian
from dmft_lanc_ed_tpu_torch.ops import bf16x3
from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
from dmft_lanc_ed_tpu_torch.ops.factory import make_sector_op
from dmft_lanc_ed_tpu_torch.ops.op_cache import (SectorOpCache, _OP_VALUES,
                                                 _POP_VALUES, sector_op)
from dmft_lanc_ed_tpu_torch.utils.observability import trace

POP_VALUES, OP_VALUES = _POP_VALUES, _OP_VALUES
STRUCTURE = ("perm_dw", "perm_up", "iperm_dw", "iperm_up")


def _hloc_hybrid():
    h = np.zeros((1, 1, 2, 2))
    h[0, 0] = [[0.0, 0.15], [0.15, 0.1]]
    return h


# name -> (config kwargs, hloc, sector)
CASES = {
    "normal": (dict(norb=1, nbath=5, uloc=(2.0,)), np.zeros((1, 1, 1, 1)),
               ((3,), (3,))),
    "hybrid": (dict(norb=2, nbath=4, uloc=(1.4, 1.4), ust=0.5, jh=0.1,
                    bath_type="hybrid"), _hloc_hybrid(), ((3,), (3,))),
}


def _case(name, seed=5):
    kw, hloc, qn = CASES[name]
    cfg = pt.EDConfig(ed_backend="pallas", **kw)
    packed = pt.EDSolver(cfg, hloc, device="cpu").init_bath()
    rng = np.random.default_rng(seed)
    baths = [packed + 0.1 * rng.normal(size=packed.shape) for _ in range(2)]
    return cfg, hloc, pt.SectorTable(cfg).sector(qn), baths


def _get(cache, cfg, sec, hloc, packed):
    bath = pt.unpack_bath(cfg, packed)
    return sector_op(cfg, sec, hloc, bath, "cpu",
                     partial(make_sector_op, cfg, sec, hloc, bath, "cpu"),
                     "diag", "pallas", cache=cache)[0]


def _fresh(cfg, sec, hloc, packed):
    h = build_sector_hamiltonian(cfg, sec, hloc, pt.unpack_bath(cfg, packed))
    return build_blocksparse_op(h, "cpu")


def _diag_err(pop):
    return float((pop.diag_a.double() @ pop.diag_b.double()
                  - pop.diag_p).abs().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_refill_equals_a_fresh_build_field_by_field(name):
    cfg, hloc, sec, (b1, b2) = _case(name)
    cache = SectorOpCache()
    with trace.recording() as rec:
        _get(cache, cfg, sec, hloc, b1)
        op = _get(cache, cfg, sec, hloc, b2)
    assert rec.counters == {"op_builds.diag": 1, "op_cache.miss": 1,
                            "op_cache.refill": 1}
    assert [s.attrs.get("cache") for s in rec.spans
            if s.name == "ed.op_build"] == ["miss", "refill"]
    ref = _fresh(cfg, sec, hloc, b2)
    for f in STRUCTURE:
        assert torch.equal(getattr(op, f), getattr(ref, f)), f
    p, q = op.pop, ref.pop
    assert (p.w_dw, p.d_dw, p.w_up, p.d_up, p.trim_runs, p.nnz) == \
        (q.w_dw, q.d_dw, q.w_up, q.d_up, q.trim_runs, q.nnz)
    assert op.nnz == ref.nnz
    for a, b in zip(p.runs_trim + p.runs_full, q.runs_trim + q.runs_full):
        assert torch.equal(a, b)
    # every value field bit for bit, the diagonal's f32 factors included
    for f in POP_VALUES:
        assert torch.equal(getattr(p, f), getattr(q, f)), f
    for f in OP_VALUES:
        assert torch.equal(getattr(op, f), getattr(ref, f)), f
    assert p.diag_rank == q.diag_rank and _diag_err(p) == _diag_err(q)


def test_a_zeroed_hybridisation_builds_afresh():
    cfg, hloc, sec, (b1, b2) = _case("normal")
    b2 = b2.copy()
    b2[cfg.nbath + 2] = 0.0        # one V of the normal bath's layout
    cache = SectorOpCache()
    _get(cache, cfg, sec, hloc, b1)
    with trace.recording() as rec:
        op = _get(cache, cfg, sec, hloc, b2)
    assert rec.counters == {"op_builds.diag": 1, "op_cache.miss": 1}
    ref = _fresh(cfg, sec, hloc, b2)
    assert op.pop.nnz == ref.pop.nnz < _fresh(cfg, sec, hloc, b1).pop.nnz
    for f in POP_VALUES:
        assert torch.equal(getattr(op.pop, f), getattr(ref.pop, f)), f
    for f in OP_VALUES + STRUCTURE:
        assert torch.equal(getattr(op, f), getattr(ref, f)), f


def _solver():
    # the four sectors of 100 states take the chain solve
    cfg = pt.EDConfig(norb=1, nbath=4, uloc=(2.0,), lmats=32, lreal=16,
                      lanc_dim_threshold=20, ed_batch_dim_max=60,
                      ed_gf_chain_min_dim=60, ed_backend="pallas")
    return pt.EDSolver(cfg, device="cpu")


def test_second_solve_refills_and_equals_a_new_solver():
    s = _solver()
    packed = s.init_bath()
    rng = np.random.default_rng(11)
    b2 = packed * (1.0 + 0.05 * rng.uniform(-1, 1, packed.shape))
    with trace.recording() as rec1:
        s.solve(packed)
    with trace.recording() as rec2:
        res = s.solve(b2)
    ref = _solver().solve(b2)

    chain = [x.attrs["qn"] for x in rec1.spans
             if x.name == "ed.sector" and x.attrs["route"] == "chain"]
    c1, c2 = rec1.counters, rec2.counters
    assert len(chain) > 0 and len(s.op_cache) == len(chain)
    assert c1["op_cache.miss"] == c1["op_builds.diag"] == len(chain)
    assert "op_cache.refill" not in c1
    assert c2["op_cache.refill"] == len(chain)
    assert "op_cache.miss" not in c2 and "op_builds.diag" not in c2
    for rec, c in ((rec1, c1), (rec2, c2)):
        # the GF's band-sparse targets are the scan's ops of this bath
        targets = {x.attrs["qn"] for x in rec.spans
                   if x.name == "ed.gf_chains"}
        big = {q for q in targets if s.table.dim(q) >= 60}
        assert big and big <= set(chain)
        assert c["op_cache.reuse"] == len(big)
        assert c.get("op_builds.gf", 0) == len(targets - big)
    assert {x.attrs.get("cache") for x in rec2.spans
            if x.name == "ed.op_build" and x.attrs["site"] == "diag"} == \
        {"refill"}

    e, e_ref = res.state_list.diag_log, ref.state_list.diag_log
    assert [q for q, _, _ in e] == [q for q, _, _ in e_ref]
    for (_, a, _), (_, b, _) in zip(e, e_ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.g_mats, ref.g_mats, rtol=0, atol=1e-10)

    # the memory goes with the solver: no reference cycle holds an op
    held = weakref.ref(s.op_cache._entries[next(iter(
        s.op_cache._entries))].op.pop)
    gc.disable()
    try:
        del s
        assert held() is None
    finally:
        gc.enable()


def test_a_solve_evicts_the_sectors_it_did_not_touch():
    cfg, hloc, sec, (b1, b2) = _case("normal")
    other = pt.SectorTable(cfg).sector(((2,), (3,)))
    cache = SectorOpCache()
    cache.begin_solve()
    _get(cache, cfg, sec, hloc, b1)
    _get(cache, cfg, other, hloc, b1)
    cache.end_solve()
    assert sec.qn in cache and other.qn in cache
    cache.begin_solve()
    _get(cache, cfg, sec, hloc, b2)
    cache.end_solve()
    assert sec.qn in cache and other.qn not in cache and len(cache) == 1


def test_between_solves_an_entry_holds_no_values():
    """A solve's end lets go of the value tensors (the skeleton stays on
    the device); the next solve refills them, on the same bath too, bit
    for bit."""
    cfg, hloc, sec, (b1, _) = _case("normal")
    cache = SectorOpCache()
    cache.begin_solve()
    first = _get(cache, cfg, sec, hloc, b1)
    with trace.recording() as rec:
        assert _get(cache, cfg, sec, hloc, b1) is first
    assert rec.counters == {"op_cache.reuse": 1}
    cache.end_solve()
    (e,) = cache._entries.values()
    assert e.bath is None
    assert all(getattr(e.op.pop, f) is None for f in POP_VALUES)
    assert all(getattr(e.op, f) is None for f in OP_VALUES)
    for f in POP_VALUES:            # the op handed out keeps its values
        assert getattr(first.pop, f) is not None, f
    cache.begin_solve()
    with trace.recording() as rec:
        op = _get(cache, cfg, sec, hloc, b1)
    assert rec.counters == {"op_cache.refill": 1}
    for f in POP_VALUES:
        assert torch.equal(getattr(op.pop, f), getattr(first.pop, f)), f
    for f in OP_VALUES:
        assert torch.equal(getattr(op, f), getattr(first, f)), f


def test_a_refill_hands_out_new_value_tensors():
    cfg, hloc, sec, (b1, b2) = _case("normal")
    cache = SectorOpCache()
    old = _get(cache, cfg, sec, hloc, b1)
    old_split = bf16x3.split_op(old)
    kept = {f: getattr(old.pop, f).clone() for f in POP_VALUES}
    new = _get(cache, cfg, sec, hloc, b2)
    assert new is not old and new.pop is not old.pop
    olds = {t.data_ptr() for t in [getattr(old.pop, f) for f in POP_VALUES]
            + [getattr(old, f) for f in OP_VALUES]}
    for t in [getattr(new.pop, f) for f in POP_VALUES] + \
            [getattr(new, f) for f in OP_VALUES]:
        assert t.data_ptr() not in olds
    for f in STRUCTURE:
        assert getattr(new, f) is getattr(old, f)
    assert new.pop.runs_trim is old.pop.runs_trim
    for f in POP_VALUES:          # the old op keeps its own values
        assert torch.equal(getattr(old.pop, f), kept[f])
    new_split = bf16x3.split_op(new)
    assert new_split is not old_split
    assert not torch.equal(new_split.dw_hi, old_split.dw_hi)
    assert bf16x3.split_op(old) is old_split
