"""PyTorch port, ``utils/observability.py`` against the JAX package's:
the kernel counters' arithmetic, the phase timer, the sparsity bitmap
(byte-identical files from the same factor) and the profiler trace (a
``torch.profiler`` trace where the JAX package takes ``jax.profiler``'s).
"""
import os

import numpy as np
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.utils import observability as jobs
from dmft_lanc_ed_tpu_torch.utils import observability as pobs


def test_kernel_stats_and_timer_match_reference():
    calls = [(3, 100, 0.5), (7, 40, 0.0), (1, 5, 1.25)]
    j, p = jobs.KernelStats(), pobs.KernelStats()
    assert p.summary() == j.summary()
    for c in calls:
        j.record(*c)
        p.record(*c)
    assert p.summary() == j.summary()
    assert p.summary()["matvecs"] == 11 and "nnz_per_s" in p.summary()
    j.reset()
    p.reset()
    assert p.summary() == j.summary() == dict(matvecs=0, nnz_applied=0)
    t = pobs.Timer()
    for _ in range(2):
        with t.phase("diag"):
            pass
    with t.phase("gf"):
        pass
    assert set(t.times) == {"diag", "gf"} and t.times["diag"] >= 0.0


def test_spy_matrix_byte_identical(tmp_path):
    """The up factor of a sector of each package's Hamiltonian: the same
    bitmap file."""
    kw = dict(norb=1, nbath=3, uloc=(2.0,))
    cfg_j, cfg_p = ed.EDConfig(**kw), pt.EDConfig(**kw)
    h_j = ed.build_sector_hamiltonian(
        cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(2, 2)),
        np.zeros((1, 1, 1, 1)), ed.init_bath(cfg_j))
    h_p = pt.build_sector_hamiltonian(
        cfg_p, pt.SectorTable(cfg_p).sector(pt.qn(2, 2)),
        np.zeros((1, 1, 1, 1)), pt.init_bath(cfg_p))
    pj, pp = str(tmp_path / "j.pbm"), str(tmp_path / "p.pbm")
    n = h_j.up_cols.shape[0]
    jobs.spy_matrix(np.asarray(h_j.up_cols), np.asarray(h_j.up_vals), n, pj)
    pobs.spy_matrix(h_p.up_cols, h_p.up_vals, n, pp)
    text = open(pp).read()
    assert text == open(pj).read()
    assert text.startswith(f"P1\n{n} {n}\n") and "1" in text.split("\n", 2)[2]


def test_profile_trace_writes_a_trace(tmp_path):
    with pobs.profile_trace(None):
        pass
    d = str(tmp_path / "trace")
    with pobs.profile_trace(d):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files)
