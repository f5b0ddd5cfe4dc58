"""The three-orbital Kanamori model (density-density: Jx = Jp = 0) of the
benchmark's ``kanamori3`` configuration, on the port's band-sparse path
(``ed_backend="pallas"``) on the CPU, held to the benchmark's plain
reference (``edbench/reference/``, NumPy/SciPy, nothing of the port).

Tolerances, each with its origin:
- sector energies 1e-10 (the f64 polish gate, bench.py:51);
- G(iw) and Sigma(iw) 1e-6 (the f64 bar of tests/torch_driver_check.py:
  below ``ed_gf_chain_min_dim`` both sides run f64 chains).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.utils.observability import trace
from edbench.reference import iteration as ref

NORB = 3
KANAMORI = dict(norb=NORB, uloc=(2.5,) * NORB, ust=1.5, jh=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small sectors: one torch thread and one BLAS thread (the
    reference's Lanczos took 50 s against 0.6 s with the BLAS's own
    threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def serial_reference(monkeypatch):
    """The reference's sector solves and chains in this process, one at
    a time (its pool spawns worker processes)."""
    monkeypatch.setattr(ref, "_pool", lambda workers: ThreadPoolExecutor(1))


def _qn2(q):
    return (int(sum(q[0])), int(sum(q[1])))


def _solve_both(nbath, bath, hint, **kw):
    """(port's SolveResult, reference's Solved) of one bath: the sectors
    around `hint` (all of them when None)."""
    cfg = pt.EDConfig(nbath=nbath, beta=100.0, lmats=64,
                      ed_backend="pallas", ed_sectors=hint is not None,
                      **KANAMORI, **kw)
    s = pt.EDSolver(cfg, device="cpu")
    if hint is not None:
        s.diag_state.sector_hint = [pt.qn(*hint)]
    res = s.solve(bath)
    p = ref.Problem(
        model=dict(norb=NORB, nbath=nbath, uloc=cfg.uloc[:NORB],
                   ust=cfg.ust, jh=cfg.jh, xmu=0.0, hloc=(0.0,) * NORB),
        bath=np.asarray(bath, np.float64),
        sectors=ref.scan_sectors(NORB * (nbath + 1),
                                 None if hint is None else [hint]),
        beta=cfg.beta, lmats=cfg.lmats, lfit=cfg.lmats,
        gf_steps=cfg.lanc_ngfiter, gs_threshold=cfg.gs_threshold,
        wband=1.0, n_energies=100, wmixing=0.5, cg_ftol=1e-5, cg_niter=500)
    return res, ref.solve_iteration(p, 1, np.float64, 1)


def _random_bath(nbath, seed):
    """init_bath's layout with levels moved by up to 0.3 and
    hybridizations scaled by up to 1 +- 0.3."""
    cfg = pt.EDConfig(nbath=nbath, **KANAMORI)
    b = np.asarray(pt.EDSolver(cfg, device="cpu").init_bath(), np.float64)
    n = NORB * nbath
    rng = np.random.default_rng(seed)
    b = b.copy()
    b[:n] += 0.3 * rng.uniform(-1.0, 1.0, n)
    b[n:2 * n] *= 1.0 + 0.3 * rng.uniform(-1.0, 1.0, n)
    return b


@pytest.mark.parametrize("nbath,hint,seed,threshold", [
    (1, None, 3, 8),           # every sector, each through the chain solve
    (2, (4, 5), 3, 1024),      # the 9 sectors around half filling
    (2, (4, 4), 8, 1024),
])
def test_port_matches_plain_reference(serial_reference, nbath, hint, seed,
                                      threshold):
    res, want = _solve_both(nbath, _random_bath(nbath, seed), hint,
                            lanc_dim_threshold=threshold)
    got = {_qn2(q): float(np.min(e)) for q, e, _ in res.state_list.diag_log}
    assert set(got) == set(want.energies)
    for s, e in want.energies.items():
        assert abs(got[s] - e) <= 1e-10 * max(1.0, abs(e)), s
    ground = sorted({_qn2(st.qn) for st in res.state_list.states})
    assert ground == want.ground
    g = np.array([res.g_mats[0, 0, a, a] for a in range(NORB)])
    sigma = np.array([res.sigma_mats[0, 0, a, a] for a in range(NORB)])
    np.testing.assert_allclose(g, want.g, atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma, want.sigma, atol=1e-6, rtol=0)


def _scaled_sector(qn, scale, seed=0):
    """(cfg, sector op, dense levels, dense vectors) of sector `qn` of the
    nbath = 1 model whose hybridizations are scaled by `scale` (the flow
    of the Mott side), on init_bath with a 2 % jitter."""
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
    cfg = pt.EDConfig(nbath=1, ed_backend="pallas", lanc_dim_threshold=8,
                      **KANAMORI)
    b = np.asarray(pt.EDSolver(cfg, device="cpu").init_bath(), np.float64)
    b = b.copy()
    rng = np.random.default_rng(seed)
    b[:NORB] += 0.02 * cfg.hwband * rng.uniform(-1.0, 1.0, NORB)
    b[NORB:2 * NORB] *= scale * (1.0 + 0.02 * rng.uniform(-1.0, 1.0, NORB))
    sec = pt.SectorTable(cfg).sector(pt.qn(*qn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, NORB, NORB)),
                                    pt.unpack_bath(cfg, b))
    w, v = np.linalg.eigh(pt.dense_hamiltonian(h))
    return cfg, build_blocksparse_op(h, "cpu"), sec, w, v


def _handover(monkeypatch, op, w, v, weights, polished=False):
    """The mixed top-off replaced by what it handed over on the card: a
    unit mixture of the levels `weights` names, and the next level above
    them, each with its Rayleigh quotient; with `polished`, the polish
    too (what it handed the guard on the card)."""
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import to_padded
    mix = sum(c * v[:, i] for i, c in weights.items())
    mix = mix / np.linalg.norm(mix)
    hand = np.stack([mix, v[:, max(weights) + 1]])
    rq = np.sort([float(np.sum(w * (v.T @ x) ** 2)) for x in hand])
    real = pdiag.lanczos_ground_state

    def topoff(*a, **kw):
        if a[1] is not pdiag.matvec_bs_mixed_padded:   # seed, f64 top-off
            return real(*a, **kw)
        x = to_padded(op, torch.as_tensor(
            hand.reshape(2, op.dim_dw, op.dim_up))).double()
        return rq, x.reshape(2, -1).numpy()
    monkeypatch.setattr(pdiag, "lanczos_ground_state", topoff)
    if polished:
        monkeypatch.setattr(pdiag, "_polish",
                            lambda op, vals, vecs, *a: (vals, vecs))


def test_doublet_handed_over_as_a_mixture_is_split(monkeypatch):
    """The Ising-Hund doublet of the self-twin (3,3) sector, split 7.7e-7
    by hybridizations scaled to 0.05 (the card's (5,5) at 627,264 states
    was split 8.0e-7), handed over as the card's top-off handed its pair
    over: the mixture 0.56 |0> + 0.83 |1> beside the third level, which
    the polish left 1.1e-9 above the lower member with a residual of
    2.7e-5 (PERF.md). At 400 states the real top-off splits the pair by
    itself, so the handover is replayed. The spin-flip parts of the
    mixture are the two members: the solve returns both."""
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    cfg, op, sec, w, v = _scaled_sector((3, 3), 0.05)
    assert 1e-7 < w[1] - w[0] < 3e-6 < w[2] - w[1]
    _handover(monkeypatch, op, w, v, {0: 0.56, 1: 0.83})
    with trace.recording() as rec:
        vals, vecs = pdiag._blocksparse_ground_state(cfg, op, sec.dim, 2, 20)
    np.testing.assert_allclose(vals, w[:2], atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.abs(vecs @ v[:, :2]), np.eye(2),
                               atol=1e-6)
    assert rec.counters["parity_splits"] == 1


def test_level_missed_by_the_handover_is_found_in_f64(monkeypatch):
    """A sector that is not its own twin, (2,3), handed over a mixture
    mostly of its second level, as the card's (4,7) was (2.4e-5 above its
    lowest level, residual 3.8e-4 after the polish): the lowest pair's
    residual misses the polish's target, and the f64 top-off from the
    handover finds the lowest level."""
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    cfg, op, sec, w, v = _scaled_sector((2, 3), 0.05)
    _handover(monkeypatch, op, w, v, {0: 0.2, 1: 0.98}, polished=True)
    with trace.recording() as rec:
        vals, _ = pdiag._blocksparse_ground_state(cfg, op, sec.dim, 2, 20)
    np.testing.assert_allclose(vals, w[:2], atol=1e-10, rtol=0)
    assert rec.counters["f64_topoffs"] == 1


@pytest.mark.parametrize("seed", [0, 2])
def test_mixed_topoff_that_raises_gives_way_to_f64(seed):
    """With a Krylov basis of 5 for 2 states the mixed top-off of the
    (3,3) sector (hybridizations at 0.08, its doublet split 1.3e-5) runs
    out of restarts; the f64 top-off converges from the seed."""
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    cfg, op, sec, w, _ = _scaled_sector((3, 3), 0.08, seed)
    vals, _ = pdiag._blocksparse_ground_state(cfg, op, sec.dim, 2, 5)
    np.testing.assert_allclose(vals, w[:2], atol=1e-10, rtol=0)


@pytest.mark.parametrize("jitter", [0.0, 0.002])
def test_setup_at_small_jitter_does_not_raise(jitter):
    """The set-up's solve (the sectors around half filling) on init_bath
    unjittered, as a DMFT run starts, and at a 0.2 % jitter: orbitals
    alike or nearly so, degenerate levels in every sector."""
    nbath = 2
    cfg = pt.EDConfig(nbath=nbath, beta=100.0, lmats=64, ed_backend="pallas",
                      ed_sectors=True, **KANAMORI)
    s = pt.EDSolver(cfg, device="cpu")
    b = np.asarray(s.init_bath(), np.float64).copy()
    n = NORB * nbath
    rng = np.random.default_rng(4)
    b[:n] += jitter * cfg.hwband * rng.uniform(-1.0, 1.0, n)
    b[n:2 * n] *= 1.0 + jitter * rng.uniform(-1.0, 1.0, n)
    s.diag_state.sector_hint = [pt.qn(4, 5)]
    res = s.solve(b)
    assert len(res.state_list.diag_log) == 9
    assert np.isfinite(res.sigma_mats).all()
