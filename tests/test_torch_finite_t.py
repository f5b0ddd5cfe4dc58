"""PyTorch port, finite-temperature Lanczos on the band-sparse route against
the JAX package on the CPU: ``ed_finite_temp`` with ``ed_backend="pallas"``,
``ed_batch_sectors=False`` and ``ed_gf_chain_min_dim=0``, and
``lanc_dim_threshold`` low enough that the sectors above it take the
two-stage chain solve (B2/B3 seed, mixed top-off, f64 polish; the plain
versions here) with two or more states each, and every GF and chi chain B4
(its six-pass plain version). The JAX package solves the same inputs
through its plain reference: host eigh of every sector and its dense f64
chains. Two solves on one solver object each, the second on a bath 5 %
off the first, so ``_post_diag``'s ``neigen_sector`` and
``lanc_nstates_total`` carry into loop 2 as in a DMFT loop.

The models, one orbital at U = 2, each keeping whole multiplets at the
list's top so both packages keep the same states:
- beta10: nbath = 4, twelve states (they end on a whole six-fold
  multiplet); the Boltzmann tail at the list's top (2.3e-3) is above the
  cutoff, so loop 1 grows the list to fourteen and loop 2 to sixteen;
- beta100: nbath = 3, eight states; the tail is far below the cutoff, so
  loop 1 cuts the list to the one state within -ln(cutoff) / beta of the
  ground state, and loop 2, full at one, grows it to three.

Tolerances, each with its origin:
- the state list's energies per sector 1e-10 (the f64 polish; ROADMAP's
  energy gate); dens and docc 1e-8; the Boltzmann weights and Z 1e-12
  (measured 2.6e-13 at beta = 10; a weight moves by beta x the energies'
  f64 roundoff), the weights summing to Z within 1e-12;
- G(iw) and Sigma(iw): atol 5e-5, rtol 3e-5, the B4 bar of
  ``tests/torch_driver_check.py`` (an f32 chain against an f64 one);
- chi_spin on the bosonic grid and in imaginary time: the same bar; on the
  real axis 2e-3 of max|chi|: measured 5.5e-6 to 9.6e-6, and 1.05e-3 in
  beta10's loop 2, where the chains of the sixteen states leave interior
  poles near |w| = 4.2 unconverged (two f64 chains, the port's dense scan
  and the JAX package's Krylov route, differ there by 3.7e-4 too);
- neigen_sector and lanc_nstates_total: equal;
- two and three values of a band-sparse sector whose second and third
  levels lie 4.5e-7 apart, against dense eigh: 1e-10;
- the files: the same set; the state list read back alike by both.
"""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import io as jio
from dmft_lanc_ed_tpu_torch import diag as pdiag
from dmft_lanc_ed_tpu_torch import io as pio
from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
from dmft_lanc_ed_tpu_torch.solver import bosonic_grid, real_grid, tau_grid


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread keep parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


BASE = dict(norb=1, uloc=(2.0,), lmats=64, lreal=200, ed_finite_temp=True,
            chispin_flag=True)
PORT = dict(ed_backend="pallas", ed_batch_sectors=False,
            ed_gf_chain_min_dim=0)
REF = dict(ed_backend="dense", lanc_dim_threshold=1024)
CASES = {"beta10": dict(nbath=4, beta=10.0, lanc_nstates_total=12,
                        lanc_dim_threshold=40),
         "beta100": dict(nbath=3, beta=100.0, lanc_nstates_total=8,
                         lanc_dim_threshold=8)}
B4_BAR = dict(atol=5e-5, rtol=3e-5)
CHI_REAL_BAR = 2e-3
_RUNS = {}


def _ctl(solver):
    """(neigen_sector, lanc_nstates_total) of a solver's DiagState."""
    st = solver.diag_state
    return dict(st.neigen_sector), st.lanc_nstates_total


def _loops(name):
    """Two solves of each package on one solver object, the second on a
    bath 5 % off the first: {"port"/"jax": [(result, ctl after)] x 2,
    "baths": [b1, b2], "solvers": (port, jax), "seeds": chain seeds}."""
    if name in _RUNS:
        return _RUNS[name]
    sp = pt.EDSolver(pt.EDConfig(**BASE, **CASES[name], **PORT),
                     device="cpu")
    sj = ed.EDSolver(ed.EDConfig(**BASE, **dict(CASES[name], **REF)))
    b1 = sj.init_bath()
    assert b1.tobytes() == sp.init_bath().tobytes()
    b2 = b1 * (1.0 + 0.05 * np.random.default_rng(17).standard_normal(
        b1.shape))
    out = {"port": [], "jax": [], "baths": [b1, b2], "solvers": (sp, sj)}
    bc.reset_launch_counts()
    for b in (b1, b2):
        out["port"].append((sp.solve(b), _ctl(sp)))
        out["jax"].append((sj.solve(b), _ctl(sj)))
    out["seeds"] = dict(bc.seed_counts)
    _RUNS[name] = out
    return out


def _per_sector(state_list):
    by = {}
    for s in state_list.states:
        by.setdefault(s.qn, []).append(s.e)
    return {q: np.sort(e) for q, e in by.items()}


LOOPS = [(n, i) for n in CASES for i in (0, 1)]


@pytest.mark.parametrize("name,loop", LOOPS)
def test_state_list_and_weights_match_reference(name, loop):
    runs = _loops(name)
    rp, rj = runs["port"][loop][0], runs["jax"][loop][0]
    ep, ej = _per_sector(rp.state_list), _per_sector(rj.state_list)
    assert set(ep) == set(ej)
    for q in ep:
        np.testing.assert_allclose(ep[q], ej[q], atol=1e-10, rtol=0)
    beta = runs["solvers"][0].cfg.beta
    wp, zp = rp.state_list.boltzmann_weights(beta, True)
    wj, zj = rj.state_list.boltzmann_weights(beta, True)
    np.testing.assert_allclose(np.sort(wp), np.sort(wj), atol=1e-12, rtol=0)
    assert abs(zp - zj) <= 1e-12
    assert abs(wp.sum() / zp - 1.0) <= 1e-12
    # every band-sparse sector went through the two-stage solve, and every
    # chain seed reached its eta_target
    assert any(k for _, _, k in rp.state_list.diag_log)
    assert runs["seeds"]["reached"] > 0 and runs["seeds"]["missed"] == 0


@pytest.mark.parametrize("name,loop", LOOPS)
def test_observables_and_gf_match_reference(name, loop):
    runs = _loops(name)
    rp, rj = runs["port"][loop][0], runs["jax"][loop][0]
    assert rp.gf.routing[0] > 0 and rp.gf.routing[1] == 0
    for f in ("dens", "docc"):
        np.testing.assert_allclose(getattr(rp.observables, f),
                                   getattr(rj.observables, f), atol=1e-8,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, **B4_BAR)
    np.testing.assert_allclose(rp.sigma_mats, rj.sigma_mats, **B4_BAR)


@pytest.mark.parametrize("name,loop", LOOPS)
def test_chi_matches_reference(name, loop):
    runs = _loops(name)
    rp, rj = runs["port"][loop][0], runs["jax"][loop][0]
    cfg = runs["solvers"][0].cfg
    vm, tau, wr = bosonic_grid(cfg), tau_grid(cfg), real_grid(cfg)
    a, b = rp.chi_spin[(0, 0)], rj.chi_spin[(0, 0)]
    np.testing.assert_allclose(a.matsubara(cfg.beta, vm),
                               b.matsubara(cfg.beta, vm), **B4_BAR)
    np.testing.assert_allclose(a.imtime(tau), b.imtime(tau), **B4_BAR)
    wa = a.realaxis(cfg.beta, wr, cfg.eps)
    wb = b.realaxis(cfg.beta, wr, cfg.eps)
    assert np.abs(wa - wb).max() <= CHI_REAL_BAR * np.abs(wb).max()


@pytest.mark.parametrize("name,loop", LOOPS)
def test_post_diag_carries_the_same_control_state(name, loop):
    """neigen_sector and lanc_nstates_total after each loop, and the rule
    they follow from the loop's state list (ed_post_diag)."""
    runs = _loops(name)
    (rp, ctl_p), (_, ctl_j) = runs["port"][loop], runs["jax"][loop]
    assert ctl_p == ctl_j
    counts = {}
    for s in rp.state_list.states:
        counts[s.qn] = counts.get(s.qn, 0) + 1
    assert all(ctl_p[0][q] == c + 1 for q, c in counts.items())
    want = {"beta10": [14, 16], "beta100": [1, 3]}[name][loop]
    assert ctl_p[1] == want


def _near_pair_sector():
    """The (2,2) sector of nbath = 5 on a bath whose first two levels lie
    1e-3 apart: its second and third levels are 4.5e-7 apart."""
    cfg = pt.EDConfig(norb=1, nbath=5, uloc=(2.0,), ed_backend="pallas",
                      lanc_dim_threshold=8)
    bath = pt.unpack_bath(cfg, np.array(
        [-1.0, -0.999, 0.0, 0.4, 1.6, 0.5, 0.5, 0.45, 0.6, 0.4]))
    sec = pt.SectorTable(cfg).sector(pt.qn(2, 2))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)), bath)
    return cfg, sec, h


@pytest.mark.parametrize("neigen", [2, 3])
def test_band_sparse_sector_near_degenerate_pair(neigen):
    """The two-stage solve's k lowest values are the k lowest levels:
    with k = 3 the pair is wanted whole, with k = 2 it is cut (the mixed
    top-off hands over a mixture of the two; the JAX package returns the
    upper level there)."""
    cfg, sec, h = _near_pair_sector()
    w = np.linalg.eigvalsh(pt.dense_hamiltonian(h))
    assert 1e-7 < w[2] - w[1] < 1e-6
    op = build_blocksparse_op(h, "cpu")
    ncv = max(min(sec.dim, cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add),
              2 * neigen + 16)
    bc.reset_launch_counts()
    vals, vecs = pdiag._blocksparse_ground_state(cfg, op, sec.dim, neigen,
                                                 min(ncv, sec.dim))
    assert bc.seed_counts["reached"] == 1
    np.testing.assert_allclose(vals, w[:neigen], atol=1e-10, rtol=0)
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(neigen), atol=1e-10)


def test_finite_t_files_and_restore(tmp_path):
    """write_all of both packages' loop 1: the same file set, the same
    state list read back by either package; the port's restore re-seeds
    its solver with it, and loop 1 again gives the same energies."""
    runs = _loops("beta10")
    (rp, _), (rj, _) = runs["port"][0], runs["jax"][0]
    sp, sj = runs["solvers"]
    b1 = runs["baths"][0]
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    pio.write_all(sp.cfg, rp, b1, outdir=dp)
    jio.write_all(sj.cfg, rj, b1, outdir=dj)
    names = sorted(os.listdir(dp))
    assert names == sorted(os.listdir(dj))
    assert "histogram_states.ed" in names
    for src in (dp, dj):
        c_p = pio.read_state_list_restart(sp.cfg, outdir=src)
        c_j = jio.read_state_list_restart(sj.cfg, outdir=src)
        assert c_p.neigen_sector == c_j.neigen_sector
        assert c_p.lanc_nstates_total == c_j.lanc_nstates_total == 12
    np.testing.assert_allclose(
        pio.read_gf_files(sp.cfg, outdir=dp), rp.sigma_mats, atol=1e-8)
    # the restart's sector restriction (ed_sectors) scans the list's
    # sectors alone
    fresh = pt.EDSolver(sp.cfg.replace(ed_sectors=True, ed_sectors_shift=0,
                                       chispin_flag=False), device="cpu")
    back = fresh.restore(dp)
    np.testing.assert_allclose(back, b1, atol=1e-11)
    assert fresh.diag_state.lanc_nstates_total == rp.state_list.size
    assert set(fresh.diag_state.sector_hint) == set(_per_sector(
        rp.state_list))
    again = fresh.solve(back)
    ea, e1 = _per_sector(again.state_list), _per_sector(rp.state_list)
    assert set(ea) == set(e1)
    assert {q for q, _, _ in again.state_list.diag_log} == set(e1)
    for q in ea:
        np.testing.assert_allclose(ea[q], e1[q], atol=1e-10, rtol=0)
