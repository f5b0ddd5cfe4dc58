"""PyTorch port, the fit's diagnostic files and two solver options the port
carries: ``ed_twin`` (twin sectors reconstructed by spin flip) and
``ed_total_ud=False`` (orbital-resolved quantum numbers), each against the
JAX package (tests/test_features.py's cases).

Tolerances, each with its origin:
- the fit files: ``_write_fit_functions`` and the chi2fit_results record
  from the same arrays byte-identical; a whole fit in each package from
  the same target: the frequency and target columns byte-identical, the
  fitted columns within 1e-12 (the two fitted baths differ by ~2e-15, the
  torch gradient against jax.grad, which the files' 15 decimals show);
- the solves: Egs 1e-10, dens 1e-10, docc 1e-8 and G(iw) 1e-8 between the
  packages (both on f64 operators), and the reference test's own bars
  between the twin and the full scan, and between the two quantum-number
  layouts.
"""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import fit as jfit
from dmft_lanc_ed_tpu.bath_functions import delta_bath as jdelta
from dmft_lanc_ed_tpu_torch import fit as pfit
from dmft_lanc_ed_tpu_torch.bath_functions import delta_bath as pdelta


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


FIT_KW = dict(norb=1, nbath=3, uloc=(0.0,), beta=20.0, lmats=128, lfit=64,
              cg_scheme="delta")


def _fit_target(seed):
    """The reference test's target: Delta of a perturbed initial bath."""
    cfg = ed.EDConfig(**FIT_KW)
    rng = np.random.default_rng(seed)
    start = np.asarray(ed.pack_bath(cfg, ed.init_bath(cfg)))
    target_arr = start + 0.05 * rng.normal(size=start.shape)
    wm = ed.matsubara_grid(cfg)[:cfg.lfit]
    tgt = np.asarray(jdelta(cfg, ed.unpack_bath(cfg, target_arr), 1j * wm))
    return start, tgt, wm


def test_fit_diagnostics_files_and_stop_dials(tmp_path):
    """chi2fit_results*/fit_delta* files in the reference format, against
    the JAX package's from the same target, and the cg_stop/cg_ftol C1/C2
    stopping conditions (fitgf_normal_normal.f90:147-205,
    ED_INPUT_VARS.f90:196)."""
    cfg = pt.EDConfig(**FIT_KW)
    start, tgt, wm = _fit_target(3)
    hloc = np.zeros((1, 1, 1, 1))
    out, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(out)
    os.makedirs(out_j)
    pfit.chi2_fitgf(cfg, tgt, start.copy(), hloc, outdir=out)
    jfit.chi2_fitgf(ed.EDConfig(**FIT_KW), tgt, start.copy(), hloc,
                    outdir=out_j)
    res_file = os.path.join(out, "chi2fit_results_orb1_s1.ed")
    fit_file = os.path.join(out, "fit_delta_orb1_s1.ed")
    assert sorted(os.listdir(out)) == sorted(os.listdir(out_j))
    assert open(res_file).read() == open(
        os.path.join(out_j, "chi2fit_results_orb1_s1.ed")).read()
    chi, nit = open(res_file).read().split()
    assert float(chi) < 1e-4 and int(nit) > 3
    cols = np.loadtxt(fit_file)          # [Lfit, 5]: x, Im g, Im gand, ...
    assert cols.shape == (cfg.lfit, 5)
    np.testing.assert_allclose(cols[:, 0], wm, atol=1e-12)
    np.testing.assert_allclose(cols[:, 1], tgt[0, 0, 0, 0].imag, atol=1e-10)
    np.testing.assert_allclose(cols[:, 2], cols[:, 1], atol=5e-3)
    rows = [ln.split() for ln in open(fit_file)]
    rows_j = [ln.split() for ln in open(os.path.join(
        out_j, "fit_delta_orb1_s1.ed"))]
    assert [[r[0], r[1], r[3]] for r in rows] == \
        [[r[0], r[1], r[3]] for r in rows_j]
    np.testing.assert_allclose(cols[:, [2, 4]],
                               np.array(rows_j, float)[:, [2, 4]], atol=1e-12)

    # appending behavior
    pfit.chi2_fitgf(cfg, tgt, start.copy(), hloc, outdir=out)
    assert len(open(res_file).read().splitlines()) == 2

    # loose ftol + cg_stop=1 (C1 only) stops much earlier
    pfit.chi2_fitgf(cfg.replace(cg_ftol=1e-1, cg_stop=1), tgt, start.copy(),
                    hloc, outdir=out)
    nit_loose = int(open(res_file).read().splitlines()[-1].split()[1])
    assert nit_loose < int(nit)

    # cg_minimize_hh sets the numeric-gradient step: an absurdly large step
    # must degrade the fit vs the default
    b_good = pfit.chi2_fitgf(cfg.replace(cg_grad=1), tgt, start.copy(), hloc)
    b_bad = pfit.chi2_fitgf(cfg.replace(cg_grad=1, cg_minimize_hh=0.5), tgt,
                            start.copy(), hloc)
    d_good = pdelta(cfg, pt.unpack_bath(cfg, b_good), 1j * wm).numpy()
    d_bad = pdelta(cfg, pt.unpack_bath(cfg, b_bad), 1j * wm).numpy()
    assert np.abs(d_good - tgt).max() < np.abs(d_bad - tgt).max()


@pytest.mark.parametrize("bath_type,nspin,spins", [
    ("normal", 2, [0, 1]), ("normal", 2, [1]), ("hybrid", 1, [0]),
    ("replica", 2, [0, 1])])
def test_fit_function_files_byte_identical(bath_type, nspin, spins,
                                           tmp_path):
    """The per-channel fit_{weiss,delta} writers from the same seeded
    arrays: the same file names (the normal, hybrid and replica suffix
    rules) and bytes, for both schemes."""
    rng = np.random.default_rng(11)
    norb, lfit = 2, 16
    shape = (nspin, nspin, norb, norb, lfit)
    fg = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    fgand = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    wm = np.pi / 20.0 * (2 * np.arange(lfit) + 1)
    for scheme in ("weiss", "delta"):
        kw = dict(norb=norb, nspin=nspin, nbath=2, bath_type=bath_type,
                  cg_scheme=scheme)
        dj, dp = tmp_path / f"j{scheme}", tmp_path / f"p{scheme}"
        dj.mkdir()
        dp.mkdir()
        jfit._write_fit_functions(ed.EDConfig(**kw), str(dj), "_s", wm, fg,
                                  fgand, spins)
        pfit._write_fit_functions(pt.EDConfig(**kw), str(dp), "_s", wm, fg,
                                  fgand, spins)
        jfit._write_chi2_results(str(dj), "_s", 1.234e-5, 17)
        pfit._write_chi2_results(str(dp), "_s", 1.234e-5, 17)
        names = sorted(os.listdir(dj))
        assert names == sorted(os.listdir(dp)) and len(names) > 1
        for n in names:
            assert (dj / n).read_bytes() == (dp / n).read_bytes(), n


def _solves(kw, hloc=None, **over):
    """The port's solve (dense backend) and the JAX package's of the
    initial bath."""
    cfg_j = ed.EDConfig(**kw, **over)
    cfg_p = pt.EDConfig(ed_backend="dense", **kw, **over)
    hloc = np.zeros((cfg_j.nspin, cfg_j.nspin, cfg_j.norb, cfg_j.norb)) \
        if hloc is None else hloc
    s_j = ed.EDSolver(cfg_j, hloc)
    bath = np.asarray(s_j.init_bath())
    return (pt.EDSolver(cfg_p, hloc, device="cpu").solve(bath),
            s_j.solve(bath))


def _assert_match(rp, rj, norb):
    assert abs(rp.observables.egs - rj.observables.egs) <= 1e-10
    assert rp.state_list.size == rj.state_list.size
    np.testing.assert_allclose(rp.observables.dens, rj.observables.dens,
                               atol=1e-10)
    np.testing.assert_allclose(rp.observables.docc, rj.observables.docc,
                               atol=1e-8)
    for a in range(norb):
        np.testing.assert_allclose(rp.g_mats[0, 0, a, a],
                                   rj.g_mats[0, 0, a, a], atol=1e-8)


def test_twin_sectors_match_full_scan():
    """ED_TWIN=T reproduces the full scan (spin-symmetric case), in the port
    and against the JAX package's twin solve."""
    kw = dict(norb=1, nbath=3, uloc=(1.7,), beta=50.0, lmats=64, lreal=30)
    full_p, _ = _solves(kw)
    twin_p, twin_j = _solves(kw, ed_twin=True)
    _assert_match(twin_p, twin_j, 1)
    assert abs(full_p.observables.egs - twin_p.observables.egs) < 1e-10
    assert full_p.state_list.size == twin_p.state_list.size
    np.testing.assert_allclose(twin_p.g_mats[0, 0, 0, 0],
                               full_p.g_mats[0, 0, 0, 0], atol=1e-8)
    np.testing.assert_allclose(twin_p.observables.dens,
                               full_p.observables.dens, atol=1e-10)
    assert any(st.twin for st in twin_p.state_list.states) == \
        any(st.twin for st in twin_j.state_list.states)
    # fewer sectors scanned: only nup >= ndw
    assert len(twin_p.state_list.diag_log) < len(full_p.state_list.diag_log)


def test_total_ud_false_matches_true():
    """Orbital-resolved QNs (ed_total_ud=F) reproduce the total-QN results
    for an orbital-diagonal model, in the port and against the JAX
    package's orbital-resolved solve."""
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([0.1, -0.1])
    kw = dict(norb=2, nbath=2, uloc=(1.4, 1.4), ust=0.6, jh=0.15,
              beta=50.0, lmats=64, lreal=20)
    res_t, _ = _solves(kw, hloc)
    res_f, res_fj = _solves(kw, hloc, ed_total_ud=False)
    _assert_match(res_f, res_fj, 2)
    assert abs(res_t.observables.egs - res_f.observables.egs) < 1e-9
    np.testing.assert_allclose(res_f.observables.dens,
                               res_t.observables.dens, atol=1e-8)
    np.testing.assert_allclose(res_f.observables.docc,
                               res_t.observables.docc, atol=1e-8)
    for a in range(2):
        np.testing.assert_allclose(res_f.g_mats[0, 0, a, a],
                                   res_t.g_mats[0, 0, a, a], atol=1e-7)
    # the sectors carry one (nup, ndw) pair per orbital
    assert all(len(q[0]) == 2 for q, _, _ in res_f.state_list.diag_log)


def test_total_ud_false_rejects_offdiag_hloc():
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.array([[0.0, 0.3], [0.3, 0.0]])
    kw = dict(norb=2, nbath=1, uloc=(1.0, 1.0), ed_total_ud=False, lmats=16,
              lreal=8)
    with pytest.raises(ValueError):
        pt.EDSolver(pt.EDConfig(ed_backend="dense", **kw), hloc,
                    device="cpu").solve(pt.EDSolver(
                        pt.EDConfig(**kw), hloc, device="cpu").init_bath())
    with pytest.raises(ValueError):
        s = ed.EDSolver(ed.EDConfig(**kw), hloc)
        s.solve(s.init_bath())
