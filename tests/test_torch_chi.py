"""PyTorch port, the spin and charge susceptibilities (``chi.py``) and full
ED (``diag._diag_full``, ``gf.build_gf_full``, the ``full_build_*``
twins) against the JAX package's EDSolver on the CPU, on the same bath.

Tolerances, each with its origin:
- chi on the dense f64 route against the JAX package's f64 solve: 1e-10
  on the bosonic Matsubara grid, imaginary time and the real axis. The
  port takes |psi>'s own component out of each start vector O|psi> and
  stores it as an exact dE = 0 pole (chi.py); with f64 chains that is the
  same function, and this bar holds the two forms to each other;
- the forced B4 route (every chi chain through the chain kernel's plain
  version, six-pass f32-fidelity products) against the JAX package's
  dense f64 solve: atol 5e-5, rtol 3e-5, the f32-chain GF contract of
  test_torch_offdiag.py; without the exact pole, the f32 chain's dE ~ 4e-8
  Ritz copy of |psi> crossed the 1e-8 reverse-ordering tolerance and moved
  chi_dens(tau) by 0.08 at this size;
- full ED against the JAX package's full ED: 1e-10 (both host LAPACK);
- lanc against full ED within the port: the JAX tests' own bars
  (test_chi.py 1e-8, test_solver.py 1e-5 / 1e-6, test_features.py 2e-3 /
  5e-3);
- the spinChi / densChi files: the same names, and the same numbers
  within their 9 printed decimals (1.1e-9); from the same poles
  (``convert.result_from_reference``) byte for byte.
"""
import filecmp
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import io as jio
from dmft_lanc_ed_tpu_torch import chi as pchi
from dmft_lanc_ed_tpu_torch import io as pio
from dmft_lanc_ed_tpu_torch.convert import result_from_reference
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


CHI = dict(chispin_flag=True, chidens_flag=True)
# name -> config kwargs (both packages)
CASES = {
    # test_chi.py:test_chi_oracle_single_orbital at finite T, both kinds
    "single-finite-t": dict(norb=1, nbath=2, uloc=(1.7,), beta=10.0,
                            lmats=16, lreal=11, ltau=20, wini=-3.0, wfin=3.0,
                            ed_finite_temp=True, lanc_nstates_total=4096,
                            lanc_nstates_sector=4096,
                            lanc_dim_threshold=4096, xmu=0.3, **CHI),
    # test_chi.py:test_chi_oracle_two_orbital_mixed: Jx/Jp in the dense
    # apply of every chain
    "two-orbital-jxjp": dict(norb=2, nbath=1, uloc=(1.5, 1.5), ust=0.7,
                             jh=0.2, jx=0.2, jp=0.2, beta=8.0, lmats=12,
                             lreal=9, ltau=16, wini=-3.0, wfin=3.0,
                             ed_finite_temp=True, lanc_nstates_total=4096,
                             lanc_nstates_sector=4096,
                             lanc_dim_threshold=4096, **CHI),
    # the three-orbital Kanamori model of chip_smoke.py phase 11 at
    # nbath = 1, T = 0: 7 chains a kind in the (3,3) sector of 400 states
    "kanamori3-t0": dict(norb=3, nbath=1, uloc=(2.5,) * 3, ust=1.5, jh=0.5,
                         beta=100.0, lmats=64, lreal=16, ltau=33,
                         lanc_dim_threshold=1024, **CHI),
}
_PORT, _REF = {}, {}


def _solve(name, port_kw, ref_kw=None):
    """(port result, JAX result, port cfg, JAX cfg) of one solve of the
    case's default bath, the port on the CPU; each package's solve cached
    per its arguments."""
    base = CASES[name] if name in CASES else FULL[name]
    ref_kw = ref_kw or {}
    kj = (name, tuple(sorted(ref_kw.items())))
    if kj not in _REF:
        cfg_j = ed.EDConfig(**base, **ref_kw)
        sj = ed.EDSolver(cfg_j, np.zeros((1, 1, cfg_j.norb, cfg_j.norb)))
        _REF[kj] = sj.solve(sj.init_bath()), cfg_j, sj.init_bath()
    rj, cfg_j, bath = _REF[kj]
    kp = (name, tuple(sorted(port_kw.items())))
    if kp not in _PORT:
        cfg_p = pt.EDConfig(**base, **port_kw)
        sp = pt.EDSolver(cfg_p, np.zeros((1, 1, cfg_p.norb, cfg_p.norb)),
                         device="cpu")
        assert bath.tobytes() == sp.init_bath().tobytes()
        _PORT[kp] = sp.solve(bath), cfg_p
    rp, cfg_p = _PORT[kp]
    return rp, rj, cfg_p, cfg_j


def _dense(name):
    return _solve(name, dict(ed_backend="dense"),
                  ref_kw=dict(ed_backend="dense"))


def _b4(name):
    """Every chi chain, and every GF chain, through B4's plain version;
    host eigh for the diag; the JAX package on dense f64."""
    return _solve(name, dict(ed_backend="pallas", ed_batch_sectors=False,
                             ed_gf_chain_min_dim=0),
                  ref_kw=dict(ed_backend="dense"))


def _grids(cfg):
    return bosonic_grid(cfg), tau_grid(cfg), real_grid(cfg)


def _assert_chi_close(got, want, cfg, keys=None, **tol):
    """Every channel of two chi sets on the three grids."""
    vm, tau, wr = _grids(cfg)
    keys = keys or list(want)
    for k in keys:
        a, b = got[k], want[k]
        for what, fa, fb in (
                ("iv", a.matsubara(cfg.beta, vm), b.matsubara(cfg.beta, vm)),
                ("tau", a.imtime(tau), b.imtime(tau)),
                ("w", a.realaxis(cfg.beta, wr, cfg.eps),
                 b.realaxis(cfg.beta, wr, cfg.eps))):
            np.testing.assert_allclose(fa, fb, err_msg=f"{k} {what}", **tol)


@pytest.mark.parametrize("kind", ["chi_spin", "chi_dens"])
@pytest.mark.parametrize("name", list(CASES))
def test_chi_matches_reference_dense(name, kind):
    rp, rj, cfg, _ = _dense(name)
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-10
    got, want = getattr(rp, kind), getattr(rj, kind)
    assert set(got) == set(want)
    assert len(got) == cfg.norb ** 2 + 1        # (a, b) and the total
    _assert_chi_close(got, want, cfg, atol=1e-10)
    assert pchi.routing  # the builders recorded their routing
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=1e-10)


@pytest.mark.parametrize("kind", ["chi_spin", "chi_dens"])
def test_chi_b4_route_matches_reference_dense(kind):
    rp, rj, cfg, _ = _b4("kanamori3-t0")
    assert rp.state_list.size == 1
    # one state: 3 diagonal, 3 mixed and the total chain of each kind,
    # all through the chain kernel in the (3,3) sector
    assert pchi.routing["spin"] == (7, 0)
    assert pchi.routing["dens"] == (7, 0)
    assert rp.gf.routing == (6, 0)
    _assert_chi_close(getattr(rp, kind), getattr(rj, kind), cfg,
                      atol=5e-5, rtol=3e-5)


@pytest.mark.parametrize("route", ["dense", "b4"])
def test_chi_degenerate_orbitals_and_sign(route):
    """Three degenerate orbitals: the diagonal channels agree, the mixed
    ones agree and chi_ab is chi_ba; chi(iv_0) > 0 on the diagonal."""
    rp, _, cfg, _ = (_dense if route == "dense" else _b4)("kanamori3-t0")
    vm = bosonic_grid(cfg)
    for kind in ("chi_spin", "chi_dens"):
        chis = getattr(rp, kind)
        diag = [chis[(a, a)].matsubara(cfg.beta, vm) for a in range(3)]
        mixed = [chis[(a, b)].matsubara(cfg.beta, vm)
                 for a in range(3) for b in range(a + 1, 3)]
        scale = np.abs(diag[0]).max()
        for group in (diag, mixed):
            for x in group[1:]:
                np.testing.assert_allclose(x, group[0], atol=1e-6 * scale)
        for a in range(3):
            assert diag[a][0] > 0
            for b in range(3):
                assert chis[(a, b)] is chis[(b, a)]


# --------------------------------------------------------------------------
# full ED
# --------------------------------------------------------------------------
FULL = {
    # test_chi.py:test_chi_full_ed_vs_lanc
    "full-two-orbital": dict(norb=2, nbath=1, uloc=(1.2, 1.2), ust=0.5,
                             jh=0.15, beta=6.0, lmats=12, lreal=9, ltau=16,
                             wini=-3.0, wfin=3.0, ed_finite_temp=True,
                             lanc_nstates_total=4096,
                             lanc_nstates_sector=4096, **CHI),
    # test_solver.py:test_full_ed_matches_lanc_t0
    "full-single": dict(norb=1, nbath=2, uloc=(1.5,), beta=200.0, lmats=32,
                        lreal=20, ed_finite_temp=True,
                        lanc_nstates_total=4096),
}


def _full(name, **kw):
    return _solve(name, dict(ed_backend="dense", ed_diag_type="full", **kw),
                  ref_kw=dict(ed_diag_type="full", **kw))


@pytest.mark.parametrize("name", list(FULL))
def test_full_ed_matches_reference(name):
    rp, rj, cfg, _ = _full(name)
    assert rp.state_list.size == rj.state_list.size > 1
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-10
    for f in ("g_mats", "g_real", "sigma_mats"):
        np.testing.assert_allclose(getattr(rp, f), getattr(rj, f),
                                   atol=1e-10, err_msg=f)
    for f in ("dens", "docc"):
        np.testing.assert_allclose(getattr(rp.observables, f),
                                   getattr(rj.observables, f), atol=1e-10)
    for kind in ("chi_spin", "chi_dens"):
        if getattr(rj, kind) is None:
            assert getattr(rp, kind) is None
            continue
        assert set(getattr(rp, kind)) == set(getattr(rj, kind))
        assert isinstance(getattr(rp, kind)[(0, 0)], pchi.PairChiPoles)
        _assert_chi_close(getattr(rp, kind), getattr(rj, kind), cfg,
                          atol=1e-10)


def test_full_gf_orbital_resolved_matches_reference():
    """build_gf_full with orbital-resolved sectors (ed_total_ud=False, each
    orbital its own target sector) on the full spectrum of
    test_features.py:test_total_ud_false_matches_true's model, function
    against function: the solvers' observables raise IndexError there in
    both packages (ROADMAP C)."""
    from dmft_lanc_ed_tpu import diag as jdiag
    from dmft_lanc_ed_tpu import gf as jgf
    from dmft_lanc_ed_tpu.bath import unpack_bath
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    from dmft_lanc_ed_tpu_torch import gf as pgf
    from dmft_lanc_ed_tpu_torch.convert import bath_from_reference
    kw = dict(norb=2, nbath=1, uloc=(1.4, 1.4), ust=0.6, jh=0.15,
              beta=20.0, lmats=16, ed_total_ud=False, ed_diag_type="full",
              ed_finite_temp=True, lanc_nstates_total=4096)
    cfg_j, cfg_p = ed.EDConfig(**kw), pt.EDConfig(**kw)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([0.1, -0.1])
    packed = ed.EDSolver(cfg_j, hloc).init_bath()
    t_j, t_p = ed.SectorTable(cfg_j), pt.SectorTable(cfg_p)
    assert t_p.ns_ud == 2
    sl_j = jdiag.diagonalize_impurity(cfg_j, t_j, hloc,
                                      unpack_bath(cfg_j, packed))
    sl_p = pdiag.diagonalize_impurity(cfg_p, t_p, hloc,
                                      bath_from_reference(packed, cfg_p),
                                      device="cpu")
    assert sl_p.size == sl_j.size == 4 ** cfg_p.ns
    np.testing.assert_allclose([s.e for s in sl_p.states],
                               [s.e for s in sl_j.states], atol=1e-10)
    g_j = jgf.build_gf_full(cfg_j, t_j, sl_j)
    g_p = pgf.build_gf_full(cfg_p, t_p, sl_p)
    assert sorted(g_p.channels) == sorted(g_j.channels)
    z = 1j * pt.matsubara_grid(cfg_p)
    np.testing.assert_allclose(g_p.evaluate(cfg_p, z),
                               g_j.evaluate(cfg_j, z), atol=1e-10)


def test_chi_full_ed_vs_lanc():
    """test_chi.py:test_chi_full_ed_vs_lanc within the port: the full-ED
    twins agree with the Lanczos path on every grid."""
    rf, _, cfg, _ = _full("full-two-orbital")
    rl = pt.EDSolver(cfg.replace(ed_diag_type="lanc",
                                 lanc_dim_threshold=4096),
                     np.zeros((1, 1, 2, 2)), device="cpu").solve(
        pt.EDSolver(cfg, device="cpu").init_bath())
    for kind in ("chi_spin", "chi_dens"):
        assert set(getattr(rl, kind)) == set(getattr(rf, kind))
        _assert_chi_close(getattr(rl, kind), getattr(rf, kind), cfg,
                          atol=1e-8)


def test_full_ed_matches_lanc_t0():
    """test_solver.py:test_full_ed_matches_lanc_t0 within the port: at
    beta = 200 the thermal state is the ground state."""
    rf, _, cfg, _ = _full("full-single")
    cfg_l = cfg.replace(ed_diag_type="lanc", ed_finite_temp=False,
                        lanc_nstates_total=1)
    rl = pt.EDSolver(cfg_l, device="cpu").solve(
        pt.EDSolver(cfg, device="cpu").init_bath())
    np.testing.assert_allclose(rf.g_mats[0, 0, 0, 0], rl.g_mats[0, 0, 0, 0],
                               atol=1e-5)
    assert abs(rf.observables.dens[0] - rl.observables.dens[0]) < 1e-6
    assert abs(rf.state_list.emin - rl.state_list.emin) < 1e-9


def test_finite_t_matches_full_ed():
    """test_features.py:test_finite_t_matches_full_ed within the port, and
    the capped finite-T Krylov solve against the JAX package's."""
    kw = dict(norb=1, nbath=2, uloc=(1.5,), beta=4.0, lmats=64, lreal=20,
              ed_finite_temp=True, ed_backend="dense")
    cfg_f = pt.EDConfig(ed_diag_type="full", lanc_nstates_total=4096, **kw)
    bath = pt.EDSolver(cfg_f, device="cpu").init_bath()
    res_f = pt.EDSolver(cfg_f, device="cpu").solve(bath)
    lanc = dict(ed_diag_type="lanc", lanc_nstates_total=60,
                lanc_nstates_sector=12, lanc_dim_threshold=4096,
                cutoff=1e-10)
    res_l = pt.EDSolver(cfg_f.replace(**lanc), device="cpu").solve(bath)
    assert abs(res_f.observables.dens[0] - res_l.observables.dens[0]) < 2e-3
    assert abs(res_f.observables.docc[0] - res_l.observables.docc[0]) < 2e-3
    np.testing.assert_allclose(res_l.g_mats[0, 0, 0, 0],
                               res_f.g_mats[0, 0, 0, 0], atol=5e-3)
    kw_j = {k: v for k, v in kw.items() if k != "ed_backend"}
    res_j = ed.EDSolver(ed.EDConfig(**kw_j, lanc_nstates_total=4096)
                        .replace(**lanc)).solve(bath)
    np.testing.assert_allclose(res_l.g_mats, res_j.g_mats, atol=1e-10)
    np.testing.assert_allclose(res_l.observables.dens, res_j.observables.dens,
                               atol=1e-10)


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------
def _chi_files(d):
    return sorted(n for n in os.listdir(d) if "Chi_" in n)


@pytest.mark.parametrize("name", ["kanamori3-t0", "full-two-orbital"])
def test_chi_files_match_reference(name, tmp_path):
    """write_all of each package's own solve: the same spinChi / densChi
    files, the same numbers within their printed digits; and the port's
    writer on the JAX package's poles byte for byte."""
    rp, rj, cfg, cfg_j = _full(name) if name in FULL else _dense(name)
    bath = ed.EDSolver(cfg_j).init_bath()
    dirs = {k: str(tmp_path / k) for k in ("j", "p", "c")}
    jio.write_all(cfg_j, rj, bath, outdir=dirs["j"])
    pio.write_all(cfg, rp, bath, outdir=dirs["p"])
    pio.write_all(cfg, result_from_reference(rj), bath, outdir=dirs["c"])
    names = _chi_files(dirs["j"])
    # per kind: the channels (a, b) and the total, on three grids
    assert len(names) == 2 * 3 * (cfg.norb ** 2 + 1)
    assert names == _chi_files(dirs["p"]) == _chi_files(dirs["c"])
    for f in names:
        a = np.loadtxt(os.path.join(dirs["j"], f))
        b = np.loadtxt(os.path.join(dirs["p"], f))
        np.testing.assert_allclose(b, a, rtol=0, atol=1.1e-9, err_msg=f)
    _, mismatch, errors = filecmp.cmpfiles(dirs["j"], dirs["c"], names,
                                           shallow=False)
    assert not mismatch and not errors, mismatch + errors
