"""PyTorch port, the lattice bank (``lattice.py``), the H(k) and local
Hamiltonian builders of the real-space drivers, the two-rank lattice
dryrun (``parallel/multihost_dryrun.py``) and the orbital-resolved
finite-T observables (ROADMAP C12), each against the JAX package on the
same numpy inputs.

Tolerances, each with its origin:
- the builders: 1e-12 (the same float64 arithmetic; gloc_layers through
  host LAPACK in both);
- the bank's solves: Egs and dens 1e-10, G(iw) 1e-8 (both packages solve
  on f64-exact ELL operators); the bank over three CPU "devices" equal to
  the one-device loop bit for bit (the same solves on the same device);
- the per-site fit against the JAX bank's: 1e-6 (both minimizers stop at
  cg_ftol, on their own paths);
- the dryrun: the merged arrays identical on both ranks, and against the
  one-process bank dens and Egs 1e-10, Sigma 1e-7, the fitted baths 1e-8
  (tests/test_multihost.py's gates);
- C12: the orbital-resolved finite-T solve equals the total-QN solve of the
  same orbital-diagonal model to 1e-10 in dens, docc and the impurity
  density matrix, through full ED and through Krylov sectors whose kept
  states reach exp(-beta (E - Egs)) < 1e-60.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.lattice import LatticeSolver, site_devices
from dmft_lanc_ed_tpu_torch.parallel import multihost_dryrun as pdry
from dmft_lanc_ed_tpu_torch.parallel.multihost import run_local_ranks

RANK_TIMEOUT = 240.0     # seconds; a hung rank fails the test


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _builders():
    """name -> (port call, JAX call), each taking no argument."""
    from dmft_lanc_ed_tpu.models import bhz_2d_edge as jedge
    from dmft_lanc_ed_tpu.models import bhz_slab as jslab
    from dmft_lanc_ed_tpu.models import hm_2b_afo as jafo
    from dmft_lanc_ed_tpu.models import hm_square_afm2 as jafm2
    from dmft_lanc_ed_tpu.models import layered as jlay
    from dmft_lanc_ed_tpu.models import pco as jpco
    from dmft_lanc_ed_tpu.models import wsm_slab as jwsm
    from dmft_lanc_ed_tpu_torch.models import (bhz_2d_edge, bhz_slab,
                                               hm_2b_afo, hm_square_afm2,
                                               layered, pco, wsm_slab)
    rng = np.random.default_rng(5)
    hk_orb = rng.normal(size=(6, 6, 6)) + 1j * rng.normal(size=(6, 6, 6))
    hk_orb = hk_orb + hk_orb.conj().transpose(0, 2, 1)
    ly, nw = 3, 16
    sig = (rng.normal(size=(ly, 2, 2, 2, 2, nw))
           + 1j * rng.normal(size=(ly, 2, 2, 2, 2, nw))) * 0.1
    z = 1j * np.pi / 10.0 * (2 * np.arange(nw) + 1)
    hk_edge = jedge.hk_bhz_edge(4, ly)
    cfg_p = pt.EDConfig(norb=2, nspin=2, nbath=1)
    cfg_j = ed.EDConfig(norb=2, nspin=2, nbath=1)
    return {
        "hk_afm2_lso": (lambda: hm_square_afm2.hk_afm2_lso(6, 0.3),
                        lambda: jafm2.hk_afm2_lso(6, 0.3)),
        "hk_bhz_edge": (lambda: bhz_2d_edge.hk_bhz_edge(5, 3, lam=0.4,
                                                        pbc=True),
                        lambda: jedge.hk_bhz_edge(5, 3, lam=0.4, pbc=True)),
        "hk_wsm_slab": (lambda: wsm_slab.hk_wsm_slab(3, 3, bz=0.2, pbc=True),
                        lambda: jwsm.hk_wsm_slab(3, 3, bz=0.2, pbc=True)),
        "hk_bhz_slab": (lambda: bhz_slab.hk_bhz_slab(5, 3, m0=0.8),
                        lambda: jslab.hk_bhz_slab(5, 3, m0=0.8)),
        "afo_bands": (lambda: np.stack(hm_2b_afo.afo_bands(
                          cfg_p, (1.0, 0.5), "flat", 50)),
                      lambda: np.stack(jafo.afo_bands(
                          cfg_j, (1.0, 0.5), "flat", 50))),
        "_embed_spin": (lambda: pco._embed_spin(hk_orb, 2, nlat=2),
                        lambda: jpco._embed_spin(hk_orb, 2, nlat=2)),
        "hloc_blocks_from_hk": (
            lambda: layered.hloc_blocks_from_hk(hk_edge, ly, 2, 2),
            lambda: jlay.hloc_blocks_from_hk(hk_edge, ly, 2, 2)),
        "gloc_layers": (lambda: bhz_slab.gloc_layers(hk_edge, sig, z, 0.1),
                        lambda: jslab.gloc_layers(hk_edge, sig, z, 0.1)),
    }


@pytest.mark.parametrize("name", ["hk_afm2_lso", "hk_bhz_edge",
                                  "hk_wsm_slab", "hk_bhz_slab", "afo_bands",
                                  "_embed_spin", "hloc_blocks_from_hk",
                                  "gloc_layers"])
def test_builders_match_reference(name):
    port, ref = _builders()[name]
    out_p, out_j = np.asarray(port()), np.asarray(ref())
    assert out_p.shape == out_j.shape
    assert np.abs(out_p).max() > 0
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-12)


BANK_KW = dict(norb=2, nbath=1, uloc=(2.0, 1.5), ust=1.0, jh=0.2,
               beta=20.0, lmats=32, lreal=8, lanc_dim_threshold=4)
UL = np.array([[2.0, 1.5], [1.2, 1.8], [2.6, 2.2]])
UST = np.array([1.0, 0.7, 1.2])
JH = np.array([0.2, 0.1, 0.3])


def _bank_hloc():
    hloc = np.zeros((3, 1, 1, 2, 2))
    hloc[1, 0, 0] = np.diag([0.15, -0.1])
    hloc[2, 0, 0] = np.array([[0.0, 0.05], [0.05, 0.1]])
    return hloc


def test_lattice_solver_matches_reference():
    """Three sites with per-site Uloc / Ust / Jh overrides and local
    Hamiltonians: every site's Egs, dens and G(iw) against the JAX bank."""
    hloc = _bank_hloc()
    bank = LatticeSolver(pt.EDConfig(**BANK_KW), 3, hloc=hloc, uloc_ii=UL,
                         ust_ii=UST, jh_ii=JH, device="cpu")
    jbank = ed.LatticeSolver(ed.EDConfig(**BANK_KW), 3, hloc=hloc,
                             uloc_ii=UL, ust_ii=UST, jh_ii=JH)
    baths = bank.init_baths()
    np.testing.assert_array_equal(baths, jbank.init_baths())
    res, res_j = bank.solve(baths), jbank.solve(baths)
    assert isinstance(res, pt.LatticeResult)
    assert [s.cfg.uloc[:2] for s in bank.solvers] == [tuple(u) for u in UL]
    egs = np.array([r.observables.egs for r in res.results])
    egs_j = np.array([r.observables.egs for r in res_j.results])
    np.testing.assert_allclose(egs, egs_j, rtol=0, atol=1e-10)
    assert np.ptp(egs) > 0.1              # the overrides took effect
    np.testing.assert_allclose(res.dens, res_j.dens, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.g_mats, res_j.g_mats, rtol=0, atol=1e-8)
    assert res.sigma_mats.shape == (3, 1, 1, 2, 2, 32)
    assert res.mag.shape == res.docc.shape == (3, 2)


def test_lattice_sites_distributed_over_devices():
    """The round robin over devices (here three CPU "devices") equals the
    one-device site loop exactly (test_parallel.py's check)."""
    cfg = pt.EDConfig(norb=1, nbath=3, uloc=(2.0,), beta=20.0, lmats=64,
                      lreal=32)
    hloc = np.zeros((3, 1, 1, 1, 1))
    hloc[1, 0, 0, 0, 0] = 0.3
    hloc[2, 0, 0, 0, 0] = -0.2
    lat = LatticeSolver(cfg, 3, hloc=hloc, device="cpu")
    baths = lat.init_baths()
    res_serial = lat.solve(baths)
    lat2 = LatticeSolver(cfg, 3, hloc=hloc, device="cpu")
    res_dist = lat2.solve(baths, devices=["cpu"] * 3)
    assert [str(s.device) for s in lat2.solvers] == ["cpu"] * 3
    np.testing.assert_array_equal(res_dist.dens, res_serial.dens)
    np.testing.assert_array_equal(res_dist.sigma_mats, res_serial.sigma_mats)


def test_site_devices_round_robin(monkeypatch):
    """"cuda" takes every visible card, sites round robin over them; a
    list is taken as given."""
    assert site_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    devs = site_devices("cuda")
    assert devs == [torch.device("cuda", i) for i in range(3)]
    assert site_devices("cuda:1") == [torch.device("cuda", 1)]


def test_fit_baths_per_site_files(tmp_path):
    """The per-site fit writes the fit's files with the suffix _ineq<NNNN>,
    and equals the JAX bank's per-site fit within 1e-6 (the two packages'
    minimizers stop at cg_ftol on their own paths, ~1e-8 apart here)."""
    cfg = pt.EDConfig(norb=1, nbath=2, uloc=(2.0,), lmats=32, lfit=24,
                      lreal=8)
    hloc = np.zeros((2, 1, 1, 1, 1))
    hloc[1, 0, 0, 0, 0] = 0.2
    bank = LatticeSolver(cfg, 2, hloc=hloc, device="cpu")
    baths = bank.init_baths()
    # the target: the Weiss fields of perturbed baths
    rng = np.random.default_rng(3)
    res = bank.solve(baths + 0.05 * rng.normal(size=baths.shape))
    weiss = np.stack([r.g0_mats for r in res.results])
    fitted = bank.fit_baths(weiss, baths, outdir=str(tmp_path))
    assert len(bank.fit_seconds) == 2
    jbank = ed.LatticeSolver(ed.EDConfig(norb=1, nbath=2, uloc=(2.0,),
                                         lmats=32, lfit=24, lreal=8), 2,
                             hloc=hloc)
    np.testing.assert_allclose(fitted, jbank.fit_baths(weiss, baths),
                               rtol=0, atol=1e-6)
    names = sorted(p.name for p in tmp_path.iterdir())
    for i in (1, 2):
        assert any(n.endswith(f"_ineq{i:04d}.ed") for n in names), names


def test_dryrun_two_gloo_ranks_match_one_process_bank():
    """The two-rank dryrun (3 sites over 2 gloo ranks): the merged arrays
    identical on both ranks and equal to the one-process bank."""
    out = run_local_ranks(pdry.dryrun_rank, 2, args=("cpu",), device="cpu",
                          timeout=RANK_TIMEOUT)
    r0, r1 = out
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for k in ("sigma_mats", "g_mats", "dens", "docc", "egs", "fitted"):
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    arrays, fitted = pdry.solve_merged("cpu")
    np.testing.assert_allclose(r0["dens"], arrays.dens, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r0["egs"], arrays.egs, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r0["sigma_mats"], arrays.sigma_mats, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(r0["fitted"], fitted, rtol=0, atol=1e-8)
    assert np.all(arrays.egs != 0) and len(set(arrays.egs)) == 3


def test_dryrun_problem_matches_reference():
    """The dryrun's problem and its one-process merge equal the JAX
    package's (dens, Egs 1e-10; G 1e-8)."""
    from dmft_lanc_ed_tpu.parallel import multihost_dryrun as jdry
    cfg, nlat, hloc, uloc_ii = pdry.lattice_problem()
    cfg_j, nlat_j, hloc_j, uloc_j = jdry.lattice_problem()
    assert nlat == nlat_j and cfg.uloc == cfg_j.uloc
    np.testing.assert_array_equal(hloc, hloc_j)
    np.testing.assert_array_equal(uloc_ii, uloc_j)
    arrays, _ = pdry.solve_merged("cpu")
    arrays_j, _ = jdry.solve_merged()
    np.testing.assert_allclose(arrays.dens, arrays_j.dens, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(arrays.egs, arrays_j.egs, rtol=0, atol=1e-10)
    np.testing.assert_allclose(arrays.g_mats, arrays_j.g_mats, rtol=0,
                               atol=1e-8)


C12_KW = dict(norb=2, nbath=1, uloc=(1.4, 1.4), ust=0.6, jh=0.15, lmats=32,
              lreal=8, ed_finite_temp=True, lanc_nstates_total=64)
C12_PATHS = {
    "full": dict(ed_diag_type="full", beta=5.0),
    # Krylov sectors above 3 states, 3 states each; the state list is
    # capped at 64 and spans beta (E - Egs) > 150 in both layouts
    "krylov": dict(ed_backend="ell", beta=50.0, lanc_dim_threshold=3,
                   lanc_nstates_sector=3),
}


def _c12_hloc():
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([0.1, -0.1])
    return hloc


@pytest.mark.parametrize("path", sorted(C12_PATHS))
def test_orbital_resolved_finite_t_observables(path):
    """ROADMAP C12: the orbital-resolved (ed_total_ud=F) finite-T solve
    gives the total-QN solve's dens, docc and impurity density matrix; the
    off-diagonal <c+_a c_b> vanish. The JAX package fails on this input
    (IndexError in observables._density_matrix), a difference on
    purpose."""
    kw = dict(C12_KW, **C12_PATHS[path])
    out = {}
    for ud in (True, False):
        s = pt.EDSolver(pt.EDConfig(ed_total_ud=ud, **kw), _c12_hloc(),
                        device="cpu")
        out[ud] = s.solve(s.init_bath())
    o_t, o_f = out[True].observables, out[False].observables
    sl = out[False].state_list
    if path == "krylov":
        assert any(k for _, _, k in sl.diag_log)
        assert kw["beta"] * (sl.emax - sl.emin) > 138
    for name in ("dens", "docc", "imp_dm"):
        np.testing.assert_allclose(getattr(o_f, name), getattr(o_t, name),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert np.all(o_f.imp_dm[:, 0, 1] == 0)
    js = ed.EDSolver(ed.EDConfig(ed_total_ud=False, **kw), _c12_hloc())
    with pytest.raises(IndexError):
        js.solve(js.init_bath())
