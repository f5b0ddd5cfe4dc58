"""PyTorch port, the real-space drivers on the lattice bank
(``models/layered``, ``hm_square_afm2``, ``bhz_2d_edge``, ``wsm_slab``,
``bhz_slab``, ``hm_2b_afo``, ``pco``) against the JAX package's drivers on
the same input, their physics invariants, every driver's command line and
the entry points' refusal to run without a card.

Each driver runs on the CPU at a tiny size through the CPU's default
backend (``auto``: the stored ELL apply in both packages). Loop 1 is held
against the JAX driver's loop 1 (dens, docc and Sigma(iw) 1e-6), every
loop's sites against the JAX solves of their input baths (dens, docc
1e-6, Egs 1e-9; ``torch_driver_check.check_lattice_against_reference``,
ROADMAP C2: two runs' later baths differ through the chi2 fit's flat
directions). The physics checks are the JAX package's tests that it marks
slow (tests/test_drivers.py), at nbath <= 2, run on the port alone: the
AFM2 staggered magnetization, the reflection symmetry of the edge and slab
layers' dens (1e-6), the PCO bulk workload on a synthetic ``hr.dat``.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.models import (bhz_2d_edge, bhz_slab, hm_2b_afo,
                                           hm_square_afm2, layered, pco,
                                           wsm_slab)
from torch_driver_check import CPU_KW, check_lattice_against_reference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def test_afm2_run_layered_matches_reference():
    """hm_square_afm2 (run_layered, the staggered seed) loop 1 and every
    loop's sites against the JAX package."""
    from dmft_lanc_ed_tpu.models import hm_square_afm2 as j_afm2
    kw = dict(norb=1, nspin=2, nbath=2, uloc=(3.0,), sb_field=0.1)
    cfg_p = pt.EDConfig(nloop=2, **CPU_KW, **kw)
    cfg_j = ed.EDConfig(nloop=1, **CPU_KW, **kw)
    res_p, hist_p, _ = hm_square_afm2.run_dmft(cfg_p, nk=6, device="cpu",
                                               verbose=False)
    res_j, _, _ = j_afm2.run_dmft(cfg_j, nk=6, verbose=False)
    hloc_l = layered.hloc_blocks_from_hk(hm_square_afm2.hk_afm2_lso(6), 2,
                                         2, 1)
    check_lattice_against_reference(hist_p, res_j, cfg_j, hloc_l, 2)
    assert isinstance(res_p, pt.LatticeResult)
    assert hist_p[0]["mag"][0, 0] * hist_p[0]["mag"][1, 0] < 0
    assert [s["device"] for s in hist_p[0]["sites"]] == ["cpu", "cpu"]


@pytest.mark.parametrize("fullsym", [False, True])
def test_afo_matches_reference(fullsym):
    """hm_2b_afo, plain (two sites) and fullsym (site B the spin flip of
    A), with a crystal field: loop 1 and every loop's sites against the
    JAX package; the staggered seed gives mag_A = -mag_B."""
    from dmft_lanc_ed_tpu.models import hm_2b_afo as j_afo
    kw = dict(norb=2, nspin=2, nbath=1, uloc=(1.0, 1.0), ust=0.25,
              sb_field=0.1)
    dials = dict(wband=(1.0, 0.5), delta=0.2, fullsym=fullsym)
    cfg_p = pt.EDConfig(nloop=2, **CPU_KW, **kw)
    cfg_j = ed.EDConfig(nloop=1, **CPU_KW, **kw)
    res_p = hm_2b_afo.run_dmft(cfg_p, device="cpu", verbose=False, **dials)
    res_j = j_afo.run_dmft(cfg_j, verbose=False, **dials)
    nineq = 1 if fullsym else 2
    hloc = np.zeros((2, 2, 2, 2))
    for s in range(2):
        hloc[s, s] = np.diag([-0.1, 0.1])
    check_lattice_against_reference(res_p.history, res_j, cfg_j,
                                    [hloc] * nineq, 2)
    assert res_p.dens.shape == (nineq, 2) and res_p.iterations == 2
    if not fullsym:
        mag = res_p.history[0]["mag"]
        np.testing.assert_allclose(mag[0], -mag[1], atol=1e-8)
        assert np.abs(mag).min() > 1e-3


def test_bhz_slab_matches_reference():
    """bhz_slab's own loop (a mixer per layer, gloc_layers) against the
    JAX package: loop 1 and every loop's layers."""
    from dmft_lanc_ed_tpu.models import bhz_slab as j_slab
    kw = dict(norb=2, nspin=2, nbath=1, uloc=(0.5, 0.5), ust=0.25,
              bath_type="replica", lanc_nstates_sector=2)
    cfg_p = pt.EDConfig(nloop=2, **CPU_KW, **kw)
    cfg_j = ed.EDConfig(nloop=1, **CPU_KW, **kw)
    _, hist_p, _ = bhz_slab.run_dmft(cfg_p, ly=2, nk=6, device="cpu",
                                     verbose=False)
    res_j, _, _ = j_slab.run_dmft(cfg_j, ly=2, nk=6, verbose=False)
    hk = bhz_slab.hk_bhz_slab(6, 2)
    hloc_l = layered.hloc_blocks_from_hk(hk, 2, 2, 2)
    h_basis, lam = pt.decompose_hloc(cfg_p, hloc_l[0])
    check_lattice_against_reference(hist_p, res_j, cfg_j, hloc_l, 2,
                                    h_basis=h_basis, lambda_imp=lam)


def test_afm2_staggered_order():
    """AFM two-sublattice square lattice at U/t = 12 (test_drivers.py's
    slow test at nbath = 2): staggered magnetization of opposite signs on
    A/B, ordered, at half filling."""
    cfg = pt.EDConfig(norb=1, nspin=2, nbath=2, uloc=(3.0,), beta=50.0,
                      lmats=128, lfit=64, lreal=8, nloop=6, sb_field=0.1,
                      dmft_error=1e-4)
    res, _, _ = hm_square_afm2.run_dmft(cfg, ts=0.25, nk=8, device="cpu",
                                        verbose=False)
    mag = res.mag
    assert mag[0, 0] * mag[1, 0] < 0
    assert np.abs(mag).min() > 0.3
    np.testing.assert_allclose(res.dens.sum(), 2.0, atol=1e-3)


def test_bhz_edge_and_wsm_slab_reflection():
    """Edge and slab geometries (test_drivers.py's slow smoke test at
    nbath = 2): one loop; the layers' dens finite and symmetric under the
    layer reflection."""
    cfg = pt.EDConfig(norb=2, nspin=2, nbath=2, uloc=(0.5, 0.5), ust=0.25,
                      beta=20.0, lmats=64, lfit=48, lreal=8, nloop=1,
                      bath_type="replica", lanc_nstates_sector=2)
    res, _, _ = bhz_2d_edge.run_dmft(cfg, ly=3, nk=8, device="cpu",
                                     verbose=False)
    assert res.dens.shape == (3, 2) and np.isfinite(res.dens).all()
    np.testing.assert_allclose(res.dens[0], res.dens[2], atol=1e-6)
    res, _, _ = wsm_slab.run_dmft(cfg, ly=3, nk=4, device="cpu",
                                  verbose=False)
    assert np.isfinite(res.dens).all()
    np.testing.assert_allclose(res.dens[0], res.dens[2], atol=1e-6)


def _write_synthetic_hr(path, norb=3):
    """A minimal wannier90 hr.dat: a nearest-neighbor cubic t2g-like model
    with a crystal field (test_drivers.py's)."""
    rvecs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (0, 0, -1)]
    lines = ["synthetic t2g", f"{norb}", f"{len(rvecs)}",
             " ".join(["1"] * len(rvecs))]
    for r in rvecs:
        for i in range(norb):
            for j in range(norb):
                if r == (0, 0, 0):
                    val = 0.1 * i if i == j else 0.0
                else:
                    val = -0.25 if i == j else 0.0
                lines.append(f"{r[0]} {r[1]} {r[2]} {i + 1} {j + 1} "
                             f"{val:.6f} 0.000000")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def test_pco_bulk_workload(tmp_path):
    """PCO (edn_PCO.f90): three-orbital Kanamori DMFT from a Wannier90 hr
    file, bulk geometry (test_drivers.py's slow test): finite, and the
    crystal-field ordering survives the interaction."""
    p = tmp_path / "pco_hr.dat"
    _write_synthetic_hr(str(p))
    cfg = pt.EDConfig(norb=3, nspin=1, nbath=1, uloc=(1.0,) * 3, ust=0.5,
                      jh=0.1, beta=20.0, lmats=64, lfit=48, lreal=8, nloop=2,
                      dmft_error=1e-5, lanc_nstates_sector=2)
    res = pco.run_dmft(cfg, str(p), nk=4, device="cpu", verbose=False)
    assert np.isfinite(res.dens).all()
    assert res.dens[0] >= res.dens[2] - 1e-6


# --------------------------------------------------------------------------
# the command lines and the card
# --------------------------------------------------------------------------
_TINY = ["nloop=1", "lmats=32", "lfit=16", "lreal=8", "beta=20",
         "lanc_dim_threshold=4"]


def _mains(tmp_path):
    hr = tmp_path / "toy_hr.dat"
    _write_synthetic_hr(str(hr), norb=2)
    return {
        "hm_square_afm2": (hm_square_afm2, ["nbath=1", "nk=4"]),
        "bhz_2d_edge": (bhz_2d_edge, ["nbath=1", "ly=2", "nk=4"]),
        "wsm_slab": (wsm_slab, ["nbath=1", "ly=2", "nk=2"]),
        "bhz_slab": (bhz_slab, ["nbath=1", "ly=2", "nk=4", "m0=0.8"]),
        "hm_2b_afo": (hm_2b_afo, ["nbath=1", "wband=1.0,0.5",
                                  "fullsym=T", "dos_model=flat"]),
        "pco": (pco, [str(hr), "norb=1", "nspin=2", "nbath=1", "nk=2",
                      "nlat=2", "zsym=ANTIFERRO"]),
    }


@pytest.mark.parametrize("name", ["hm_square_afm2", "bhz_2d_edge",
                                  "wsm_slab", "bhz_slab", "hm_2b_afo",
                                  "pco"])
def test_lattice_mains_on_the_cpu(name, tmp_path, capsys):
    """Every driver's main parses its dials and ``device=cpu`` and runs one
    loop; without ``device=cpu`` it refuses to run without a card."""
    mod, args = _mains(tmp_path)[name]
    res = mod.main(args + _TINY + ["device=cpu"])
    if isinstance(res, tuple):               # pco's AFM geometry
        res = res[0]
    assert np.all(np.isfinite(res.dens))
    assert "converged=" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args + _TINY)


def _entry_points():
    from dmft_lanc_ed_tpu_torch.parallel import multihost_dryrun
    cfg1 = pt.EDConfig(norb=1, nspin=2, nbath=1, nloop=1)
    cfg2 = pt.EDConfig(norb=2, nspin=2, nbath=1, nloop=1)
    return {
        "LatticeSolver": lambda: pt.LatticeSolver(cfg1, 2),
        "run_layered": lambda: layered.run_layered(
            cfg1, hm_square_afm2.hk_afm2_lso(4), 2, verbose=False),
        "hm_square_afm2": lambda: hm_square_afm2.run_dmft(cfg1, nk=4),
        "bhz_2d_edge": lambda: bhz_2d_edge.run_dmft(cfg2, ly=2, nk=4),
        "wsm_slab": lambda: wsm_slab.run_dmft(cfg2, ly=2, nk=2),
        "bhz_slab": lambda: bhz_slab.run_dmft(cfg2, ly=2, nk=4),
        "hm_2b_afo": lambda: hm_2b_afo.run_dmft(cfg2),
        "dryrun": lambda: multihost_dryrun.solve_merged(),
    }


@pytest.mark.parametrize("entry", ["LatticeSolver", "run_layered",
                                   "hm_square_afm2", "bhz_2d_edge",
                                   "wsm_slab", "bhz_slab", "hm_2b_afo",
                                   "dryrun"])
def test_lattice_entry_points_need_the_card(entry, monkeypatch):
    """The new entry points default to the card; without one they raise,
    naming device="cpu", instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points()[entry]()


@pytest.mark.parametrize("name", ["hm_square_afm2", "bhz_2d_edge",
                                  "wsm_slab", "bhz_slab", "hm_2b_afo",
                                  "pco"])
def test_lattice_drivers_refuse_their_wrong_model(name, tmp_path):
    """A configuration the driver's model does not have raises a
    ValueError before any solve (also under ``python -O``)."""
    hr = tmp_path / "toy_hr.dat"
    _write_synthetic_hr(str(hr), norb=3)
    cfg3 = pt.EDConfig(norb=3, nspin=2, nbath=1, nloop=1)
    runs = {
        "hm_square_afm2": lambda: hm_square_afm2.run_dmft(
            cfg3, nk=4, device="cpu"),
        "bhz_2d_edge": lambda: bhz_2d_edge.run_dmft(cfg3, ly=2, nk=4,
                                                    device="cpu"),
        "wsm_slab": lambda: wsm_slab.run_dmft(cfg3, ly=2, nk=2,
                                              device="cpu"),
        "bhz_slab": lambda: bhz_slab.run_dmft(cfg3, ly=2, nk=4,
                                              device="cpu"),
        "hm_2b_afo": lambda: hm_2b_afo.run_dmft(cfg3, device="cpu"),
        # 3 Wannier functions, not nlat * norb = 6
        "pco": lambda: pco.run_dmft(cfg3, str(hr), nk=2, nlat=2,
                                    device="cpu"),
    }
    with pytest.raises(ValueError):
        runs[name]()


def test_slice_modules_import_no_jax():
    """The slice's modules import neither jax nor the JAX package."""
    import os
    import subprocess
    import sys
    mods = ["lattice", "ops.matvec", "ops.direct", "ops.davidson",
            "parallel.multihost_dryrun"] + [f"models.{m}" for m in (
                "layered", "hm_square_afm2", "bhz_2d_edge", "wsm_slab",
                "bhz_slab", "hm_2b_afo", "pco")]
    code = ("import sys; " + "; ".join(
        f"import dmft_lanc_ed_tpu_torch.{m}" for m in mods) +
        "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dmft_lanc_ed_tpu')); print(bad); "
        "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
