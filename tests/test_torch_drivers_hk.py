"""PyTorch port, the H(k)-driven single-impurity drivers (``hm_2b_square``,
``from_hk`` with its Wannier90 ``hr.dat`` reader, ``square_family``'s four
models) against the JAX package's drivers on the same input.

Each driver runs on the CPU at a tiny size (nk <= 8); loop 1 is held
against the JAX driver's loop 1, every loop against the JAX solve of its
input bath (``torch_driver_check``). The three-orbital models (the
Daghofer model, a three-band ``hr.dat``) run at nbath = 1, as
test_drivers.py runs them.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.dmft import hk as jhk
from dmft_lanc_ed_tpu.models import from_hk as j_from_hk
from dmft_lanc_ed_tpu.models import hm_2b_square as j_2b
from dmft_lanc_ed_tpu.models import square_family as j_sq
from dmft_lanc_ed_tpu_torch.dmft import hk as phk
from dmft_lanc_ed_tpu_torch.models import (from_hk, hm_2b_square,
                                           square_family)
from dmft_lanc_ed_tpu_torch.ops import batched as bt
from torch_driver_check import CPU_KW, check_against_reference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread keep parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _write_synthetic_hr(path, norb=3):
    """Minimal wannier90 hr.dat: nearest-neighbor cubic t2g-like model
    (test_drivers.py's)."""
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


def test_w90_hr_reader(tmp_path):
    """hr.dat parse + Fourier transform (edn_PCO.f90 hk_from_w90_hr), equal
    to the JAX package's reader."""
    p = tmp_path / "toy_hr.dat"
    _write_synthetic_hr(str(p))
    hk = from_hk.hk_from_w90_hr(str(p), nk=4)
    assert hk.shape == (64, 3, 3)
    assert np.allclose(hk, hk.conj().transpose(0, 2, 1), atol=1e-12)
    g = hk[0]
    np.testing.assert_allclose(np.diag(g).real,
                               [0.1 * i - 1.5 for i in range(3)], atol=1e-12)
    np.testing.assert_allclose(hk.mean(axis=0).real,
                               np.diag([0.0, 0.1, 0.2]), atol=1e-12)
    assert np.array_equal(hk, j_from_hk.hk_from_w90_hr(str(p), nk=4))
    for got, ref in zip(from_hk.read_w90_hr(str(p)),
                        j_from_hk.read_w90_hr(str(p))):
        assert np.array_equal(got, ref)
    assert np.array_equal(from_hk.load_hk(str(p), nk=4), hk)
    np.save(tmp_path / "hk.npy", hk)
    assert np.array_equal(from_hk.load_hk(str(tmp_path / "hk.npy")), hk)
    with pytest.raises(ValueError, match="hermitian"):
        bad = hk.copy()
        bad[:, 0, 1] += 0.1
        np.save(tmp_path / "bad.npy", bad)
        from_hk.load_hk(str(tmp_path / "bad.npy"))
    with pytest.raises(ValueError, match="unsupported"):
        from_hk.load_hk(str(tmp_path / "hk.txt"))


def _cfgs(nloop, port_kw=None, **kw):
    port_kw = port_kw or {"ed_backend": "dense"}
    cfg_p = pt.EDConfig(nloop=nloop, **{**CPU_KW, **kw, **port_kw})
    return cfg_p, ed.EDConfig(nloop=1, **CPU_KW, **kw)


def test_2b_square_matches_reference():
    cfg_p, cfg_j = _cfgs(2, norb=2, nbath=2, uloc=(1.0, 1.0), ust=0.5,
                         jh=0.1)
    res_p = hm_2b_square.run_dmft(cfg_p, nk=8, device="cpu", verbose=False)
    res_j = j_2b.run_dmft(cfg_j, nk=8, verbose=False)
    hloc = jhk.hloc_from_hk(jhk.hk_square(8, 2, t=(0.25, 0.25)), 1, 2)
    check_against_reference(res_p, res_j, cfg_j, hloc, 2)


def test_from_hk_w90_matches_reference(tmp_path):
    """A three-band hr.dat (a crystal field 0, 0.1, 0.2) through from_hk's
    reader and loop; the crystal-field order survives the interaction."""
    p = str(tmp_path / "t2g_hr.dat")
    _write_synthetic_hr(p)
    hk = from_hk.load_hk(p, nk=4)
    cfg_p, cfg_j = _cfgs(1, norb=3, nbath=1, uloc=(1.0,) * 3, ust=0.5,
                         jh=0.1)
    res_p = from_hk.run_dmft(cfg_p, hk, device="cpu", verbose=False)
    res_j = j_from_hk.run_dmft(cfg_j, j_from_hk.load_hk(p, nk=4),
                               verbose=False)
    check_against_reference(res_p, res_j, cfg_j,
                            jhk.hloc_from_hk(hk, 1, 3), 1)
    np.testing.assert_allclose(res_p.ekin, res_j.ekin, atol=1e-6)
    assert res_p.dens[0] >= res_p.dens[2] - 1e-6


@pytest.mark.parametrize("model", ["square", "2nn", "daghofer", "pxpy"])
def test_square_family_matches_reference(model):
    """square and 2nn (t' breaks particle-hole symmetry), the three-band
    Daghofer model and px/py (spin-symmetrized fit), two loops each,
    against the JAX package's, each model's test_drivers.py invariant on
    the port's last loop."""
    if model in ("square", "2nn"):
        kw = dict(norb=1, nbath=4, uloc=(1.0,))
        dials = dict(ts=0.25, nk=8, **({"tsp": -0.1} if model == "2nn"
                                      else {}))
        hk = jhk.hk_square(8, 1, t=0.25) if model == "square" else \
            jhk.hk_square_2nn(8, 0.25, -0.1)
        nloop = 2
    elif model == "daghofer":
        kw = dict(norb=3, nbath=1, uloc=(0.8,) * 3, ust=0.4, jh=0.1)
        dials, hk, nloop = dict(nk=6), jhk.hk_daghofer(6), 1
    else:
        kw = dict(norb=2, nspin=2, nbath=2, uloc=(1.0, 1.0), ust=0.5)
        dials, hk, nloop = dict(nk=6), jhk.hk_triang_pxpy(6), 1
    cfg_p, cfg_j = _cfgs(nloop, **kw)
    run = {"square": "run_square", "2nn": "run_2nn",
           "daghofer": "run_daghofer", "pxpy": "run_pxpy"}[model]
    res_p = getattr(square_family, run)(cfg_p, device="cpu", verbose=False,
                                        **dials)
    res_j = getattr(j_sq, run)(cfg_j, verbose=False, **dials)
    nspin = cfg_j.nspin
    check_against_reference(res_p, res_j, cfg_j,
                            jhk.hloc_from_hk(hk, nspin, cfg_j.norb), nloop)
    if model == "square":
        assert abs(res_p.dens[0] - 1.0) < 1e-3
    elif model == "2nn":
        assert abs(res_p.dens[0] - 1.0) > 0.02
    elif model == "daghofer":
        assert np.all(res_p.dens > 0)
    else:
        obs = res_p.observables
        np.testing.assert_allclose(obs.dens_up, obs.dens_dw, atol=1e-6)


def test_hk_mains_on_the_cpu(tmp_path, capsys):
    """from_hk's and square_family's command lines: ``ed_batch_sectors=F``
    reaches the solver as False, ``device=cpu`` runs on the CPU, and
    without it the drivers refuse to run without a card."""
    np.save(tmp_path / "hk.npy", phk.hk_square(4, 1, t=0.25))
    tiny = ["nloop=1", "lmats=32", "lfit=16", "lreal=8", "beta=20",
            "nbath=2", "ed_backend=dense", "ed_batch_sectors=F",
            "lanc_dim_threshold=4"]
    for main, args in ((from_hk.main, [str(tmp_path / "hk.npy")]),
                       (square_family.main, ["2nn", "nk=4", "tsp=-0.1"])):
        bt.reset_bucket_counts()
        res = main(args + tiny + ["device=cpu"])
        assert res.iterations == 1 and np.all(np.isfinite(res.dens))
        assert any(k for _, _, k in res.history[0]["diag_log"])
        assert bt.bucket_counts["buckets"] == 0
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(args + tiny)
    assert "converged=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        from_hk.main(tiny)
