"""PyTorch port, the BHZ replica-bath driver: the H(k) builders, and
``models.bhz_2d.run_dmft`` (nspin = 2, norb = 2, a replica bath over the
4-element basis ``decompose_hloc`` takes from the BHZ hloc) on the CPU,
each loop against the JAX package's solve of the same input bath.

Tolerances, each with its origin:
- H(k) builders and hloc_from_hk: exact (the same numpy arithmetic);
- each loop's Egs 1e-9, dens 1e-6, loop 1's Sigma and G 1e-6: the bars of
  test_torch_dmft.py. Each loop is held against the JAX solve of the SAME
  input bath: two runs' loop-2 baths differ through the chi2 fit's flat
  directions (ROADMAP C2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.dmft import hk as jhk
from dmft_lanc_ed_tpu_torch.dmft import hk as phk
from dmft_lanc_ed_tpu_torch.models import bhz_2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(norb=2, nspin=2, nbath=2, bath_type="replica", uloc=(2.0, 2.0),
          ust=1.0, jh=0.5, beta=50.0, lmats=128, lfit=64, lreal=16, nloop=2,
          dmft_error=1e-12)
NK = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The matrices here are small: one torch intra-op thread and one BLAS
    thread (the host eigh of every sector, in both packages) are as fast
    alone and keep parallel test workers from oversubscribing the cores
    (a BHZ run took 62 s against 13 s beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("builder,args", [
    ("hk_square", (6, 2, [0.25, 0.4], [0.1, -0.1])),
    ("hk_bhz_2d", (6, 1.2, 0.4, 0.6)),
    ("hk_square_2nn", (6, 0.25, -0.05)),
    ("hk_daghofer", (5, 0.9, 0.1, 0.02)),
    ("hk_triang_pxpy", (5, 1.0, -0.8, 0.1, 0.05)),
    ("hk_afm2_square", (6, 0.3)),
])
def test_hk_builders_match_reference(builder, args):
    got = getattr(phk, builder)(*args)
    ref = getattr(jhk, builder)(*args)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(phk.kgrid_2d(args[0]), jhk.kgrid_2d(args[0]))
    nso = got.shape[-1]
    if builder == "hk_bhz_2d":
        hl_p = phk.hloc_from_hk(got, 2, 2)
        assert np.array_equal(hl_p, jhk.hloc_from_hk(ref, 2, 2))
    elif np.allclose(got.mean(0).imag, 0.0, atol=1e-10):
        assert np.array_equal(phk.hloc_from_hk(got, 1, nso),
                              jhk.hloc_from_hk(ref, 1, nso))


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_bhz_run_dmft_matches_reference(backend):
    """Two loops on the port (dense, or the band-sparse backend with its
    kernels' plain versions), each against the JAX dense solve of its
    input bath."""
    res = bhz_2d.run_dmft(pt.EDConfig(ed_backend=backend, **KW), nk=NK,
                          device="cpu", verbose=False)
    assert res.iterations == 2
    cfg_j = ed.EDConfig(ed_backend="dense", **KW)
    hloc = jhk.hloc_from_hk(jhk.hk_bhz_2d(NK), 2, 2)
    basis, lam = ed.decompose_hloc(cfg_j, hloc)
    assert basis.shape[0] == 4
    sj = ed.EDSolver(cfg_j, hloc, h_basis=basis, lambda_imp=lam)
    assert res.history[0]["bath"].tobytes() == sj.init_bath().tobytes()
    for i, h in enumerate(res.history):
        rj = sj.solve(h["bath"])
        assert abs(h["egs"] - rj.observables.egs) < 1e-9
        np.testing.assert_allclose(h["dens"], rj.observables.dens, atol=1e-6)
        if i == 0:
            np.testing.assert_allclose(h["sigma_mats"], rj.sigma_mats,
                                       atol=1e-6)
            np.testing.assert_allclose(h["g_mats"], rj.g_mats, atol=1e-6)
            # every spin's off-diagonal channel, with the pole-weight
            # identities of test_torch_offdiag.py (1e-12)
            chans = h["gf_data"].channels
            for s in range(2):
                assert (s, 0, 1) in chans and (s, 1, 0) in chans
            for (s, a, b), gp in chans.items():
                want = 1.0 if a == b else 0.0
                assert abs(gp.weights.sum() - want) <= 1e-12, (s, a, b)
    # loop 2 ran on the fitted, mixed replica bath (same N_dec head)
    b0, b1 = res.history[0]["bath"], res.history[1]["bath"]
    assert not np.allclose(b0, b1)
    assert np.array_equal(b0[:KW["nbath"]], b1[:KW["nbath"]])
    assert len(res.bath) == pt.bath_dimension(pt.EDConfig(**KW), 4)
    assert np.all(np.isfinite(res.sigma_mats))


def test_bhz_cli_on_the_cpu(capsys):
    """The CLI parses values as the input file does (``ed_batch_sectors=F``
    a Fortran logical) and runs on the CPU when asked to."""
    res = bhz_2d.main(["nbath=1", "nloop=1", "lmats=32", "lfit=16",
                       "lreal=8", "ed_backend=dense", "ed_batch_sectors=F",
                       "nk=4", "m0=0.8", "device=cpu"])
    assert res.iterations == 1 and np.all(np.isfinite(res.dens))
    assert "converged=" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a card")
def test_bhz_driver_without_a_card_raises():
    """The driver takes the card by default and does not fall back to the
    CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bhz_2d.run_dmft(pt.EDConfig(ed_backend="dense", **KW), nk=NK,
                        verbose=False)
    cfg = pt.EDConfig(ed_backend="dense", **KW)
    hloc = phk.hloc_from_hk(phk.hk_bhz_2d(NK), 2, 2)
    basis, lam = pt.decompose_hloc(cfg, hloc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.EDSolver(cfg, hloc, h_basis=basis, lambda_imp=lam)


def test_new_modules_import_no_jax():
    code = ("import sys; import dmft_lanc_ed_tpu_torch.hloc, "
            "dmft_lanc_ed_tpu_torch.dmft.hk, "
            "dmft_lanc_ed_tpu_torch.models.bhz_2d, "
            "dmft_lanc_ed_tpu_torch.bath, "
            "dmft_lanc_ed_tpu_torch.bath_functions, "
            "dmft_lanc_ed_tpu_torch.fit, dmft_lanc_ed_tpu_torch.gf; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmft_lanc_ed_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
