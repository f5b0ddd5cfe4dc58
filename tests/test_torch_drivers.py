"""PyTorch port, the DOS-driven single-impurity drivers (``dos_driver``,
``hm_vhs``, ``vo2``, ``hm_bethe_afm``, ``multiorb_kanamori``) against the
JAX package's drivers on the same input, and every driver's command line.

Each driver runs on the CPU at a tiny size; loop 1 is held against the JAX
driver's loop 1, every loop against the JAX solve of its input bath
(``torch_driver_check``). The three-orbital Kanamori model runs at
nbath = 1 (6 sites; at nbath = 2 one loop takes ~10 s a package on the
CPU), through the band-sparse backend in the default layout scaled down:
batched buckets up to 300 states, the (3,3) sector of 400 states through
the two-stage chain solve (the kernels' plain versions) and the GF targets
of 300 states or more through B4's plain version, as the card runs the
853,776-state sector.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.models import hm_bethe_afm as j_afm
from dmft_lanc_ed_tpu.models import hm_vhs as j_vhs
from dmft_lanc_ed_tpu.models import multiorb_kanamori as j_kan
from dmft_lanc_ed_tpu.models import vo2 as j_vo2
from dmft_lanc_ed_tpu_torch.models import (dos_driver, hm_2b_square,
                                           hm_bethe_afm, hm_vhs,
                                           multiorb_kanamori, vo2)
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


def _run_both(port_mod, jax_mod, kw, nloop, port_kw=None, **dials):
    """The port driver (nloop loops, device="cpu") and the JAX driver's
    loop 1 on the same input."""
    port_kw = port_kw or {"ed_backend": "dense"}
    cfg_p = pt.EDConfig(nloop=nloop, **{**CPU_KW, **kw, **port_kw})
    cfg_j = ed.EDConfig(nloop=1, **CPU_KW, **kw)
    res_p = port_mod.run_dmft(cfg_p, device="cpu", verbose=False, **dials)
    res_j = jax_mod.run_dmft(cfg_j, verbose=False, **dials)
    return res_p, res_j, cfg_j


def test_dens_2dsquare_normalized():
    from dmft_lanc_ed_tpu_torch.dmft.bethe import dens_2dsquare
    e = np.linspace(-4.0, 4.0, 2001)
    de = e[1] - e[0]
    rho = dens_2dsquare(e, 1.0)
    assert abs(rho.sum() * de - 1.0) < 5e-3         # normalized (log sing.)
    assert rho[1000] > 5 * rho[500]                 # van Hove peak at 0
    from dmft_lanc_ed_tpu.dmft.bethe import dens_2dsquare as j_dens
    assert np.array_equal(rho, j_dens(e, 1.0))


def test_vhs_matches_reference():
    res_p, res_j, cfg_j = _run_both(
        hm_vhs, j_vhs, dict(norb=1, nbath=3, uloc=(1.0,)), 2, ts=0.5)
    check_against_reference(res_p, res_j, cfg_j, np.zeros((1, 1, 1, 1)), 2)
    assert abs(res_p.dens[0] - 1.0) < 1e-4    # half filling (test_drivers.py)
    eb, db = hm_vhs.vhs_bands(pt.EDConfig(), 0.5, 300)
    eb_j, db_j = j_vhs.vhs_bands(ed.EDConfig(), 0.5, 300)
    assert np.array_equal(eb, eb_j) and np.array_equal(db, db_j)


def test_vo2_matches_reference():
    dials = dict(x1=0.3, x2=0.2, lam=1.5, delta=0.5)
    res_p, res_j, cfg_j = _run_both(
        vo2, j_vo2, dict(norb=2, nbath=2, uloc=(1.0, 1.0), ust=0.5), 1,
        **dials)
    delta = 0.5 + 0.1 * 0.2 ** 2
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([-delta / 2, delta / 2])
    check_against_reference(res_p, res_j, cfg_j, hloc, 1)
    # the crystal field polarizes the orbitals (test_drivers.py's invariant)
    assert res_p.dens[0] > res_p.dens[1] + 0.05
    for model in ("bethe", "flat"):
        got = vo2.vo2_bands(pt.EDConfig(norb=2), 0.3, 1.5, (1.0, 0.5), model,
                            200)
        ref = j_vo2.vo2_bands(ed.EDConfig(norb=2), 0.3, 1.5, (1.0, 0.5),
                              model, 200)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_vo2_with_phonons_raises():
    """A phonon configuration of the VO2 driver (nph > 0, e-ph coupling)
    no longer raises: it runs as the JAX driver does, loop 1 against the
    JAX driver's and every loop against the JAX solve of its bath; the
    loop's state carries the displacement GF."""
    dials = dict(x1=0.3, x2=0.2, lam=1.5, delta=0.5)
    kw = dict(norb=2, nbath=1, uloc=(1.0, 1.0), ust=0.5, nph=2,
              g_ph=(0.3, 0.2), w0_ph=0.5)
    res_p, res_j, cfg_j = _run_both(vo2, j_vo2, kw, 2, **dials)
    delta = 0.5 + 0.1 * 0.2 ** 2
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([-delta / 2, delta / 2])
    check_against_reference(res_p, res_j, cfg_j, hloc, 2)
    r1 = res_p.history[0]["result"]
    assert r1.gf_phonon is not None
    assert abs(r1.observables.ph_occ.sum() - 1.0) < 1e-8


def test_bethe_afm_matches_reference():
    res_p, res_j, cfg_j = _run_both(
        hm_bethe_afm, j_afm, dict(norb=1, nspin=2, nbath=3, uloc=(3.0,)), 2)
    check_against_reference(res_p, res_j, cfg_j, np.zeros((2, 2, 1, 1)), 2)
    mags = [h["mag"] for h in res_p.history]
    np.testing.assert_allclose(mags[0], res_j.history[0]["mag"], atol=1e-6)
    assert abs(mags[0]) > 1e-3                     # the seed field orders it


@pytest.mark.parametrize("norb,nbath,port_kw", [
    (3, 1, dict(ed_backend="pallas", lanc_dim_threshold=100,
                ed_batch_dim_max=300, ed_gf_chain_min_dim=300)),
    (2, 2, dict(ed_backend="dense"))])
def test_kanamori_matches_reference(norb, nbath, port_kw):
    kw = dict(norb=norb, nbath=nbath, uloc=(2.5,) * norb, ust=1.5, jh=0.5)
    nloop = 2 if norb == 3 else 1
    bt.reset_bucket_counts()
    res_p, res_j, cfg_j = _run_both(multiorb_kanamori, j_kan, kw, nloop,
                                    port_kw)
    pallas = port_kw["ed_backend"] == "pallas"
    check_against_reference(res_p, res_j, cfg_j,
                            np.zeros((1, 1, norb, norb)), nloop,
                            f32_chains=pallas)
    h0 = res_p.history[0]
    # degenerate orbitals without a crystal field
    assert np.ptp(h0["dens"]) < 1e-6 and np.ptp(h0["docc"]) < 1e-6
    if pallas:
        assert bt.bucket_counts["buckets"] > 0
        krylov = {q for q, _, k in h0["diag_log"] if k}
        assert pt.qn(3, 3) in krylov               # the two-stage chain solve
        assert h0["routing"][0] > 0                # GF chains through B4
    if nloop == 1:
        np.testing.assert_allclose(res_p.ekin, res_j.ekin, atol=1e-6)


# --------------------------------------------------------------------------
# the command lines
# --------------------------------------------------------------------------
_TINY = ["nloop=1", "lmats=32", "lfit=16", "lreal=8", "beta=20",
         "ed_backend=dense", "ed_batch_sectors=F", "lanc_dim_threshold=4"]
MAINS = {
    "hm_vhs": (hm_vhs, ["nbath=2", "ts=0.5"]),
    "vo2": (vo2, ["nbath=1", "x1=0.3", "delta=0.4", "wband=1.0,0.5"]),
    "hm_bethe_afm": (hm_bethe_afm, ["nbath=2", "uloc=3.0", "wmixing=0.3"]),
    "hm_2b_square": (hm_2b_square, ["nbath=1", "nk=4"]),
    "multiorb_kanamori": (multiorb_kanamori,
                          ["nbath=1", "crystal_field=0.1,0.0,-0.1"]),
}


def test_parse_driver_argv_like_the_input_file():
    path, over, extra = dos_driver.parse_driver_argv(
        ["in.conf", "ED_BATCH_SECTORS=F", "uloc=1.5,2.5", "nbath=4",
         "ts=0.5", "flag=T", "dos_file=x.dat", "device=cpu", "foo=[1, 2]"],
        float_keys=("ts",), bool_keys=("flag",), str_keys=("dos_file",))
    assert path == "in.conf"
    assert over["ed_batch_sectors"] is False and over["nbath"] == 4
    assert pt.read_input(None, **{k: over[k] for k in ("uloc",)}).uloc[:2] \
        == (1.5, 2.5)
    assert over["foo"] == [1, 2]
    assert extra == dict(ts=0.5, flag=True, dos_file="x.dat", device="cpu")


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_parses_like_the_input_file_and_needs_the_card(name, capsys):
    """``ed_batch_sectors=F`` reaches the solver as False (no bucket is
    solved although Krylov sectors exist), ``device=cpu`` runs on the CPU,
    and without it the driver refuses to run without a card."""
    mod, args = MAINS[name]
    bt.reset_bucket_counts()
    res = mod.main(args + _TINY + ["device=cpu"])
    assert res.iterations == 1 and np.all(np.isfinite(res.dens))
    assert any(k for _, _, k in res.history[0]["diag_log"])
    assert bt.bucket_counts["buckets"] == 0
    assert "converged=" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args + _TINY)


def test_new_modules_import_no_jax():
    """The slice's modules import neither jax nor the JAX package."""
    import os
    import subprocess
    import sys
    mods = ["io", "utils", "utils.observability", "convert", "solver",
            "fit"] + [f"models.{m}" for m in (
                "dos_driver", "hm_vhs", "vo2", "hm_bethe_afm",
                "hm_2b_square", "multiorb_kanamori", "from_hk",
                "square_family")]
    code = ("import sys; " + "; ".join(
        f"import dmft_lanc_ed_tpu_torch.{m}" for m in mods) +
        "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dmft_lanc_ed_tpu')); print(bad); "
        "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
