"""PyTorch port, the whole slice: run_dmft of the Bethe-lattice Hubbard
model (2 loops, nbath = 4) on the port's band-sparse path (its chain
kernels' plain versions on CPU) against the JAX package's dense backend,
and the chi2 fit's value and gradient against the JAX package's bath
functions under jax.grad.

Tolerances, each with its origin:
- first-solve Sigma and G, per-loop dens/docc: 1e-6, Egs 1e-9 — both
  packages reach f64-polished eigenpairs and tridiagonalize the small GF
  targets in f64. Each loop is held against the JAX solve of the SAME
  input bath: the port's polished two-stage vectors differ from the
  dense f64 Lanczos ones at ~1e-8, the loop-1 Weiss field by ~5e-8, and
  the chi2 fit's flat directions amplify that into ~3e-4 bath changes
  (measured; ROADMAP C), so loop 2 of two independent runs would
  compare two different baths. The fitted bath parameters are not
  compared one by one for the same reason;
- chi2 and gradient at a fixed bath: 1e-10 relative, the same f64
  arithmetic in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import fit as jfit
from dmft_lanc_ed_tpu.bath import Bath as JBath
from dmft_lanc_ed_tpu.bath_functions import g0and_bath as jax_g0and
from dmft_lanc_ed_tpu.models.hm_bethe import run_dmft as jax_run_dmft
from dmft_lanc_ed_tpu_torch import fit as pfit
from dmft_lanc_ed_tpu_torch.models.hm_bethe import run_dmft

KW = dict(norb=1, nbath=4, uloc=(2.0,), beta=50.0, lmats=128, lfit=64,
          lreal=16, nloop=2, dmft_error=1e-12, lanc_dim_threshold=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_dmft_matches_reference():
    """Each loop's solve against the JAX dense backend solving the same
    input bath, and loop 1 (same initial bath) against the JAX run_dmft."""
    res_p = run_dmft(pt.EDConfig(ed_backend="pallas", ed_batch_sectors=False,
                                 **KW), device="cpu", verbose=False)
    assert res_p.iterations == 2
    cfg_j = ed.EDConfig(ed_backend="dense", **KW)
    res_j = jax_run_dmft(cfg_j.replace(nloop=1), verbose=False)
    sj = ed.EDSolver(cfg_j, np.zeros((1, 1, 1, 1)))
    for i, hp in enumerate(res_p.history):
        rj = sj.solve(hp["bath"])
        np.testing.assert_allclose(hp["dens"], rj.observables.dens,
                                   atol=1e-6)
        np.testing.assert_allclose(hp["docc"], rj.observables.docc,
                                   atol=1e-6)
        assert abs(hp["egs"] - rj.observables.egs) < 1e-9
        if i == 0:
            np.testing.assert_allclose(hp["sigma_mats"], rj.sigma_mats,
                                       atol=1e-6)
            np.testing.assert_allclose(hp["g_mats"], rj.g_mats, atol=1e-6)
            np.testing.assert_allclose(hp["dens"], res_j.history[0]["dens"],
                                       atol=1e-6)
            np.testing.assert_allclose(hp["docc"], res_j.history[0]["docc"],
                                       atol=1e-6)
    # loop 2 really ran on the fitted, mixed bath
    assert not np.allclose(res_p.history[1]["bath"], res_p.history[0]["bath"])
    assert np.all(np.isfinite(res_p.sigma_mats))


@pytest.mark.parametrize("scheme,weight", [("weiss", 1), ("delta", 2),
                                           ("weiss", 3)])
def test_chi2_value_and_grad_match_reference(scheme, weight):
    cfg_p = pt.EDConfig(cg_scheme=scheme, cg_weight=weight, **KW)
    cfg_j = ed.EDConfig(cg_scheme=scheme, cg_weight=weight, **KW)
    rng = np.random.default_rng(4)
    nb, lfit = cfg_p.nbath, cfg_p.lfit
    theta = np.concatenate([rng.normal(size=nb), 0.5 + rng.random(nb)])
    wm = pt.matsubara_grid(cfg_p)[:lfit]
    target = 1.0 / (1j * wm + 0.3j * np.sign(wm) + 0.1 * rng.normal(
        size=lfit))
    h_aa = 0.05

    # port: the fit's own chi2 and autograd gradient
    z = torch.as_tensor(1j * wm, dtype=torch.complex128)
    wgt = torch.as_tensor(pfit._fit_weight(cfg_p, wm), dtype=torch.float64)
    tgt = torch.as_tensor(target, dtype=torch.complex128)
    val_p, grad_p = pfit.value_and_grad(
        lambda t: pfit.chi2_normal(cfg_p, t, z, tgt, wgt, h_aa), theta)

    # reference: its bath functions under jax.value_and_grad
    hloc = jnp.full((1, 1, 1, 1), h_aa)
    zj = jnp.asarray(1j * wm)
    wj = jnp.asarray(jfit._fit_weight(cfg_j, wm))

    def chi2_j(t):
        bath = JBath(e=t[:nb].reshape(1, 1, nb), v=t[nb:].reshape(1, 1, nb))
        if scheme == "weiss":
            f = jax_g0and(cfg_j, hloc, bath, zj)[0, 0, 0, 0]
        else:
            from dmft_lanc_ed_tpu.bath_functions import delta_bath
            f = delta_bath(cfg_j, bath, zj)[0, 0, 0, 0]
        r = jfit._cabs_pow(jnp.asarray(target) - f, cfg_j.cg_pow)
        return (r / wj).sum() / lfit
    val_j, grad_j = jax.value_and_grad(chi2_j)(jnp.asarray(theta))
    assert abs(val_p - float(val_j)) <= 1e-10 * abs(float(val_j))
    np.testing.assert_allclose(grad_p, np.asarray(grad_j), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(grad_j)).max())


def test_bath_functions_match_reference():
    cfg_p = pt.EDConfig(**KW)
    cfg_j = ed.EDConfig(**KW)
    rng = np.random.default_rng(8)
    packed = np.concatenate([rng.normal(size=4), rng.random(4)])
    z = 1j * pt.matsubara_grid(cfg_p)[:32] + 0.01
    hloc = np.full((1, 1, 1, 1), 0.2)
    bp, bj = pt.unpack_bath(cfg_p, packed), ed.unpack_bath(cfg_j, packed)
    from dmft_lanc_ed_tpu import bath_functions as jbf
    from dmft_lanc_ed_tpu_torch import bath_functions as pbf
    np.testing.assert_allclose(pbf.delta_bath(cfg_p, bp, z).numpy(),
                               np.asarray(jbf.delta_bath(cfg_j, bj, z)),
                               rtol=1e-13)
    np.testing.assert_allclose(pbf.g0and_bath(cfg_p, hloc, bp, z).numpy(),
                               np.asarray(jbf.g0and_bath(cfg_j, hloc, bj, z)),
                               rtol=1e-13)
    np.testing.assert_allclose(pbf.invg0_bath(cfg_p, hloc, bp, z).numpy(),
                               np.asarray(jbf.invg0_bath(cfg_j, hloc, bj, z)),
                               rtol=1e-13)
