"""Shared check of the port's DMFT drivers against the JAX package's
(tests/test_torch_drivers*.py).

Loop 1 of both drivers starts from the same initial bath, so its dens,
docc and Sigma(iw) agree at 1e-6 (the bar of test_torch_dmft.py: both
packages solve on f64 operators). Every loop of the port's run is also
held against the JAX package's solve of the SAME input bath, dens and
docc 1e-6, Egs 1e-9: two runs' later baths differ through the chi2 fit's
flat directions (ROADMAP C2), so loop 2 of two runs would compare two
baths. Where the GF targets run through B4's plain version (an f32 chain),
Sigma(iw) is held to the f32-chain GF contract instead, atol 5e-5 and rtol
3e-5 (test_torch_offdiag.py's forced-B4 bar).
"""
import numpy as np

import dmft_lanc_ed_tpu as ed

CPU_KW = dict(beta=30.0, lmats=64, lfit=48, lreal=8, dmft_error=1e-12)


def check_against_reference(res_p, res_j, cfg_j, hloc, nloop, h_basis=None,
                            lambda_imp=None, f32_chains=False):
    """`res_p`: the port's run (nloop loops); `res_j`: the JAX driver's
    loop 1 on the same input; `hloc`: the driver's local Hamiltonian;
    `f32_chains`: the port's GF ran through B4."""
    assert res_p.iterations == nloop
    h0 = res_p.history[0]
    np.testing.assert_allclose(h0["dens"], res_j.dens, atol=1e-6)
    np.testing.assert_allclose(h0["docc"], res_j.docc, atol=1e-6)
    tol = dict(atol=5e-5, rtol=3e-5) if f32_chains else dict(atol=1e-6)
    np.testing.assert_allclose(h0["sigma_mats"], res_j.sigma_mats, **tol)
    solver = ed.EDSolver(cfg_j, hloc, h_basis=h_basis, lambda_imp=lambda_imp)
    for ent in res_p.history:
        rj = solver.solve(ent["bath"])
        np.testing.assert_allclose(ent["dens"], rj.observables.dens,
                                   atol=1e-6)
        np.testing.assert_allclose(ent["docc"], rj.observables.docc,
                                   atol=1e-6)
        assert abs(ent["egs"] - rj.observables.egs) < 1e-9
        assert ent["timings"]["kernel_matvecs"] > 0
    if nloop > 1:
        # the later loops ran on the fitted, mixed bath
        assert not np.allclose(res_p.history[1]["bath"], h0["bath"])
    for x in (res_p.sigma_mats, res_p.weiss, res_p.bath, res_p.dens):
        assert np.all(np.isfinite(x))


def check_lattice_against_reference(hist_p, res_j, cfg_j, hloc_l, nloop,
                                    h_basis=None, lambda_imp=None):
    """The real-space drivers' check. `hist_p`: the port's history (nloop
    loops, ``models.layered.lattice_entry``'s entries); `res_j`: the JAX
    driver's loop 1 (dens, docc, sigma_mats stacked over the sites);
    `hloc_l`: the sites' local Hamiltonians. Loop 1's dens, docc and
    Sigma(iw) at 1e-6; every loop's sites against the JAX solves of their
    input baths, dens and docc 1e-6, Egs 1e-9."""
    assert len(hist_p) == nloop
    h0 = hist_p[0]
    np.testing.assert_allclose(h0["dens"], res_j.dens, atol=1e-6)
    np.testing.assert_allclose(h0["docc"], res_j.docc, atol=1e-6)
    sig = np.stack([s["sigma_mats"] for s in h0["sites"]])
    np.testing.assert_allclose(sig, res_j.sigma_mats, atol=1e-6)
    solvers = [ed.EDSolver(cfg_j, h, h_basis=h_basis, lambda_imp=lambda_imp)
               for h in hloc_l]
    for ent in hist_p:
        assert len(ent["sites"]) == len(hloc_l)
        for site, solver in zip(ent["sites"], solvers):
            rj = solver.solve(site["bath"])
            np.testing.assert_allclose(site["dens"], rj.observables.dens,
                                       atol=1e-6)
            np.testing.assert_allclose(site["docc"], rj.observables.docc,
                                       atol=1e-6)
            assert abs(site["egs"] - rj.observables.egs) < 1e-9
            assert site["timings"]["kernel_matvecs"] >= 0
    if nloop > 1:
        assert not np.allclose(hist_p[1]["bath"], h0["bath"])
    assert np.all(np.isfinite(hist_p[-1]["dens"]))
