"""PyTorch port, one impurity solve (EDSolver.solve) against the JAX package
on CPU, on the slice's configuration: the band-sparse backend
(ed_backend="pallas") with ed_batch_sectors=False, every Krylov sector
through the two-stage chain solve, the port on its kernels' plain versions.

Tolerances, each with its origin:
- Egs 1e-9 and dens 1e-7: the f64 polish contract, as
  test_pallas.py:160-177 holds the JAX package's own pallas solve;
- g_mats 1e-4: that test's GF bound (both packages' GF chains carry
  f32-level noise in different places);
- the forced B4 route against the JAX dense backend: atol 5e-5,
  rtol 3e-5, the f32-chain GF contract of test_bs_chain.py:142-160.
"""
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(pkg, **kw):
    cfg = pkg.read_input(None, **kw)
    solver = pkg.EDSolver(cfg, device="cpu") if pkg is pt \
        else pkg.EDSolver(cfg)
    return solver.solve(solver.init_bath())


def test_solve_pallas_backend_matches_reference():
    kw = dict(norb=1, nbath=4, uloc=(2.0,), lmats=24, lreal=8,
              lanc_dim_threshold=8, ed_backend="pallas",
              ed_batch_sectors=False)
    rp, rj = _solve(pt, **kw), _solve(ed, **kw)
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-9
    # the same degenerate ground-state window; within it the order follows
    # energies equal to roundoff
    assert sorted(s.qn for s in rp.state_list.states) == \
        sorted(s.qn for s in rj.state_list.states)
    np.testing.assert_allclose(rp.observables.dens, rj.observables.dens,
                               atol=1e-7)
    np.testing.assert_allclose(rp.observables.docc, rj.observables.docc,
                               atol=1e-7)
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=1e-4)
    np.testing.assert_allclose(rp.sigma_mats, rj.sigma_mats, atol=1e-4)
    np.testing.assert_allclose(rp.g0_mats, rj.g0_mats, atol=1e-12)
    assert rp.gf.routing == (0, 4)          # small targets: dense scan


def test_solve_gf_chain_route_matches_reference_dense():
    """B4 route forced (every GF target through the chain kernel's plain
    version) against the JAX dense backend."""
    kw = dict(norb=1, nbath=6, uloc=(2.2,), lanc_dim_threshold=16,
              lmats=64, lreal=8, lanc_ngfiter=48)
    rp = _solve(pt, ed_backend="pallas", ed_batch_sectors=False,
                ed_gf_chain_min_dim=0, **kw)
    rj = _solve(ed, ed_backend="dense", **kw)
    assert rp.gf.routing[0] > 0 and rp.gf.routing[1] == 0
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-9
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=5e-5, rtol=3e-5)
    np.testing.assert_allclose(rp.observables.dens, rj.observables.dens,
                               atol=1e-7)
