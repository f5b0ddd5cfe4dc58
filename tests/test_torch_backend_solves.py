"""PyTorch port, whole solves through the stored ELL backend, the
matrix-free direct backend and the Davidson eigensolver (the dispatch of
``ops/factory.py`` and ``lanc_method="dvdson"`` in ``diag.py``), against
the port's other backends and the JAX package on the same inputs
(tests/test_torch_backends.py holds the applies and the eigensolver
alone).

Tolerances, each with its origin:
- Egs 1e-9 and G(iw) 1e-6 between the direct and the stored backends
  (tests/test_features.py, test_direct.py), Egs 1e-10 and G(iw) 1e-8
  between the packages (both f64-exact);
- the Davidson solve within 1e-10 of the Lanczos one, G(iw) 1e-8
  (test_davidson.py::test_full_solve_dvdson_equals_arpack); over the
  band-sparse mixed apply (true-f32 products) Davidson and the f64 polish
  reach the LAPACK energies to 1e-10 (the ground-state gate);
- the direct apply on orbital-resolved sectors against the dense oracle
  and the JAX package's direct apply, 1e-12.
"""
import logging

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.ops import factory as pfac
from dmft_lanc_ed_tpu_torch.ops.direct import (build_direct_op,
                                               matvec_direct_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _orbital_resolved():
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([0.1, -0.1])
    kw = dict(norb=2, nbath=2, uloc=(1.4, 1.4), ust=0.6, jh=0.15,
              ed_total_ud=False, beta=50.0, lmats=32, lreal=8,
              lanc_dim_threshold=8)
    return kw, hloc


def test_direct_orbital_resolved():
    """ed_total_ud=F: the direct apply on composite masks equals the dense
    oracle per sector and the JAX package's direct apply (1e-12), the
    direct solve the stored one (test_direct.py), and the JAX package's
    direct solve (Egs, dens 1e-10, G(iw) 1e-8)."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.ops.direct import build_direct_op as j_direct
    from dmft_lanc_ed_tpu.ops.direct import \
        matvec_direct_flat as j_matvec_direct
    kw, hloc = _orbital_resolved()
    cfg = pt.EDConfig(**kw)
    cfg_j = ed.EDConfig(**kw)
    table = pt.SectorTable(cfg)
    table_j = ed.SectorTable(cfg_j)
    bath = pt.init_bath(cfg)
    bath_j = ed.init_bath(cfg_j)
    np.testing.assert_array_equal(pt.pack_bath(cfg, bath),
                                  np.asarray(ed.pack_bath(cfg_j, bath_j)))
    rng = np.random.default_rng(0)
    for sqn in [((2, 1), (1, 2)), ((1, 1), (1, 1)), ((2, 0), (0, 2))]:
        sec = table.sector(sqn)
        dense = pt.dense_hamiltonian(pt.build_sector_hamiltonian(
            cfg, sec, hloc, bath))
        op = build_direct_op(cfg, sec, hloc, bath, "cpu")
        x = rng.standard_normal(sec.dim)
        y = matvec_direct_flat(op, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y, dense @ x, atol=1e-12,
                                   err_msg=str(sqn))
        y_j = np.asarray(j_matvec_direct(
            j_direct(cfg_j, table_j.sector(sqn), hloc, bath_j),
            jnp.asarray(x)))
        np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-12,
                                   err_msg=str(sqn))
    b = pt.pack_bath(cfg, bath)
    res_dir = pt.EDSolver(cfg.replace(ed_backend="direct"), hloc,
                          device="cpu").solve(b)
    res_j = ed.EDSolver(cfg_j.replace(ed_backend="direct"), hloc).solve(b)
    assert abs(res_dir.observables.egs - res_j.observables.egs) < 1e-10
    np.testing.assert_allclose(res_dir.observables.dens,
                               np.asarray(res_j.observables.dens),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res_dir.g_mats, np.asarray(res_j.g_mats),
                               rtol=0, atol=1e-8)
    res_ell = pt.EDSolver(cfg.replace(ed_backend="ell"), hloc,
                          device="cpu").solve(b)
    assert abs(res_dir.observables.egs - res_ell.observables.egs) < 1e-9
    np.testing.assert_allclose(res_dir.observables.dens,
                               res_ell.observables.dens, atol=1e-8)
    for a in range(2):
        np.testing.assert_allclose(res_dir.g_mats[0, 0, a, a],
                                   res_ell.g_mats[0, 0, a, a], atol=1e-6)


def _solve(cfg, hloc=None):
    s = pt.EDSolver(cfg, hloc, device="cpu")
    return s.solve(s.init_bath())


def test_full_solve_dvdson_equals_lanczos():
    """lanc_method=dvdson end to end equals the thick-restart solve, and
    the JAX package's dvdson solve."""
    kw = dict(norb=1, nbath=5, uloc=(2.0,), lmats=32, lreal=8,
              lanc_dim_threshold=16)
    ra = _solve(pt.read_input(None, **kw))
    rd = _solve(pt.read_input(None, lanc_method="dvdson", **kw))
    sj = ed.EDSolver(ed.read_input(None, lanc_method="dvdson", **kw))
    rj = sj.solve(sj.init_bath())
    assert any(k for _, _, k in rd.state_list.diag_log)
    assert abs(ra.state_list.emin - rd.state_list.emin) < 1e-10
    np.testing.assert_allclose(rd.g_mats, ra.g_mats, atol=1e-8)
    np.testing.assert_allclose(rd.observables.dens, ra.observables.dens,
                               atol=1e-10)
    assert abs(rd.state_list.emin - rj.state_list.emin) < 1e-10
    np.testing.assert_allclose(rd.g_mats, rj.g_mats, atol=1e-8)


def test_dvdson_over_the_band_sparse_mixed_apply():
    """lanc_method=dvdson under ed_backend="pallas" (what "auto" is on the
    card): Davidson over the band-sparse mixed apply (true-f32 products),
    then the f64 polish; its Krylov sectors' energies within 1e-10 of
    LAPACK."""
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import matvec_bs_flat
    cfg = pt.EDConfig(norb=1, nbath=5, uloc=(2.0,), lmats=32, lreal=8,
                      ed_backend="pallas", lanc_method="dvdson",
                      ed_batch_sectors=False, lanc_dim_threshold=100)
    s = pt.EDSolver(cfg, device="cpu")
    bath = s.init_bath()
    op, apply = pfac.make_sector_op(cfg, s.table.sector(pt.qn(3, 3)),
                                    s.hloc, pt.unpack_bath(cfg, bath), "cpu")
    assert apply is matvec_bs_flat
    res = s.solve(bath)
    krylov = [(q, e) for q, e, k in res.state_list.diag_log if k]
    assert krylov
    for q, evals in krylov:
        h = pt.build_sector_hamiltonian(cfg, s.table.sector(q), s.hloc,
                                        pt.unpack_bath(cfg, bath))
        w = np.linalg.eigvalsh(pt.dense_hamiltonian(h))[:len(evals)]
        np.testing.assert_allclose(evals, w, rtol=0, atol=1e-10,
                                   err_msg=str(q))


def test_direct_backend_solver_end_to_end():
    """ed_backend='direct' reproduces the stored-backend solve
    (test_features.py) and the JAX package's direct solve."""
    kw = dict(norb=1, nbath=4, uloc=(2.0,), beta=100.0, lmats=64, lreal=20,
              lanc_dim_threshold=8)
    res_ell = _solve(pt.EDConfig(**kw))
    res_dir = _solve(pt.EDConfig(ed_backend="direct", **kw))
    assert abs(res_ell.observables.egs - res_dir.observables.egs) < 1e-9
    np.testing.assert_allclose(res_dir.g_mats[0, 0, 0, 0],
                               res_ell.g_mats[0, 0, 0, 0], atol=1e-6)
    sj = ed.EDSolver(ed.EDConfig(ed_backend="direct", **kw))
    rj = sj.solve(sj.init_bath())
    assert abs(res_dir.observables.egs - rj.observables.egs) < 1e-10
    np.testing.assert_allclose(res_dir.g_mats, rj.g_mats, atol=1e-8)


def test_ed_sparse_h_flag_dispatch(caplog):
    """ED_SPARSE_H=F routes "auto" to the direct backend (logged), and the
    solve runs through (test_features.py)."""
    cfg = pt.EDConfig(norb=1, nbath=3, uloc=(1.0,), ed_sparse_h=False,
                      lmats=32, lreal=16, lanc_dim_threshold=8)
    assert pfac.resolve_backend(cfg, "cpu") == "direct"
    with caplog.at_level(logging.INFO, logger="dmft_lanc_ed_tpu_torch"):
        res = _solve(cfg)
    assert abs(res.observables.dens[0] - 1.0) < 1e-8
    assert "direct (matrix-free) backend" in caplog.text
