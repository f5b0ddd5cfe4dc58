"""PyTorch port, the batched small-sector solve (ops/batched.py and the
default ``ed_batch_sectors=True`` dispatch of diag.py) against the JAX
package on CPU, from the same numpy inputs.

Each port test also asserts, through ``ops.batched.bucket_counts``, that
the batched path really ran: the JAX package's own
``tests/test_features.py::test_batched_sector_scan_matches_serial`` runs
``ed_backend="auto"``, which is ELL on the CPU, and so never batches
(ROADMAP C4).

Tolerances, each with its origin:
- bucket energies 1e-10 and eigenvector overlaps 1 - 1e-9: both solvers
  converge every element to the same residual tolerance (f64: 1e-14; mixed:
  the 3e-6 floor, then the f64 Rayleigh-Ritz polish), the energy gate of
  bench.py:51;
- one impurity solve: Egs 1e-10, dens/docc 1e-10, G(iw) 1e-8 — the same
  f64 eigenpairs feed the same f64 GF scan in both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.ops import batched as jb
from dmft_lanc_ed_tpu.ops.dense import densify as jax_densify
from dmft_lanc_ed_tpu_torch.convert import hamiltonian_from_reference
from dmft_lanc_ed_tpu_torch.ops import batched as pb
from dmft_lanc_ed_tpu_torch.ops.dense import densify


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket_ops(sqns):
    """The JAX and port dense ops of sectors of nbath = 5 (default bath)."""
    kw = dict(norb=1, nbath=5, uloc=(2.0,))
    cfg = ed.read_input(None, **kw)
    table = ed.SectorTable(cfg)
    bath = ed.init_bath(cfg)
    ops_j, ops_p = [], []
    for sqn in sqns:
        h = ed.build_sector_hamiltonian(cfg, table.sector(sqn),
                                        np.zeros((1,) * 4), bath)
        ops_j.append(jax_densify(h))
        ops_p.append(densify(hamiltonian_from_reference(
            {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}),
            "cpu"))
    return ops_j, ops_p


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_bucket_solver_matches_reference(precision):
    sqns = [ed.qn(2, 2), ed.qn(2, 3), ed.qn(3, 3), ed.qn(4, 3), ed.qn(4, 4)]
    ops_j, ops_p = _bucket_ops(sqns)
    assert len({pb.bucket_key(o) for o in ops_p}) == 1
    assert pb.bucket_key(ops_p[0]) == jb.bucket_key(ops_j[0])
    tol = 1e-14 if precision == "f64" else 3e-6
    pb.reset_bucket_counts()
    sols_p = pb.lanczos_ground_state_bucket(ops_p, 2, tol=tol,
                                            precision=precision, ncv=24)
    sols_j = jb.lanczos_ground_state_bucket(ops_j, 2, tol=tol,
                                            precision=precision, ncv=24)
    assert pb.bucket_counts["buckets"] == 1
    assert pb.bucket_counts["sectors"] == len(sqns)
    assert pb.bucket_counts["unconverged"] == 0
    for op_p, (e_p, v_p), (e_j, v_j) in zip(ops_p, sols_p, sols_j):
        e_j, v_j = np.asarray(e_j), np.asarray(v_j)
        assert v_p.shape == (2, op_p.dim)
        np.testing.assert_allclose(e_p, e_j, atol=1e-10, rtol=0)
        for k in range(2):
            # overlap with the JAX eigenspace of the same energy
            same = np.abs(e_j - e_j[k]) < 1e-8
            assert np.linalg.norm(v_j[same] @ v_p[k]) >= 1 - 1e-9


def test_pad_and_stack_ops():
    _, (op,) = _bucket_ops([ed.qn(2, 3)])
    du_p, dd_p, _, _ = pb.bucket_key(op)
    pad = pb.pad_dense_op_2d(op, du_p, dd_p)
    assert pad.diag.shape == (dd_p, du_p)
    assert torch.equal(pad.diag[:op.dim_dw, :op.dim_up], op.diag)
    assert torch.all(pad.diag[op.dim_dw:] == pb.PAD_SHIFT)
    assert torch.all(pad.diag[:op.dim_dw, op.dim_up:] == pb.PAD_SHIFT)
    assert torch.all(pad.hup[op.dim_up:] == 0) and \
        torch.all(pad.hdw[:, op.dim_dw:] == 0)
    st = pb.stack_ops([pad, pad])
    assert st.hup32.shape == (2, du_p, du_p)
    v = torch.randn(2, dd_p, du_p, dtype=torch.float64)
    y = pb.matvec_dense(st, v)
    assert torch.allclose(y[1], pb.matvec_dense(pad, v[1]))


@pytest.mark.parametrize("kw", [
    dict(norb=1, nbath=4, uloc=(2.0,), lanc_dim_threshold=8),
    dict(norb=2, nbath=2, uloc=(1.0, 1.5), ust=0.3, jh=0.05,
         lanc_dim_threshold=16)])
def test_solve_batched_sectors_matches_reference(kw):
    kw = dict(kw, lmats=24, lreal=8, ed_backend="dense",
              ed_batch_sectors=True)
    cfg_p = pt.read_input(None, **kw)
    sp = pt.EDSolver(cfg_p, device="cpu")
    pb.reset_bucket_counts()
    rp = sp.solve(sp.init_bath())
    assert pb.bucket_counts["buckets"] > 0 and \
        pb.bucket_counts["sectors"] > 0
    assert pb.bucket_counts["unconverged"] == 0
    sj = ed.EDSolver(ed.read_input(None, **kw))
    rj = sj.solve(sj.init_bath())
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-10
    for (q_p, e_p, l_p), (q_j, e_j, l_j) in zip(rp.state_list.diag_log,
                                                rj.state_list.diag_log):
        assert (q_p, l_p) == (q_j, l_j)
        np.testing.assert_allclose(e_p, np.asarray(e_j), atol=1e-10, rtol=0)
    np.testing.assert_allclose(rp.observables.dens, rj.observables.dens,
                               atol=1e-10)
    np.testing.assert_allclose(rp.observables.docc, rj.observables.docc,
                               atol=1e-10)
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=1e-8)
