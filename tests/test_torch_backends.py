"""PyTorch port, the stored ELL backend (``ops/matvec.py``), the
matrix-free direct backend (``ops/direct.py``), the Davidson eigensolver
(``ops/davidson.py``) and the factory's dispatch (``ops/factory.py``),
against the JAX package on the same numpy inputs (whole solves:
tests/test_torch_backend_solves.py).

Tolerances, each with its origin:
- the applies: the port's ELL and direct applies against the JAX package's
  ELL apply on random vectors, max|d| <= 1e-12 x max|y| (the f64 stored
  and direct backends, tests/test_direct.py and
  test_dense.py::test_dense_equals_ell_and_oracle); the nonzero counts
  equal;
- Davidson: 1e-9 against LAPACK and the JAX package's Davidson, residuals
  1e-8, degenerate sets orthonormal to 1e-7 (tests/test_davidson.py);
- op_diag_flat: every backend's op gives the Hamiltonian's diagonal to
  1e-12.
"""
import logging

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.ops import factory as pfac
from dmft_lanc_ed_tpu_torch.ops.davidson import (davidson_ground_state,
                                                 op_diag_flat)
from dmft_lanc_ed_tpu_torch.ops.direct import (DirectSectorOp,
                                               build_direct_op,
                                               matvec_direct_flat)
from dmft_lanc_ed_tpu_torch.ops.lanczos import lanczos_ground_state
from dmft_lanc_ed_tpu_torch.ops.matvec import (EllSectorOp, apply_h,
                                               build_ell_op, ell_op,
                                               matvec_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


CASES = {
    # tests/test_direct.py
    "normal": (dict(norb=1, nbath=4, uloc=(2.1,), xmu=0.1), ((2,), (3,))),
    "two_orbital": (dict(norb=2, nbath=2, uloc=(1.5, 1.0), ust=0.4,
                         jh=0.1), ((3,), (2,))),
    "hybrid": (dict(norb=2, nbath=3, uloc=(1.0, 1.0), bath_type="hybrid"),
               ((2,), (2,))),
    "jx_jp": (dict(norb=2, nbath=2, uloc=(1.5, 1.0), ust=0.4, jh=0.15,
                   jx=0.15, jp=0.15), ((3,), (2,))),
    "phonon": (dict(norb=1, nbath=3, uloc=(2.0,), nph=3, w0_ph=0.7,
                    g_ph=(0.3,), xmu=0.2), ((2,), (2,))),
    # tests/test_dense.py::test_dense_equals_ell_and_oracle
    "dense_half": (dict(norb=1, nbath=5, uloc=(2.0,)), ((3,), (3,))),
    "dense_jxjp": (dict(norb=2, nbath=2, uloc=(2.0, 1.5), ust=0.8, jh=0.2,
                        jx=0.2, jp=0.2), ((3,), (3,))),
    "dense_phonon": (dict(norb=1, nbath=3, uloc=(2.0,), nph=2, g_ph=(0.3,),
                          w0_ph=1.0), ((2,), (2,))),
}


def _inputs(kw, seed=0):
    """(cfg_p, cfg_j, hloc, bath numpy arrays) of a random sector problem
    (test_direct.py's _setup)."""
    cfg_p, cfg_j = pt.EDConfig(**kw), ed.EDConfig(**kw)
    rng = np.random.default_rng(seed)
    norb_e = cfg_p.norb if cfg_p.bath_type == "normal" else 1
    e = rng.normal(size=(cfg_p.nspin, norb_e, cfg_p.nbath))
    v = rng.normal(size=(cfg_p.nspin, cfg_p.norb, cfg_p.nbath)) * 0.5
    hloc = rng.normal(size=(cfg_p.nspin, cfg_p.nspin, cfg_p.norb,
                            cfg_p.norb)) * 0.2
    hloc = (hloc + hloc.transpose(0, 1, 3, 2)) / 2
    return cfg_p, cfg_j, hloc, e, v


@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_and_direct_match_reference_ell(case):
    """The port's ELL and direct applies (a batch of three vectors) against
    the JAX package's ELL apply of each vector."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.ops.direct import build_direct_op as j_direct
    from dmft_lanc_ed_tpu.ops.matvec import matvec_flat as j_matvec
    kw, sqn = CASES[case]
    cfg_p, cfg_j, hloc, e, v = _inputs(kw)
    sec_p, sec_j = pt.SectorTable(cfg_p).sector(sqn), \
        ed.SectorTable(cfg_j).sector(sqn)
    h_j = ed.build_sector_hamiltonian(cfg_j, sec_j, hloc,
                                      ed.Bath(e=jnp.asarray(e),
                                              v=jnp.asarray(v)))
    bath = pt.Bath(e=e, v=v)
    eop = build_ell_op(cfg_p, sec_p, hloc, bath, "cpu")
    dop = build_direct_op(cfg_p, sec_p, hloc, bath, "cpu")
    x = np.random.default_rng(1).normal(size=(3, sec_p.dim))
    y_ref = np.stack([np.asarray(j_matvec(h_j, jnp.asarray(xi)))
                      for xi in x])
    scale = np.abs(y_ref).max()
    xt = torch.as_tensor(x)
    for name, y in (("ell", matvec_flat(eop, xt)),
                    ("direct", matvec_direct_flat(dop, xt))):
        d = np.abs(y.numpy() - y_ref).max()
        assert d <= 1e-12 * scale, (name, d, scale)
    assert eop.nnz == h_j.nnz > 0
    assert dop.nnz == j_direct(cfg_j, sec_j, hloc, ed.Bath(
        e=jnp.asarray(e), v=jnp.asarray(v))).nnz
    # the natural-shape apply is the flat one
    xn = xt[0].reshape(eop.vshape)
    assert torch.equal(apply_h(eop, xn).reshape(-1), matvec_flat(eop, xt[0]))


def test_direct_replica():
    """A replica bath (intra-replica hops) through the direct apply."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.ops.matvec import matvec_flat as j_matvec
    kw = dict(norb=2, nbath=2, uloc=(1.0, 1.0), bath_type="replica")
    cfg_p, cfg_j = pt.EDConfig(**kw), ed.EDConfig(**kw)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.array([[0.2, 0.1], [0.1, -0.2]])
    h_basis, lam_imp = pt.decompose_hloc(cfg_p, hloc)
    lam = np.stack([lam_imp * 0.7, lam_imp * 1.2])
    v_rep = np.array([[0.5], [0.6]])
    sec = pt.SectorTable(cfg_p).sector(pt.qn(2, 2))
    dop = build_direct_op(cfg_p, sec, hloc, pt.Bath(lam=lam, v_rep=v_rep),
                          "cpu", h_basis=h_basis)
    h_j = ed.build_sector_hamiltonian(
        cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(2, 2)), hloc,
        ed.Bath(lam=jnp.asarray(lam), v_rep=jnp.asarray(v_rep)),
        h_basis=h_basis)
    x = np.random.default_rng(2).normal(size=sec.dim)
    y_ref = np.asarray(j_matvec(h_j, jnp.asarray(x)))
    y = matvec_direct_flat(dop, torch.as_tensor(x)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


def _sector_h(norb=1, nbath=6, nup=3, ndw=3, seed=0, **kw):
    """test_davidson.py's sector: a random normal bath, zero hloc; the
    port's ELL op and the JAX package's SectorHamiltonian."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    kw = dict(norb=norb, nbath=nbath, uloc=(2.0,) * norb, **kw)
    cfg_p, cfg_j = pt.read_input(None, **kw), ed.read_input(None, **kw)
    e = rng.normal(size=(1, norb, nbath))
    v = rng.normal(size=(1, norb, nbath)) * 0.5
    hloc = np.zeros((1, 1, norb, norb))
    sec = pt.SectorTable(cfg_p).sector(pt.qn(nup, ndw))
    h = pt.build_sector_hamiltonian(cfg_p, sec, hloc, pt.Bath(e=e, v=v))
    h_j = ed.build_sector_hamiltonian(
        cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(nup, ndw)), hloc,
        ed.Bath(e=jnp.asarray(e), v=jnp.asarray(v)))
    return sec, ell_op(h, "cpu"), h, h_j


def test_davidson_matches_lapack_and_reference():
    """Three lowest states: LAPACK, the port's Lanczos and the JAX
    package's Davidson; eigenvector residuals."""
    from dmft_lanc_ed_tpu.ops.davidson import (
        davidson_ground_state as j_dav, op_diag_flat as j_diag)
    from dmft_lanc_ed_tpu.ops.matvec import matvec_flat as j_matvec
    sec, op, h, h_j = _sector_h()
    w_ref = np.linalg.eigvalsh(pt.dense_hamiltonian(h))
    e_dav, v_dav = davidson_ground_state(op, matvec_flat, sec.dim, 3,
                                         op_diag_flat(op), ncv=24, tol=1e-12)
    np.testing.assert_allclose(e_dav, w_ref[:3], atol=1e-9)
    e_lan, _ = lanczos_ground_state(op, matvec_flat, sec.dim, 3, ncv=24,
                                    tol=1e-12)
    np.testing.assert_allclose(e_dav, e_lan, atol=1e-9)
    e_j, _ = j_dav(h_j, j_matvec, sec.dim, 3, j_diag(h_j), ncv=24,
                   tol=1e-12)
    np.testing.assert_allclose(e_dav, e_j, atol=1e-9)
    for k in range(3):
        r = matvec_flat(op, torch.as_tensor(v_dav[k])).numpy() \
            - e_dav[k] * v_dav[k]
        assert np.linalg.norm(r) < 1e-8


def test_davidson_degenerate_ground_state():
    """A degenerate multiplet (two orbitals, Ust = U, Jh = 0): Davidson
    resolves the four lowest states, orthonormal."""
    sec, op, h, _ = _sector_h(norb=2, nbath=2, nup=2, ndw=2, seed=3, jh=0.0,
                              ust=2.0)
    w_ref = np.linalg.eigvalsh(pt.dense_hamiltonian(h))
    e_dav, v_dav = davidson_ground_state(op, matvec_flat, sec.dim, 4,
                                         op_diag_flat(op), ncv=28, tol=1e-11)
    np.testing.assert_allclose(e_dav, w_ref[:4], atol=1e-8)
    np.testing.assert_allclose(v_dav @ v_dav.T, np.eye(4), atol=1e-7)


def test_davidson_phonon_diagonal():
    """A phonon sector: the preconditioner carries the phonon ladder."""
    sec, op, h, _ = _sector_h(norb=1, nbath=3, nup=2, ndw=2, seed=1, nph=2,
                              g_ph=(0.3,), w0_ph=0.8)
    w_ref = np.linalg.eigvalsh(pt.dense_hamiltonian(h))
    e_dav, _ = davidson_ground_state(op, matvec_flat, sec.dim, 2,
                                     op_diag_flat(op), ncv=24, tol=1e-11)
    np.testing.assert_allclose(e_dav, w_ref[:2], atol=1e-8)


@pytest.mark.parametrize("case", ["normal", "jx_jp", "phonon"])
def test_op_diag_flat_every_backend(case):
    """op_diag_flat of the dense, ELL, direct and band-sparse ops is the
    Hamiltonian's diagonal."""
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import (
        blocksparse_applicable, build_blocksparse_op)
    from dmft_lanc_ed_tpu_torch.ops.dense import build_dense_op
    kw, sqn = CASES[case]
    cfg, _, hloc, e, v = _inputs(kw)
    sec = pt.SectorTable(cfg).sector(sqn)
    bath = pt.Bath(e=e, v=v)
    h = pt.build_sector_hamiltonian(cfg, sec, hloc, bath)
    ref = np.diagonal(pt.dense_hamiltonian(h))
    ops = [build_dense_op(cfg, sec, hloc, bath, "cpu"),
           build_ell_op(cfg, sec, hloc, bath, "cpu"),
           build_direct_op(cfg, sec, hloc, bath, "cpu")]
    if blocksparse_applicable(h):
        ops.append(build_blocksparse_op(h, "cpu"))
    assert len(ops) == (4 if case == "normal" else 3)
    for op in ops:
        np.testing.assert_allclose(op_diag_flat(op).numpy(), ref, rtol=0,
                                   atol=1e-12, err_msg=type(op).__name__)


def test_factory_dispatch_and_fallback(monkeypatch, caplog):
    """"auto" on the CPU is the stored ELL op, "direct" the matrix-free
    op; masks wider than the direct backend's fall back to ELL, logged."""
    cfg = pt.EDConfig(norb=1, nbath=3, uloc=(1.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(2, 2))
    hloc, bath = np.zeros((1, 1, 1, 1)), pt.init_bath(cfg)
    op, apply = pfac.make_sector_op(cfg, sec, hloc, bath, "cpu")
    assert isinstance(op, EllSectorOp) and apply is matvec_flat
    assert pfac.apply_is_exact(apply) and pfac.exact_apply(op) is None
    cfg_d = cfg.replace(ed_backend="direct")
    op, apply = pfac.make_sector_op(cfg_d, sec, hloc, bath, "cpu")
    assert isinstance(op, DirectSectorOp) and apply is matvec_direct_flat
    monkeypatch.setattr(pfac, "MASK_BITS", cfg.ns - 1)
    assert not pfac.direct_supported(cfg_d)
    with caplog.at_level(logging.WARNING, logger="dmft_lanc_ed_tpu_torch"):
        op, apply = pfac.make_sector_op(cfg_d, sec, hloc, bath, "cpu")
    assert isinstance(op, EllSectorOp)
    assert "falling back to stored ELL" in caplog.text
