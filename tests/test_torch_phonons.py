"""PyTorch port, the phonon, e-ph and Jx/Jp terms of the dense operator
(``ops/dense.py``, ``ops/batched.py``) and the solves that run them,
against the JAX package on the CPU.

Tolerances, each with its origin:
- the f64 dense apply against the JAX package's ``matvec_dense_flat`` and
  against ``dense_hamiltonian`` @ v: 1e-12 x max|Hv| (both f64 on the
  same factors, summed in another order);
- the mixed apply against the f64 one: 1e-6 x max|Hv|, the dense-mixed
  matvec contract (~1e-7 relative, ROADMAP north star);
- a stacked bucket op against each element alone: bit for bit, the pad
  block exactly zero (the same products, batched); the padded op's
  physical block against the unpadded op: 1e-14 x max|Hv| in f64, the
  mixed contract's 1e-6 x max|Hv| in f32 (BLAS blocks another length);
- solves against the JAX package's on the same bath: Egs 1e-9, dens 1e-8,
  G(iw) 1e-7 (test_features.py:test_batched_scan_finite_t_and_phonons) and
  the JAX tests' own bars where a test mirrors one
  (test_phonon_solver.py:test_holstein_lanc_vs_full: Egs 1e-9, dens 1e-6,
  G 1e-5; test_chi.py:test_phonon_gf_full_ed_vs_lanc: D 1e-8);
- a mixed-precision solve (f32 products, f64 polish) against the JAX
  package's f64 one: Egs 1e-10 (the polish), G(iw) 1e-6 (the mixed scan).
"""
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.ops import batched as jbt
from dmft_lanc_ed_tpu.ops import dense as jdense
from dmft_lanc_ed_tpu_torch.ops import batched as bt
from dmft_lanc_ed_tpu_torch.ops import dense as pdense
from dmft_lanc_ed_tpu_torch.solver import bosonic_grid, real_grid


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread keep parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# name -> (config kwargs, sector); the JAX package's test models
OPS = {
    # test_phonon_solver.py's Holstein impurity at nbath = 2
    "holstein": (dict(norb=1, nbath=2, uloc=(1.0,), nph=3, g_ph=(0.4,),
                      w0_ph=0.7), ((1,), (2,))),
    # test_chi.py:test_chi_oracle_two_orbital_mixed's Jx/Jp
    "jxjp": (dict(norb=2, nbath=1, uloc=(1.5, 1.5), ust=0.7, jh=0.2,
                  jx=0.3, jp=0.2), ((2,), (2,))),
    # both at once
    "holstein-jxjp": (dict(norb=2, nbath=1, uloc=(1.5, 1.5), ust=0.7,
                           jh=0.2, jx=0.3, jp=0.2, nph=2, g_ph=(0.3, 0.2),
                           w0_ph=0.8), ((2,), (1,))),
}


def _ops(name):
    """(port op on the CPU, JAX op, port SectorHamiltonian) of the case's
    sector at the default bath."""
    kw, sqn = OPS[name]
    cfg_p, cfg_j = pt.EDConfig(**kw), ed.EDConfig(**kw)
    hloc = np.zeros((1, 1, cfg_p.norb, cfg_p.norb))
    sec_p = pt.SectorTable(cfg_p).sector(sqn)
    sec_j = ed.SectorTable(cfg_j).sector(sqn)
    h = pt.build_sector_hamiltonian(cfg_p, sec_p, hloc, pt.init_bath(cfg_p))
    op_j = jdense.build_dense_op(cfg_j, sec_j, hloc, ed.init_bath(cfg_j))
    return pdense.densify(h, "cpu"), op_j, h


def _vecs(op, n, seed=3):
    return np.random.default_rng(seed).standard_normal((n, op.dim))


@pytest.mark.parametrize("name", list(OPS))
def test_dense_apply_matches_reference(name):
    op, op_j, h = _ops(name)
    has_ph = "holstein" in name
    assert (op.ph_diag is not None) == has_ph
    assert (op.nd_a is not None) == ("jxjp" in name)
    assert op.dim == h.dim and op.vshape[-2:] == (h.dim_dw, h.dim_up)
    v = _vecs(op, 3)
    y = pdense.matvec_dense_flat(op, torch.as_tensor(v)).numpy()
    want = np.stack([np.asarray(jdense.matvec_dense_flat(op_j, x))
                     for x in v])
    scale = np.abs(want).max()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-12 * scale)
    hd = pt.dense_hamiltonian(h)
    np.testing.assert_allclose(y, v @ hd.T, rtol=0, atol=1e-12 * scale)
    # the natural-shape apply of one vector equals the flat batch's row
    y0 = pdense.matvec_dense(op, torch.as_tensor(v[0]).reshape(op.vshape))
    assert torch.equal(y0.reshape(-1), torch.as_tensor(y[0]))


@pytest.mark.parametrize("name", list(OPS))
def test_dense_mixed_apply_contract(name):
    op, op_j, _ = _ops(name)
    v = torch.as_tensor(_vecs(op, 2, seed=4))
    y64 = pdense.matvec_dense_flat(op, v)
    y32 = pdense.matvec_dense_mixed_flat(op, v)
    assert y32.dtype == torch.float64
    err = float((y32 - y64).abs().max() / y64.abs().max())
    assert 0 < err <= 1e-6, err
    want = np.asarray(jdense.matvec_dense_mixed_flat(op_j, v[0].numpy()))
    np.testing.assert_allclose(y32[0].numpy(), want, rtol=0,
                               atol=1e-6 * float(y64.abs().max()))


@pytest.mark.parametrize("name", list(OPS))
def test_bucket_op_padding_and_stack(name):
    """A stacked, padded bucket of two ops applies each element as alone;
    the bucket key is the JAX package's (DimPh and the term count in it)."""
    op, op_j, _ = _ops(name)
    key = bt.bucket_key(op)
    assert key == jbt.bucket_key(op_j)
    du_p, dd_p = key[0], key[1]
    assert key[2] == op.dim_ph and key[3] == (
        0 if op.nd_a is None else op.nd_a.shape[0])
    padded = bt.pad_dense_op_2d(op, du_p, dd_p)
    assert padded.dim_ph == op.dim_ph and padded.vshape[-2:] == (dd_p, du_p)
    v = _vecs(op, 2, seed=5)
    vp = np.stack([bt._pad_vec(x, op, du_p, dd_p) for x in v])
    stacked = bt.stack_ops([padded, padded])
    for apply, tol in ((pdense.matvec_dense, 1e-14),
                       (pdense.matvec_dense_mixed, 1e-6)):
        y_b = apply(stacked, torch.as_tensor(vp))
        for i in range(2):
            y_i = apply(padded, torch.as_tensor(vp[i]))
            assert torch.equal(y_b[i], y_i)
            assert torch.all(y_i[..., op.dim_dw:, :] == 0)
            assert torch.all(y_i[..., :, op.dim_up:] == 0)
            y_n = apply(op, torch.as_tensor(v[i]).reshape(op.vshape))
            np.testing.assert_allclose(
                y_i[..., :op.dim_dw, :op.dim_up].numpy(), y_n.numpy(),
                rtol=0, atol=tol * float(y_n.abs().max()))
    sliced = bt._slice_op(stacked, 1)
    assert all((getattr(sliced, f) is None) == (getattr(padded, f) is None)
               for f in bt._OP_FIELDS)


def test_sharded_phonon_and_jxjp_sectors_raise():
    """dw-sharded phonon and Jx/Jp sectors build (ROADMAP A10): this
    rank's rows of the padded factors, the phonon axis whole. Only the
    ELL oracle ShardedLanczos still raises on phonons, with the JAX
    package's message."""
    from dmft_lanc_ed_tpu_torch.parallel.matvec import ShardedLanczos
    from dmft_lanc_ed_tpu_torch.parallel.production import shard_sector_op
    mesh = types.SimpleNamespace(device=torch.device("cpu"), size=2, rank=0)
    for name in ("holstein", "jxjp"):
        kw, sqn = OPS[name]
        cfg = pt.EDConfig(**kw, ed_backend="dense")
        sec = pt.SectorTable(cfg).sector(sqn)
        hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
        sop = shard_sector_op(cfg, sec, hloc, pt.init_bath(cfg), None, mesh)
        ddp = sop.vshape[-2]
        assert ddp % 2 == 0 and sop.local_shape[-2] == ddp // 2
        if name == "holstein":
            assert sop.local_shape[0] == cfg.dim_ph
            assert sop.op.eph_el.shape == (ddp // 2, sec.dim_up)
            with pytest.raises(NotImplementedError,
                               match="phonon sectors use the replicated"):
                ShardedLanczos(pt.build_sector_hamiltonian(
                    cfg, sec, hloc, pt.init_bath(cfg)), mesh)
        else:
            assert sop.op.nd_b.shape[1:] == (ddp // 2, ddp)


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------
def _pair(kw, port_kw=None, ref_kw=None, hloc=None):
    """(port result, JAX result) of one solve of the default bath."""
    cfg_p = pt.EDConfig(**kw, **(port_kw or {}))
    cfg_j = ed.EDConfig(**kw, **(ref_kw or {}))
    hloc = np.zeros((1, 1, cfg_p.norb, cfg_p.norb)) if hloc is None else hloc
    sj = ed.EDSolver(cfg_j, hloc)
    bath = sj.init_bath()
    return (pt.EDSolver(cfg_p, hloc, device="cpu").solve(bath),
            sj.solve(bath))


def _assert_solves_close(rp, rj, e_tol=1e-9, dens_tol=1e-8, g_tol=1e-7):
    assert abs(rp.state_list.emin - rj.state_list.emin) < e_tol
    np.testing.assert_allclose(rp.observables.dens, rj.observables.dens,
                               atol=dens_tol)
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=g_tol)


# test_features.py:test_batched_scan_finite_t_and_phonons
BATCHED = dict(norb=1, nbath=3, uloc=(1.2,), nph=2, g_ph=(0.3,), w0_ph=0.8,
               beta=8.0, lmats=16, lreal=9, ed_finite_temp=True,
               lanc_nstates_total=30, lanc_nstates_sector=4,
               lanc_dim_threshold=10, ed_backend="dense")


@pytest.mark.parametrize("batched", [True, False])
def test_batched_scan_finite_t_and_phonons(batched):
    """Batched buckets at finite T and phonon blocks: the port's batched
    and serial solves each against the JAX package's, and the batched
    one against the port's serial one (the JAX test's gates)."""
    bt.reset_bucket_counts()
    kw = dict(BATCHED, ed_batch_sectors=batched)
    rp, rj = _pair(kw)
    assert (bt.bucket_counts["buckets"] > 0) == batched
    if batched:
        assert bt.bucket_counts["unconverged"] == 0
    _assert_solves_close(rp, rj)
    assert rp.gf_phonon is not None
    if batched:
        rs, _ = _pair(dict(BATCHED, ed_batch_sectors=False))
        _assert_solves_close(rp, rs)


# test_phonon_solver.py:test_holstein_lanc_vs_full
HOLSTEIN = dict(norb=1, nbath=1, uloc=(1.0,), nph=3, g_ph=(0.4,), w0_ph=0.7,
                beta=100.0, lmats=64, lreal=20, lanc_dim_threshold=4096)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_holstein_lanc_vs_full(backend):
    """The Krylov solve against full ED within the port (the JAX test's
    gates), each against the JAX package's; the band-sparse backend falls
    back to the dense operator on phonon sectors."""
    lanc = dict(HOLSTEIN, lanc_dim_threshold=4)     # Krylov sectors
    rl, rl_j = _pair(lanc, dict(ed_backend=backend))
    full = dict(HOLSTEIN, ed_diag_type="full", ed_finite_temp=True,
                lanc_nstates_total=4096)
    rf, rf_j = _pair(full, dict(ed_backend=backend))
    assert abs(rl.observables.egs - rf.observables.egs) < 1e-9
    assert abs(rl.observables.dens[0] - rf.observables.dens[0]) < 1e-6
    np.testing.assert_allclose(rl.g_mats[0, 0, 0, 0], rf.g_mats[0, 0, 0, 0],
                               atol=1e-5)
    assert abs(rl.observables.ph_occ.sum() - 1.0) < 1e-8
    dx = rl.observables.x_grid[1] - rl.observables.x_grid[0]
    assert abs(rl.observables.x_prob.sum() * dx - 1.0) < 0.05
    for got, want in ((rl, rl_j), (rf, rf_j)):
        _assert_solves_close(got, want, g_tol=1e-10)
        np.testing.assert_allclose(got.observables.ph_occ,
                                   want.observables.ph_occ, atol=1e-10)
        np.testing.assert_allclose(got.observables.x_prob,
                                   want.observables.x_prob, atol=1e-10)
    cfg = pt.EDConfig(**HOLSTEIN)
    vm, wr = bosonic_grid(cfg), real_grid(cfg)
    for got, want in ((rl.gf_phonon, rl_j.gf_phonon),
                      (rf.gf_phonon, rf_j.gf_phonon)):
        np.testing.assert_allclose(got.matsubara(cfg.beta, vm),
                                   want.matsubara(cfg.beta, vm), atol=1e-10)
        np.testing.assert_allclose(got.realaxis(cfg.beta, wr, cfg.eps),
                                   want.realaxis(cfg.beta, wr, cfg.eps),
                                   atol=1e-9)


def test_phonon_gf_full_ed_vs_lanc():
    """test_chi.py:test_phonon_gf_full_ed_vs_lanc within the port."""
    base = dict(norb=1, nbath=1, uloc=(1.0,), nph=3, g_ph=(0.4,),
                w0_ph=0.7, beta=20.0, lmats=16, lreal=11, wini=0.0,
                wfin=3.0, ed_finite_temp=True, lanc_nstates_total=4096,
                lanc_nstates_sector=4096, ed_backend="dense")
    cfg_l = pt.EDConfig(lanc_dim_threshold=4096, **base)
    cfg_f = pt.EDConfig(ed_diag_type="full", **base)
    bath = pt.EDSolver(cfg_l, device="cpu").init_bath()
    res_l = pt.EDSolver(cfg_l, device="cpu").solve(bath)
    res_f = pt.EDSolver(cfg_f, device="cpu").solve(bath)
    vm, wr = bosonic_grid(cfg_l), real_grid(cfg_l)
    np.testing.assert_allclose(res_l.gf_phonon.matsubara(cfg_l.beta, vm),
                               res_f.gf_phonon.matsubara(cfg_l.beta, vm),
                               atol=1e-8)
    np.testing.assert_allclose(
        res_l.gf_phonon.realaxis(cfg_l.beta, wr, cfg_l.eps),
        res_f.gf_phonon.realaxis(cfg_l.beta, wr, cfg_l.eps), atol=1e-8)


# a two-orbital Kanamori impurity with Jx/Jp and phonons at T = 0, every
# sector Krylov: buckets of the Jx/Jp and phonon terms, the GF and chi
# chains over them
JXJP = dict(norb=2, nbath=1, uloc=(2.0, 2.0), ust=1.0, jh=0.5, jx=0.5,
            jp=0.5, nph=2, g_ph=(0.2, 0.2), w0_ph=0.9, beta=50.0, lmats=32,
            lreal=9, lanc_dim_threshold=8, chispin_flag=True,
            ed_backend="dense")


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_jxjp_phonon_solve_matches_reference(precision):
    bt.reset_bucket_counts()
    rp, rj = _pair(dict(JXJP, ed_precision=precision))
    assert bt.bucket_counts["buckets"] > 0
    if precision == "f64":
        _assert_solves_close(rp, rj, e_tol=1e-10, g_tol=1e-8)
    else:
        _assert_solves_close(rp, rj, e_tol=1e-10, dens_tol=1e-6,
                             g_tol=1e-6)
    cfg = pt.EDConfig(**JXJP)
    vm = bosonic_grid(cfg)
    tol = 1e-8 if precision == "f64" else 1e-6
    for k, want in rj.chi_spin.items():
        np.testing.assert_allclose(rp.chi_spin[k].matsubara(cfg.beta, vm),
                                   want.matsubara(cfg.beta, vm), atol=tol)
