"""PyTorch port, the dw-sharded sector solve (``dmft_lanc_ed_tpu_torch/
parallel``) on the CPU: real multi-rank runs over ``torch.distributed``
with the gloo transport, 2 or 4 ranks spawned by
``parallel.multihost.run_local_ranks`` (a free port per run, a deadline on
joining the ranks), held against the JAX package's sharded path on the
conftest's virtual CPU devices (Pallas in interpret mode) and against the
port's unsharded solve, from the same numpy inputs.

The rank functions below are module-level so that the spawned ranks can
import them; this module imports JAX only inside the tests that run in
the parent, so a rank never loads it.

Tolerances, each with its origin:
- halo strips, row all-gather, the sum over ranks: exact (the same
  numbers moved, added in rank order on every rank);
- B5's plain version vs the JAX kernel ``make_sharded_bs_matvec`` (split
  bf16 products), and the stitched shards vs the port's unsharded B1
  plain version (six-pass products summed in other orders): y within
  1e-5 x max|y|, the total sum of squares within 1e-5 relative, B1's
  contract at f32 fidelity; each shard of B5's plain version against the
  f64 product within 1e-6 x max|y| and 2x the true-f32 product's error;
- window starts and shard applicability: exact;
- the sharded band-sparse ground state (B5 stage, then the top-off over
  the sharded dense operator): |E - ARPACK| <= 1e-9, residual <= 1e-6 x
  max(1, |E|), the JAX test's gate (test_production_sharding.py:168-211);
  the ranks' results bit-identical;
- the sharded dense full solve: emin 1e-12, G(iw) 1e-9, Sigma(iw) 1e-7,
  dens/docc 1e-12, epot 1e-10, the JAX test's gates (:20-35);
- the dispatch: emin within 1e-9 of the serial solve (:214-239).
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.diag import DiagState, diagonalize_impurity
from dmft_lanc_ed_tpu_torch.ops import blocksparse as pbs
from dmft_lanc_ed_tpu_torch.parallel import bs_sharded as pbsh
from dmft_lanc_ed_tpu_torch.parallel import production as pprod
from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
from dmft_lanc_ed_tpu_torch.parallel.multihost import (allreduce_sites,
                                                       my_sites,
                                                       run_local_ranks)
from dmft_lanc_ed_tpu_torch.parallel.production import apply_counts

RANK_TIMEOUT = 240.0     # seconds; a hung rank fails the test


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sector_h(nbath, sqn):
    """Port config, sector and Hamiltonian of the one-orbital Bethe bath."""
    cfg = pt.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                    pt.init_bath(cfg))
    return cfg, sec, h


# --------------------------------------------------------------------------
# rank functions (run in spawned ranks: torch and the port only)
# --------------------------------------------------------------------------
def _mesh_rank(rank, n):
    torch.set_num_threads(1)
    mesh = make_mesh(n, "cpu")
    v = torch.arange(18, dtype=torch.float64).reshape(6, 3) + 100.0 * rank
    top, bottom = mesh.halo(v, 2)
    full = mesh.allgather_rows(v[None], dim=-2)[0]
    total = mesh.allreduce(torch.tensor([0.1 * (rank + 1), 1e-17 * rank],
                                        dtype=torch.float64))
    return top.numpy(), bottom.numpy(), full.numpy(), total.numpy(), \
        mesh.transport


def _padded_start(op, seed):
    v = np.random.default_rng(seed).standard_normal((op.dim_dw, op.dim_up))
    return pbs.to_padded(op, v / np.linalg.norm(v))


def _bs_ground_state_rank(rank):
    """One apply of the sharded matvec (halo exchange + B5 + the summed
    squares), then the sharded two-stage ground state."""
    torch.set_num_threads(1)
    cfg, _, h = _sector_h(10, (5, 5))
    op = pbs.build_blocksparse_op(h, "cpu")
    mesh = make_mesh(2, "cpu")
    apply, sop = pbsh.make_sharded_bs_matvec(op, mesh)
    rows = sop.shard.local
    y, ss = apply(_padded_start(op, 9)[rank * rows:(rank + 1) * rows])
    calls = []
    plain = pbsh._local_call_plain
    pbsh._local_call_plain = lambda *a: calls.append(1) or plain(*a)
    vals, vecs = pbsh.bs_sharded_ground_state(cfg, op, mesh, 1, ncv=32)
    return vals, vecs, len(calls), y.numpy(), float(ss)


def _solve_rank(rank, kw):
    torch.set_num_threads(1)
    cfg = pt.read_input(None, **kw)
    solver = pt.EDSolver(cfg, device="cpu")
    apply_counts["dense_sharded"] = 0
    r = solver.solve(solver.init_bath())
    return dict(emin=r.state_list.emin, g_mats=r.g_mats,
                sigma_mats=r.sigma_mats, dens=r.observables.dens,
                docc=r.observables.docc, epot=r.observables.epot,
                sharded_applies=apply_counts["dense_sharded"])


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _dispatch_rank(rank, kw):
    torch.set_num_threads(1)
    log = logging.getLogger("dmft_lanc_ed_tpu_torch")
    handler = _Messages()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    calls = []
    plain = pbsh._local_call_plain
    pbsh._local_call_plain = lambda *a: calls.append(1) or plain(*a)
    cfg = pt.read_input(None, mesh_shape=(2,), ed_shard_min_dimdw=2, **kw)
    states = diagonalize_impurity(cfg, pt.SectorTable(cfg),
                                  np.zeros((1,) * 4), pt.init_bath(cfg),
                                  DiagState(sector_hint=[pt.qn(5, 5)]),
                                  device="cpu")
    return handler.messages, len(calls), states.emin


def _sites_rank(rank):
    sites = list(my_sites(5))
    local = {i: np.full((2, 3), 10.0 * i + 1.0) for i in sites}
    return sites, allreduce_sites(local, 5, (2, 3))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
def test_halo_gather_and_sum_over_gloo_ranks(n):
    out = run_local_ranks(_mesh_rank, n, (n,), device="cpu",
                          timeout=RANK_TIMEOUT)
    blocks = [np.arange(18.0).reshape(6, 3) + 100.0 * d for d in range(n)]
    sums = [o[3] for o in out]
    expect = np.array([0.1, 0.0])
    for d in range(1, n):
        expect = expect + np.array([0.1 * (d + 1), 1e-17 * d])
    for d, (top, bottom, full, total, transport) in enumerate(out):
        assert transport == "gloo"
        np.testing.assert_array_equal(
            top, blocks[d - 1][-2:] if d > 0 else np.zeros((2, 3)))
        np.testing.assert_array_equal(
            bottom, blocks[d + 1][:2] if d < n - 1 else np.zeros((2, 3)))
        np.testing.assert_array_equal(full, np.concatenate(blocks))
        np.testing.assert_array_equal(total, expect)
        assert total.tobytes() == sums[0].tobytes()


def test_sites_round_robin_and_merge():
    out = run_local_ranks(_sites_rank, 2, device="cpu", timeout=RANK_TIMEOUT)
    assert [o[0] for o in out] == [[0, 2, 4], [1, 3]]
    expect = np.stack([np.full((2, 3), 10.0 * i + 1.0) for i in range(5)])
    for _, merged in out:
        np.testing.assert_array_equal(merged, expect)
    # one process: plain assembly
    np.testing.assert_array_equal(
        allreduce_sites({1: np.ones((2, 3))}, 3, (2, 3))[1], np.ones((2, 3)))
    assert list(my_sites(3)) == [0, 1, 2]


def _jax_and_port_ops(nbath, sqn):
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.ops import blocksparse as jbs
    from dmft_lanc_ed_tpu_torch.convert import hamiltonian_from_reference
    cfg = ed.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = ed.SectorTable(cfg).sector(ed.qn(*sqn))
    h_j = ed.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                      ed.init_bath(cfg))
    h_p = hamiltonian_from_reference(
        {f.name: getattr(h_j, f.name) for f in dataclasses.fields(h_j)})
    return h_j, h_p, jbs.build_blocksparse_op(h_j), \
        pbs.build_blocksparse_op(h_p, "cpu")


@pytest.mark.parametrize("nbath", [8, 9, 10, 11])
def test_window_starts_and_shardability_match_jax(nbath):
    from dmft_lanc_ed_tpu.parallel import bs_sharded as jbsh
    half = (nbath + 1) // 2
    h_j, h_p, jop, pop = _jax_and_port_ops(nbath, (half, half))
    ntd = pop.padded_shape[0] // 128
    for n in (2, 4, 8):
        ok = pbsh.bs_shard_applicable(pop, n)
        assert ok == jbsh.bs_shard_applicable(jop, n)
        why_p = pbsh.blocksparse_shardable(h_p, n)
        why_j = jbsh.blocksparse_shardable(h_j, n)
        assert why_p == why_j
        assert (why_p is None) == ok
        if not ok:
            continue
        t_glob = jbsh._window_tiles(jop)
        ntl = ntd // n
        t_jax = np.stack([t_glob[d * ntl:(d + 1) * ntl] - (d * ntl - jop.d_dw)
                          for d in range(n)])
        np.testing.assert_array_equal(pbsh.local_window_tiles(pop, n), t_jax)


def test_b5_plain_matches_jax_sharded_kernel():
    """nbath = 10, sector (5,5) (462 x 462, padded 512 x 512, W_dw = 384):
    the smallest sector B5 accepts, on 2 shards."""
    import jax.numpy as jnp
    from dmft_lanc_ed_tpu.parallel import bs_sharded as jbsh
    from dmft_lanc_ed_tpu.parallel.mesh import make_mesh as jax_mesh
    _, _, jop, pop = _jax_and_port_ops(10, (5, 5))
    rng = np.random.default_rng(5)
    v = rng.standard_normal((pop.dim_dw, pop.dim_up))
    vp = pbs.to_padded(pop, v / np.linalg.norm(v))
    apply, _ = jbsh.make_sharded_bs_matvec(jop, jax_mesh(2))
    y_j, ss_j = apply(jnp.asarray(vp.numpy()))
    y_j = np.asarray(y_j)
    ys, ss = [], 0.0
    for d in range(2):
        sh = pbsh.shard_bs_op(pop, 2, d, "cpu")
        assert not sh.plain        # the plain factors come with its call
        y_d, ss_d = pbsh._local_call(sh, *pbsh.shard_rows(vp, sh))
        assert sh.plain["hdw_ext"].shape == (sh.local, sh.ext)
        assert ss_d.shape == (sh.local // 128,)
        ys.append(y_d)
        ss += float(ss_d.double().sum())
    y = torch.cat(ys).numpy()
    ymax = np.abs(y_j).max()
    assert np.abs(y - y_j).max() <= 1e-5 * ymax
    assert abs(ss - float(ss_j)) <= 1e-5 * float(ss_j)
    y_b1, ss_b1 = pbs.matvec_bs_padded_plain(pop, vp, 1.0)
    assert np.abs(y - y_b1.numpy()).max() <= 1e-5 * ymax
    assert abs(ss - float(ss_b1.double().sum())) <= 1e-5 * ss
    assert pbsh.launch_counts["sharded_matvec"] == 0     # CPU: no kernel


def test_b5_plain_six_pass_at_f32_grade():
    """nbath = 10, (5,5) on 2 shards: each shard's plain B5 (six passes
    over the three-part splits) against the f64 product of its rows over
    the same f32 operator values, within 1e-6 x max|y| and within 2x the
    error of the true-f32 product of the same dense factors."""
    _, _, h = _sector_h(10, (5, 5))
    op = pbs.build_blocksparse_op(h, "cpu")
    vp = _padded_start(op, 10)
    for d in range(2):
        sh = pbsh.shard_bs_op(op, 2, d, "cpu")
        v_loc, v_ext = pbsh.shard_rows(vp, sh)
        y, _ = pbsh._local_call(sh, v_loc, v_ext)
        f = pbsh._plain_factors(sh)
        diag = sh.diag_a.double() @ sh.diag_b.double()
        ref = (diag * v_loc.double() + f["hdw_ext"].double() @ v_ext.double()
               + v_loc.double() @ f["hup"].double())
        y32 = ((sh.diag_a @ sh.diag_b) * v_loc + f["hdw_ext"] @ v_ext
               + v_loc @ f["hup"])
        top = float(ref.abs().max())
        e6 = float((y.double() - ref).abs().max())
        e32 = float((y32.double() - ref).abs().max())
        assert e6 <= 1e-6 * top and e6 <= 2 * e32


def test_bs_sharded_ground_state_two_ranks_matches_arpack():
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    out = run_local_ranks(_bs_ground_state_rank, 2, device="cpu",
                          timeout=RANK_TIMEOUT)
    (vals, vecs, calls, y0, ss0), (vals1, vecs1, calls1, y1, ss1) = out
    assert calls > 0 and calls1 == calls
    assert vals.tobytes() == vals1.tobytes()
    assert vecs.tobytes() == vecs1.tobytes()
    # the apply's halo'd shards and summed squares vs the unsharded B1
    _, sec, h = _sector_h(10, (5, 5))
    op = pbs.build_blocksparse_op(h, "cpu")
    y_b1, ss_b1 = pbs.matvec_bs_padded_plain(op.pop, _padded_start(op, 9),
                                             1.0)
    ymax = float(y_b1.abs().max())
    assert np.abs(np.concatenate([y0, y1]) - y_b1.numpy()).max() \
        <= 1e-5 * ymax
    ss_ref = float(ss_b1.double().sum())
    assert ss0 == ss1 and abs(ss0 - ss_ref) <= 1e-5 * ss_ref

    def factor_csr(cols, vals_, n):
        rows = np.repeat(np.arange(n), cols.shape[1])
        m = sp.csr_matrix((np.asarray(vals_, np.float64).ravel(),
                           (rows, np.asarray(cols).ravel())), shape=(n, n))
        m.eliminate_zeros()
        return m
    hfull = (sp.kron(sp.identity(sec.dim_dw, format="csr"),
                     factor_csr(h.up_cols, h.up_vals, sec.dim_up))
             + sp.kron(factor_csr(h.dw_cols, h.dw_vals, sec.dim_dw),
                       sp.identity(sec.dim_up, format="csr"))
             + sp.diags(np.asarray(h.diag, np.float64).ravel())).tocsr()
    e_ref = float(spl.eigsh(hfull, k=1, which="SA", tol=1e-12,
                            return_eigenvectors=False)[0])
    assert abs(vals[0] - e_ref) <= 1e-9
    r = hfull @ vecs[0] - vals[0] * vecs[0]
    assert np.linalg.norm(r) <= 1e-6 * max(1.0, abs(vals[0]))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dense_full_solve_matches_serial(n):
    import dmft_lanc_ed_tpu as ed
    kw = dict(norb=1, nbath=6, uloc=(2.2,), lanc_dim_threshold=16, lmats=32,
              lreal=8, ed_backend="dense")
    out = run_local_ranks(_solve_rank, n,
                          (dict(kw, mesh_shape=(n,), ed_shard_min_dimdw=n),),
                          device="cpu", timeout=RANK_TIMEOUT)
    serial = _solve_rank(0, kw)
    assert serial["sharded_applies"] == 0
    solver_j = ed.EDSolver(ed.read_input(None, **kw))
    r_j = solver_j.solve(solver_j.init_bath())
    ref_j = dict(emin=r_j.state_list.emin, g_mats=r_j.g_mats,
                 sigma_mats=r_j.sigma_mats, dens=r_j.observables.dens,
                 docc=r_j.observables.docc, epot=r_j.observables.epot)
    for res in out:
        assert res["sharded_applies"] > 0
        for ref in (serial, ref_j):
            assert abs(res["emin"] - ref["emin"]) < 1e-12
            np.testing.assert_allclose(res["g_mats"], ref["g_mats"],
                                       atol=1e-9)
            np.testing.assert_allclose(res["sigma_mats"], ref["sigma_mats"],
                                       atol=1e-7)
            np.testing.assert_allclose(res["dens"], ref["dens"], atol=1e-12)
            np.testing.assert_allclose(res["docc"], ref["docc"], atol=1e-12)
            assert abs(res["epot"] - ref["epot"]) < 1e-10
    for res in out[1:]:
        assert res["emin"] == out[0]["emin"]
        np.testing.assert_array_equal(res["g_mats"], out[0]["g_mats"])


def test_diag_dispatches_sharded_bs():
    kw = dict(norb=1, nbath=10, uloc=(2.0,), ed_backend="pallas",
              lanc_dim_threshold=1024, ed_sectors=True, ed_sectors_shift=0,
              ed_batch_sectors=False)
    out = run_local_ranks(_dispatch_rank, 2, (kw,), device="cpu",
                          timeout=RANK_TIMEOUT)
    cfg = pt.read_input(None, **kw)
    serial = diagonalize_impurity(cfg, pt.SectorTable(cfg), np.zeros((1,) * 4),
                                  pt.init_bath(cfg),
                                  DiagState(sector_hint=[pt.qn(5, 5)]),
                                  device="cpu")
    for messages, calls, emin in out:
        assert any("dw-sharded band-sparse fused solve" in m
                   for m in messages)
        assert calls > 0
        assert abs(emin - serial.emin) < 1e-9
    assert out[0][2] == out[1][2]


def test_mesh_shape_without_ranks_runs_unsharded(caplog):
    """solver_mesh keeps the JAX semantics: fewer ranks than mesh_shape
    asks for logs a warning and solves unsharded."""
    kw = dict(norb=1, nbath=3, uloc=(2.0,), lanc_dim_threshold=4,
              ed_backend="dense", lmats=16, lreal=4)
    cfg = pt.read_input(None, **kw)
    solver = pt.EDSolver(cfg.replace(mesh_shape=(2,)), device="cpu")
    with caplog.at_level(logging.WARNING, logger="dmft_lanc_ed_tpu_torch"):
        r = solver.solve(solver.init_bath())
    assert any("running unsharded" in rec.getMessage()
               for rec in caplog.records)
    ref = pt.EDSolver(cfg, device="cpu")
    assert r.state_list.emin == ref.solve(ref.init_bath()).state_list.emin


def test_mesh_shape_with_more_ranks_raises(monkeypatch):
    """More ranks running than mesh_shape asks for: a rank outside the mesh
    would hold no shard, so solver_mesh refuses (the JAX package's
    sub-mesh has no counterpart in one process per rank)."""
    cfg = pt.read_input(None, norb=1, nbath=3, uloc=(2.0,), mesh_shape=(2,))
    monkeypatch.setattr(pprod, "process_info", lambda: (0, 4))
    with pytest.raises(ValueError, match="requests 2 ranks but 4 are "
                                         "running: launch 2 ranks"):
        pprod.solver_mesh(cfg, "cpu")
    monkeypatch.setattr(pprod, "process_info", lambda: (0, 1))
    assert pprod.solver_mesh(cfg, "cpu") is None


def _entry_points():
    from dmft_lanc_ed_tpu_torch.gf import HCache
    from dmft_lanc_ed_tpu_torch.models.hm_bethe import main, run_dmft
    cfg = pt.read_input(None, norb=1, nbath=2, uloc=(2.0,), nloop=1)
    table = pt.SectorTable(cfg)
    hloc = np.zeros((1,) * 4)
    return {
        "EDSolver": lambda: pt.EDSolver(cfg),
        "run_dmft": lambda: run_dmft(cfg, verbose=False),
        "cli": lambda: main(["nbath=2", "nloop=1"]),
        "diagonalize_impurity": lambda: diagonalize_impurity(
            cfg, table, hloc, pt.init_bath(cfg)),
        "HCache": lambda: HCache(cfg, table, hloc, pt.init_bath(cfg)),
    }


@pytest.mark.parametrize("entry", ["EDSolver", "run_dmft", "cli",
                                   "diagonalize_impurity", "HCache"])
def test_entry_points_need_the_card_by_default(entry, monkeypatch):
    """The entry points default to device="cuda"; without a card they
    raise, naming device="cpu", instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points()[entry]()
