"""PyTorch port, the rest of the dw-sharded production solve (ROADMAP
A10): sharded phonon and Jx/Jp sectors over the dense operator, and the
sharded direct (matrix-free) backend, ``parallel/production.py``, on the
CPU. Ranks are spawned by ``parallel.multihost.run_local_ranks`` under
gloo (2 or 4); every result is held against the port's one-rank result
and against the JAX package's sharded result on the conftest's virtual
CPU devices, from the same numpy inputs. The rank functions are
module-level and this module imports JAX only in the parent's tests.

Tolerances, the JAX tests' own (tests/test_production_sharding.py):
- applies: the sharded direct apply against the serial direct apply and
  the sharded dense apply, 1e-12 (:124-127), pad rows exactly 0 (:129);
  the sharded mixed dense apply on a Jx/Jp sector against the f64 apply,
  1e-6 x max|Hv| (the dense-mixed contract, tests/test_torch_phonons.py);
- full solves: emin 1e-12, G(iw) 1e-9 (1e-8 with Jx/Jp), dens 1e-12
  (:20-35, :41-52, :66-76, :157-170); the phonon GF 1e-9 like G;
- the ranks' results bit-identical (the same sums in rank order).
"""
import logging

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.ops.dense import build_dense_op
from dmft_lanc_ed_tpu_torch.ops.direct import apply_direct, build_direct_op
from dmft_lanc_ed_tpu_torch.parallel import production as pprod
from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
from dmft_lanc_ed_tpu_torch.parallel.multihost import run_local_ranks
from dmft_lanc_ed_tpu_torch.solver import bosonic_grid

RANK_TIMEOUT = 240.0     # seconds; a hung rank fails the test

# name -> (config kwargs, sector): the applies' sectors
APPLY = {
    # tests/test_production_sharding.py:86-88: 126 x 126
    "bethe8": (dict(norb=1, nbath=8, uloc=(2.0,)), (4, 5)),
    # a Holstein impurity: 3 phonon blocks of 10 x 10
    "holstein": (dict(norb=1, nbath=4, uloc=(2.0,), nph=2, g_ph=(0.35,),
                      w0_ph=1.0), (2, 3)),
    # Jx/Jp and phonons together: 3 blocks of 15 x 20
    "jxjp-ph": (dict(norb=2, nbath=2, uloc=(1.6, 1.6), ust=0.7, jh=0.15,
                     jx=0.15, jp=0.15, nph=2, g_ph=(0.2, 0.1), w0_ph=0.9),
                (2, 3)),
}
# the full solves: the JAX tests' models at their dials, and the least
# dim_dw a sharded sector has (their largest sectors, which hold the
# ground state and the GF targets; the rest are solved on one rank, which
# the gloo round trips of a few-state sector would only slow)
SOLVES = {
    "phonons": (dict(norb=1, nbath=4, uloc=(2.0,), nph=2, g_ph=(0.35,),
                     w0_ph=1.0, lanc_dim_threshold=16, lmats=32, lreal=8),
                10),
    "jxjp": (dict(norb=2, nbath=2, uloc=(1.6, 1.6), ust=0.7, jh=0.15,
                  jx=0.15, jp=0.15, lanc_dim_threshold=8, lmats=24, lreal=8),
             20),
    "direct": (dict(norb=1, nbath=5, uloc=(2.2,), lanc_dim_threshold=16,
                    lmats=32, lreal=8, ed_backend="direct"), 20),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    kw, sqn = APPLY[name]
    cfg = pt.read_input(None, **kw)
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    v = np.random.default_rng(3).standard_normal(sec.dim)
    return cfg, sec, hloc, pt.init_bath(cfg), v


# --------------------------------------------------------------------------
# rank functions (run in spawned ranks: torch and the port only)
# --------------------------------------------------------------------------
def _apply_rank(rank, n):
    """Every APPLY sector: the sharded direct, dense f64 and dense mixed
    applies of one vector (whole logical outputs and this rank's padded
    rows), and the direct op's payload."""
    torch.set_num_threads(1)
    mesh = make_mesh(n, "cpu")
    out = {}
    for name in APPLY:
        cfg, sec, hloc, bath, v = _inputs(name)
        res = {}
        for kind in ("direct", "dense"):
            build = build_direct_op if kind == "direct" else build_dense_op
            shard = (pprod.shard_direct_op if kind == "direct"
                     else pprod.shard_dense_op)
            sop = shard(build(cfg, sec, hloc, bath, "cpu"), mesh, cfg)
            vp = sop.pad_flat(v)
            applies = {kind: sop.exact_nd}
            if kind == "dense":
                applies["mixed"] = pprod.matvec_dense_sharded_mixed
            for key, apply in applies.items():
                y = apply(sop, vp)
                res[key] = (sop.unpad_gather(y[None])[0], y.numpy())
            if kind == "direct":
                res["payload"] = sop.op.nbytes
                res["dim_dw"] = (sop.dim_dw, sop.vshape[-2])
        out[name] = res
    out["counts"] = dict(pprod.apply_counts)
    return out


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _solve(kw):
    cfg = pt.read_input(None, **kw)
    solver = pt.EDSolver(cfg, device="cpu")
    pprod.reset_apply_counts()
    r = solver.solve(solver.init_bath())
    out = dict(emin=r.state_list.emin, g_mats=r.g_mats,
               dens=r.observables.dens, counts=dict(pprod.apply_counts),
               gf_phonon=None)
    if r.gf_phonon is not None:
        out["gf_phonon"] = r.gf_phonon.matsubara(cfg.beta, bosonic_grid(cfg))
    return out


def _solve_rank(rank, kw):
    torch.set_num_threads(1)
    log = logging.getLogger("dmft_lanc_ed_tpu_torch")
    handler = _Messages()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    out = _solve(kw)
    out["messages"] = handler.messages
    return out


# --------------------------------------------------------------------------
# the applies
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def applies():
    """Each rank count's spawned applies: {n: [rank results]}."""
    return {n: run_local_ranks(_apply_rank, n, (n,), device="cpu",
                               timeout=RANK_TIMEOUT) for n in (2, 4)}


def _jax_direct_sharded(name, n, v):
    """The JAX package's sharded direct apply of v on n virtual devices."""
    import jax
    import jax.numpy as jnp
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.ops.direct import build_direct_op as jbuild
    from dmft_lanc_ed_tpu.parallel.mesh import make_mesh as jmesh
    from dmft_lanc_ed_tpu.parallel.production import shard_direct_op
    kw, sqn = APPLY[name]
    cfg = ed.read_input(None, **kw)
    sec = ed.SectorTable(cfg).sector(ed.qn(*sqn))
    sop = shard_direct_op(jbuild(cfg, sec, np.zeros((1, 1, cfg.norb,
                                                     cfg.norb)),
                                 ed.init_bath(cfg)), jmesh(n), cfg)
    vp = sop.pad_flat(jnp.asarray(v))
    return sop.unpad_flat(jax.jit(sop.apply_nd)(sop.op, vp))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(APPLY))
def test_sharded_direct_apply_equals_dense_and_serial(applies, name, n):
    """apply_direct_sharded == the sharded dense apply == the serial direct
    apply == the JAX package's sharded direct apply; pad rows exactly 0;
    the ranks' outputs identical."""
    cfg, sec, hloc, bath, v = _inputs(name)
    out = applies[n]
    res = out[0][name]
    dop = build_direct_op(cfg, sec, hloc, bath, "cpu")
    y_ser = apply_direct(dop, torch.as_tensor(v).reshape(dop.vshape)
                         ).reshape(-1).numpy()
    np.testing.assert_allclose(res["direct"][0], y_ser, atol=1e-12)
    np.testing.assert_allclose(res["direct"][0], res["dense"][0], atol=1e-12)
    np.testing.assert_allclose(res["direct"][0],
                               _jax_direct_sharded(name, n, v), atol=1e-12)
    dd, ddp = res["dim_dw"]
    assert ddp % n == 0 and ddp - dd < n
    rows = ddp // n
    for r, o in enumerate(out):
        for kind in ("direct", "dense"):
            y = o[name][kind][1]
            pad = np.arange(r * rows, (r + 1) * rows) >= dd
            assert np.all(y[..., pad, :] == 0.0)
            assert o[name][kind][0].tobytes() == res[kind][0].tobytes()
    assert all(o["counts"]["direct_sharded"] == len(APPLY) for o in out)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_direct_payload_under_half_the_dense_hdw(applies, n):
    """The direct op's per-rank bytes against the dense dw factor's at
    the 126 x 126 sector, the JAX slow test's bound
    (test_production_sharding.py:152-156; its masks and term lists are
    O(dim_dw + dim_up), the factor dim_dw^2)."""
    _, sec, _, _, _ = _inputs("bethe8")
    for o in applies[n]:
        assert o["bethe8"]["payload"] < sec.dim_dw ** 2 * 8 / 2


@pytest.mark.parametrize("name", ["jxjp-ph", "holstein"])
def test_sharded_mixed_dense_apply(applies, name):
    """The mixed (true-f32 products) sharded dense apply on a Jx/Jp and a
    phonon sector against the f64 one and against the JAX package's
    unsharded mixed apply, 1e-6 x max|Hv|; the pad rows exactly 0."""
    import jax.numpy as jnp
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.ops.dense import (build_dense_op as jbuild,
                                            matvec_dense_mixed_flat)
    kw, sqn = APPLY[name]
    cfg = ed.read_input(None, **kw)
    sec = ed.SectorTable(cfg).sector(ed.qn(*sqn))
    jop = jbuild(cfg, sec, np.zeros((1, 1, cfg.norb, cfg.norb)),
                 ed.init_bath(cfg))
    _, _, _, _, v = _inputs(name)
    y_j = np.asarray(matvec_dense_mixed_flat(jop, jnp.asarray(v)))
    for n in (2, 4):
        res = applies[n][0][name]
        scale = np.abs(res["dense"][0]).max()
        assert np.abs(res["mixed"][0] - res["dense"][0]).max() <= 1e-6 * scale
        assert np.abs(res["mixed"][0] - y_j).max() <= 1e-6 * scale
        assert res["mixed"][0].tobytes() == \
            applies[n][1][name]["mixed"][0].tobytes()


def test_pad_direct_op_pads_like_the_jax_package():
    """The dw padding (rows, the diagonal's shift, the bilinear factor's
    zero rows) equals the JAX package's; the pad masks sort above every
    real mask and no hop accepts them."""
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.ops.direct import build_direct_op as jbuild
    from dmft_lanc_ed_tpu.parallel.production import pad_direct_op as jpad
    from dmft_lanc_ed_tpu_torch.ops.direct import _row_gather_maps
    for name in APPLY:
        kw, sqn = APPLY[name]
        cfg, sec, hloc, bath, _ = _inputs(name)
        cfg_j = ed.read_input(None, **kw)
        jop = jbuild(cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(*sqn)), hloc,
                     ed.init_bath(cfg_j))
        for n in (4, 8):
            p = pprod.pad_direct_op(build_direct_op(cfg, sec, hloc, bath,
                                                    "cpu"), n)
            j = jpad(jop, n)
            assert p.dim_dw == j.dim_dw
            np.testing.assert_array_equal(p.diag_dw.numpy(),
                                          np.asarray(j.diag_dw))
            np.testing.assert_array_equal(p.diag_a.numpy(),
                                          np.asarray(j.diag_a))
            dd = sec.dim_dw
            np.testing.assert_array_equal(p.states_dw[:dd].numpy(),
                                          np.asarray(j.states_dw[:dd]))
            assert torch.all(p.states_dw[dd:] == pprod.PAD_MASK)
            assert torch.all(p.states_dw[:dd] < pprod.PAD_MASK)
            _, w = _row_gather_maps(p.states_dw, p.dw_c, p.dw_d)
            assert torch.all(w[:, dd:] == 0)


# --------------------------------------------------------------------------
# full solves
# --------------------------------------------------------------------------
def _jax_solve(kw):
    import dmft_lanc_ed_tpu as ed
    cfg = ed.read_input(None, **kw)
    solver = ed.EDSolver(cfg)
    r = solver.solve(solver.init_bath())
    out = dict(emin=r.state_list.emin, g_mats=r.g_mats,
               dens=r.observables.dens, gf_phonon=None)
    if r.gf_phonon is not None:
        out["gf_phonon"] = r.gf_phonon.matsubara(
            cfg.beta, bosonic_grid(pt.read_input(None, **kw)))
    return out


@pytest.mark.parametrize("name,n", [("phonons", 2), ("jxjp", 2),
                                    ("direct", 2)])
def test_sharded_full_solve_matches_serial_and_jax(name, n):
    """A full solve with mesh_shape=(n,) over n gloo ranks against the
    port's one-rank solve and the JAX package's sharded solve on n
    virtual devices: the phonon sectors, the Jx/Jp sectors and the direct
    backend sharded (the JAX tests test_full_solve_sharded_phonons,
    test_sharded_jxjp_sector, test_full_solve_sharded_direct_backend)."""
    kw, min_dimdw = SOLVES[name]
    mesh = dict(mesh_shape=(n,), ed_shard_min_dimdw=min_dimdw)
    out = run_local_ranks(_solve_rank, n, (dict(kw, **mesh),), device="cpu",
                          timeout=RANK_TIMEOUT)
    serial = _solve(kw)
    assert sum(serial["counts"].values()) == 0
    ref_j = _jax_solve(dict(kw, **mesh))
    g_tol = 1e-8 if name == "jxjp" else 1e-9
    backend = "direct" if name == "direct" else "dense"
    for res in out:
        assert res["counts"][f"{backend}_sharded"] > 0
        assert res["counts"]["gf_chains"] > 0
        assert any(f"sharded {backend} backend on {n} ranks" in m
                   for m in res["messages"])
        for ref in (serial, ref_j):
            assert abs(res["emin"] - ref["emin"]) < 1e-12
            np.testing.assert_allclose(res["g_mats"], ref["g_mats"],
                                       atol=g_tol)
            np.testing.assert_allclose(res["dens"], ref["dens"], atol=1e-12)
            if name == "phonons":
                np.testing.assert_allclose(res["gf_phonon"],
                                           ref["gf_phonon"], atol=1e-9)
            else:
                assert res["gf_phonon"] is None and ref["gf_phonon"] is None
    for res in out[1:]:
        assert res["emin"] == out[0]["emin"]
        np.testing.assert_array_equal(res["g_mats"], out[0]["g_mats"])
