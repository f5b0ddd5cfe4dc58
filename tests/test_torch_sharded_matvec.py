"""PyTorch port, the sharded ELL matvec and Lanczos (``parallel/matvec.py``)
and the dw-row / up-column transposes of ``parallel/mesh.DwMesh`` on the
CPU: 2 and 4 gloo ranks spawned by ``parallel.multihost.run_local_ranks``
(once per rank count, for every test of that count), held against the
port's serial ELL apply and Lanczos and against the JAX package's
``ShardedLanczos`` on the conftest's virtual CPU devices, from the same
numpy inputs (tests/test_parallel.py's models). The rank functions are
module-level and this module imports JAX only in the parent's tests.

Tolerances, the JAX tests' own (tests/test_parallel.py):
- the transposes: exact (the same numbers moved);
- the sharded matvec, Jx/Jp terms included, against the serial one:
  1e-13 (:46, :62); the ranks' rows stitched, the pad rows and columns
  exactly 0;
- the tridiagonal of 30 steps: 1e-10 (:78-79), the same bits on every
  rank;
- the padded region: exactly invariant, the physical block 1e-13
  (:82-97).
"""
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.ops.lanczos import lanczos_tridiag
from dmft_lanc_ed_tpu_torch.ops.matvec import apply_h, ell_op, matvec_flat
from dmft_lanc_ed_tpu_torch.parallel import ShardedLanczos
from dmft_lanc_ed_tpu_torch.parallel.matvec import pad_sector_hamiltonian
from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
from dmft_lanc_ed_tpu_torch.parallel.multihost import run_local_ranks

RANK_TIMEOUT = 240.0     # seconds; a hung rank fails the test
M_STEPS = 30

# name -> (config kwargs, sector, seed): tests/test_parallel.py's models
MODELS = {
    "bethe5": (dict(norb=1, nbath=5, uloc=(1.7,)), (3, 3), 0),
    "jxjp": (dict(norb=2, nbath=1, uloc=(1.0, 1.0), ust=0.4, jh=0.1,
                  jx=0.2, jp=0.2), (2, 2), 0),
    "tridiag": (dict(norb=1, nbath=5, uloc=(2.2,)), (3, 2), 0),
}
# transposes: (rows a rank, du, leading dims); du 2 < 4 ranks leaves
# ranks without columns
TRANSPOSES = ((3, 7, ()), (2, 5, (3,)), (4, 2, (2, 3)), (1, 8, ()))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, lib=pt):
    """(cfg, sec, h, v) of a model in the port (lib=pt) or the JAX package:
    a random bath and hloc from the model's seed (test_parallel._setup)."""
    kw, sqn, seed = MODELS[name]
    cfg = lib.EDConfig(**kw)
    rng = np.random.default_rng(seed)
    norb_e = cfg.norb if cfg.bath_type == "normal" else 1
    e = rng.normal(size=(cfg.nspin, norb_e, cfg.nbath))
    vb = rng.normal(size=(cfg.nspin, cfg.norb, cfg.nbath)) * .5
    hloc = rng.normal(size=(cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)) * 0.2
    hloc = (hloc + hloc.transpose(0, 1, 3, 2)) / 2
    sec = lib.SectorTable(cfg).sector(lib.qn(*sqn))
    h = lib.build_sector_hamiltonian(cfg, sec, hloc, lib.Bath(e=e, v=vb))
    v = np.random.default_rng(7).normal(size=(sec.dim_dw, sec.dim_up))
    if name == "tridiag":
        v /= np.linalg.norm(v)
    return cfg, sec, h, v


# --------------------------------------------------------------------------
# rank function (run in spawned ranks: torch and the port only)
# --------------------------------------------------------------------------
def _rank(rank, n):
    """The transposes of TRANSPOSES, then for every model this rank's rows
    of the sharded matvec (padded) and the 30-step tridiagonal."""
    torch.set_num_threads(1)
    mesh = make_mesh(n, "cpu")
    trans = []
    for rows, du, lead in TRANSPOSES:
        full = torch.arange(np.prod(lead) * n * rows * du,
                            dtype=torch.float64).reshape(lead
                                                         + (n * rows, du))
        loc = full[..., rank * rows:(rank + 1) * rows, :]
        cols = mesh.rows_to_cols(loc)
        c0 = sum(mesh.col_split(du)[:rank])
        trans.append((torch.equal(cols, full[..., c0:c0 + cols.shape[-1]]),
                      torch.equal(mesh.cols_to_rows(cols, du), loc),
                      tuple(cols.shape)))
    out = {"transposes": trans}
    for name in MODELS:
        _, sec, h, v = _inputs(name)
        sl = ShardedLanczos(h, mesh)
        vp = sl.pad_vec(v, sec.dim_dw, sec.dim_up)
        out[name] = dict(y=sl.mv(vp).numpy(), shape=sl.shape)
        if name == "tridiag":
            out[name]["ab"] = sl.tridiag(vp, M_STEPS)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Each rank count's spawned results: {n: [rank results]}."""
    return {n: run_local_ranks(_rank, n, (n,), device="cpu",
                               timeout=RANK_TIMEOUT) for n in (2, 4)}


def _jax_sharded(name, n):
    """The JAX package's ShardedLanczos on n virtual devices: (the matvec's
    physical block, and for "tridiag" the 30-step (alphas, betas))."""
    import jax.numpy as jnp
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.parallel import ShardedLanczos as JSharded
    from dmft_lanc_ed_tpu.parallel import make_mesh as jmesh
    _, sec, h, v = _inputs(name, ed)
    sl = JSharded(h, jmesh(n))
    vp = sl.pad_vec(jnp.asarray(v), sec.dim_dw, sec.dim_up)
    y = np.asarray(sl.mv(vp))[:sec.dim_dw, :sec.dim_up]
    ab = None
    if name == "tridiag":
        ab = tuple(np.asarray(x) for x in sl.tridiag(vp, M_STEPS))
    return y, ab


def _stitched(out, name, sec):
    y = np.concatenate([o[name]["y"] for o in out])
    ddp, dup = out[0][name]["shape"]
    assert y.shape == (ddp, dup) and ddp % len(out) == 0
    assert np.all(y[sec.dim_dw:] == 0.0) and np.all(y[:, sec.dim_up:] == 0.0)
    return y[:sec.dim_dw, :sec.dim_up]


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
def test_rows_to_cols_and_back(ranks, n):
    """rows_to_cols gives each rank its up columns of every row (uneven
    splits, leading dims, ranks without columns), cols_to_rows returns
    the row block: both exact."""
    for r, o in enumerate(ranks[n]):
        for (rows, du, lead), (cols_ok, back_ok, shape) in zip(
                TRANSPOSES, o["transposes"]):
            q, rem = divmod(du, n)
            assert cols_ok and back_ok
            assert shape == lead + (n * rows, q + (r < rem))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matvec_matches_serial(ranks, n):
    """The 20 x 15 sector of nbath = 5 (test_parallel.py:36-47)."""
    _, sec, h, v = _inputs("bethe5")
    y = _stitched(ranks[n], "bethe5", sec)
    y_ser = apply_h(ell_op(h, "cpu"), torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(y, y_ser, atol=1e-13)
    np.testing.assert_allclose(y, _jax_sharded("bethe5", n)[0], atol=1e-13)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matvec_nonlocal_terms(ranks, n):
    """The Jx/Jp terms through the all-gathered vector
    (test_parallel.py:50-63)."""
    _, sec, h, v = _inputs("jxjp")
    assert h.nd_up_src is not None
    y = _stitched(ranks[n], "jxjp", sec)
    y_ser = matvec_flat(ell_op(h, "cpu"), torch.as_tensor(v.reshape(-1))
                        ).reshape(sec.dim_dw, sec.dim_up).numpy()
    np.testing.assert_allclose(y, y_ser, atol=1e-13)
    np.testing.assert_allclose(y, _jax_sharded("jxjp", n)[0], atol=1e-13)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_lanczos_tridiag_matches_serial(ranks, n):
    """30 steps (test_parallel.py:66-79): against the serial tridiagonal
    and the JAX package's sharded one; every rank the same bits."""
    _, sec, h, v = _inputs("tridiag")
    out = ranks[n]
    a_sh, b_sh = out[0]["tridiag"]["ab"]
    for o in out[1:]:
        assert o["tridiag"]["ab"][0].tobytes() == a_sh.tobytes()
        assert o["tridiag"]["ab"][1].tobytes() == b_sh.tobytes()
    a_se, b_se = lanczos_tridiag(ell_op(h, "cpu"),
                                 torch.as_tensor(v.reshape(-1)), M_STEPS,
                                 matvec_flat)
    a_j, b_j = _jax_sharded("tridiag", n)[1]
    for a, b in ((a_se, b_se), (a_j, b_j)):
        np.testing.assert_allclose(a_sh, a, atol=1e-10)
        np.testing.assert_allclose(b_sh, b, atol=1e-10)


def test_padding_region_is_invariant():
    """Vectors supported on the physical block stay there under the padded
    apply, whose physical block equals the unpadded apply's; the padded
    tables equal the JAX package's (test_parallel.py:82-97)."""
    import dmft_lanc_ed_tpu as ed
    from dmft_lanc_ed_tpu.parallel.matvec import (pad_sector_hamiltonian
                                                  as jpad)
    cfg = pt.EDConfig(norb=1, nbath=4, uloc=(1.3,))
    sec = pt.SectorTable(cfg).sector(pt.qn(2, 3))
    bath = pt.init_bath(cfg)
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4), bath)
    hp = pad_sector_hamiltonian(h, 8)
    cfg_j = ed.EDConfig(norb=1, nbath=4, uloc=(1.3,))
    hj = jpad(ed.build_sector_hamiltonian(
        cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(2, 3)), np.zeros((1,) * 4),
        ed.init_bath(cfg_j)), 8)
    for f in ("diag", "up_cols", "up_vals", "dw_cols", "dw_vals"):
        np.testing.assert_array_equal(np.asarray(getattr(hp, f)),
                                      np.asarray(getattr(hj, f)))
    dd, du = sec.dim_dw, sec.dim_up
    ddp, dup = hp.diag.shape
    assert (ddp, dup) == (16, 16)
    v = np.zeros((ddp, dup))
    v[:dd, :du] = np.random.default_rng(7).normal(size=(dd, du))
    y = apply_h(ell_op(hp, "cpu"), torch.as_tensor(v)).numpy()
    assert np.all(y[dd:, :] == 0.0) and np.all(y[:, du:] == 0.0)
    y0 = apply_h(ell_op(h, "cpu"), torch.as_tensor(v[:dd, :du])).numpy()
    np.testing.assert_allclose(y[:dd, :du], y0, atol=1e-13)
