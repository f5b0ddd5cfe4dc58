"""PyTorch port, the f64 Rayleigh-Ritz polish of a mixed-precision solve
(``ops/lanczos.refine_eigenpairs``) on a sector with the Jx/Jp terms,
against host ARPACK and the JAX package's f64 solve of the same sector.

The mixed solve (true-f32 products) stops at its floor, a residual of
~3e-6, and the polish recovers f64. Where the gap is narrow against the
spectrum's span (the Jx/Jp sectors) a depth-2 polish round contracts the
error little; three such rounds, the JAX package's polish and the port's
before its depth grew, stop 3e-11 from ARPACK at nbath = 3 (6.6e-11 at
the 853,776-state sector of nbath = 5).

Tolerances, each with its origin:
- the mixed ground state against host ARPACK (``eigsh`` of the assembled
  CSR, tol 1e-13) and against the JAX package's f64 solve: 1e-12, what an
  f64-exact solve reaches on these sectors;
- the polish's apply against the JAX package's f64 dense apply: 1e-13 x
  max|y| (the polish takes every sector term, the Jx/Jp terms included,
  in f64: it is not the f32 copies that set the gap).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import diag as jx_diag
from dmft_lanc_ed_tpu.ops.dense import build_dense_op as jx_build_dense_op
from dmft_lanc_ed_tpu.ops.dense import matvec_dense_flat as jx_dense_flat
from dmft_lanc_ed_tpu_torch.diag import DiagState, diagonalize_impurity
from dmft_lanc_ed_tpu_torch.ops import factory as pfac


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


NBATH = 3
SQN = (NBATH + 1, NBATH + 1)        # (4,4): 4,900 states
MODEL = dict(norb=2, nbath=NBATH, uloc=(2.0, 2.0), ust=1.0, jh=0.5)
JXJP = {"jxjp": dict(jx=0.5, jp=0.5), "no_jxjp": dict(jx=0.0, jp=0.0)}
E_TOL = 1e-12
APPLY_TOL = 1e-13


def _cfg(mod, terms, nstates=1, **kw):
    return mod.EDConfig(**MODEL, **terms, beta=100.0, lmats=256, lreal=32,
                        ed_sectors=True, ed_sectors_shift=0,
                        lanc_nstates_sector=nstates, **kw)


def _arpack(h, k=1) -> np.ndarray:
    """Host ARPACK's lowest k values of the assembled sector CSR, the
    Jx/Jp tensor products sum_t B_t (x) A_t included."""
    def csr(cols, vals, n):
        cols = np.asarray(cols).reshape(n, -1)
        m = sp.csr_matrix((np.asarray(vals, np.float64).ravel(),
                           (np.repeat(np.arange(n), cols.shape[1]),
                            cols.ravel())), shape=(n, n))
        m.eliminate_zeros()
        return m
    du, dd = h.dim_up, h.dim_dw
    hfull = (sp.kron(sp.identity(dd), csr(h.up_cols, h.up_vals, du))
             + sp.kron(csr(h.dw_cols, h.dw_vals, dd), sp.identity(du))
             + sp.diags(np.asarray(h.diag, np.float64).ravel()))
    for t in range(0 if h.nd_up_src is None else h.nd_up_src.shape[0]):
        hfull = hfull + sp.kron(csr(h.nd_dw_src[t], h.nd_dw_val[t], dd),
                                csr(h.nd_up_src[t], h.nd_up_val[t], du))
    w = spl.eigsh(hfull.tocsr(), k=k, which="SA", tol=1e-13,
                  v0=np.ones(du * dd))[0]
    return np.sort(w)


def _sector(mod, cfg):
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    bath = mod.init_bath(cfg)
    table = mod.SectorTable(cfg)
    return hloc, bath, table, table.sector(mod.qn(*SQN))


def _port_states(cfg):
    hloc, bath, table, _ = _sector(pt, cfg)
    ctl = DiagState(lanc_nstates_total=cfg.lanc_nstates_total,
                    sector_hint=[pt.qn(*SQN)])
    return diagonalize_impurity(cfg, table, hloc, bath, ctl, device="cpu")


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
@pytest.mark.parametrize("terms", list(JXJP))
def test_mixed_ground_state_reaches_arpack(terms, batched):
    """The port's mixed solve (f32 products, f64 polish) of the (4,4)
    sector, serial and in a bucket, lands within 1e-12 of host ARPACK and
    of the JAX package's f64 solve, with and without the Jx/Jp terms."""
    cfg = _cfg(pt, JXJP[terms], ed_backend="dense", ed_precision="mixed",
               ed_batch_sectors=batched)
    e_mixed = _port_states(cfg).emin
    hloc, bath, table, sec = _sector(pt, cfg)
    e_arpack = _arpack(pt.build_sector_hamiltonian(cfg, sec, hloc, bath))[0]
    jcfg = _cfg(ed, JXJP[terms], ed_backend="dense", ed_precision="f64")
    jhloc, jbath, jtable, _ = _sector(ed, jcfg)
    e_jax = jx_diag.diagonalize_impurity(
        jcfg, jtable, jhloc, jbath,
        jx_diag.DiagState(lanc_nstates_total=jcfg.lanc_nstates_total,
                     sector_hint=[ed.qn(*SQN)])).emin
    assert abs(e_jax - e_arpack) <= E_TOL
    assert abs(e_mixed - e_arpack) <= E_TOL, (e_mixed, e_arpack)
    assert abs(e_mixed - e_jax) <= E_TOL


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_mixed_two_lowest_reach_arpack(batched):
    """With two states a sector (lanc_nstates_sector = 2) the polish brings
    both of the (4,4) Jx/Jp sector's lowest values within 1e-12 of host
    ARPACK's, not only the lowest."""
    cfg = _cfg(pt, JXJP["jxjp"], nstates=2, ed_backend="dense",
               ed_precision="mixed", ed_batch_sectors=batched)
    (sqn, evals, lanc_solve), = _port_states(cfg).diag_log
    assert sqn == pt.qn(*SQN) and lanc_solve and len(evals) == 2
    hloc, bath, _, sec = _sector(pt, cfg)
    ref = _arpack(pt.build_sector_hamiltonian(cfg, sec, hloc, bath), k=2)
    assert np.abs(np.sort(evals) - ref).max() <= E_TOL, (evals, ref)


def test_polish_apply_takes_the_jxjp_terms_in_f64():
    """The polish's apply of a mixed dense Jx/Jp sector is the f64 dense
    apply, equal to the JAX package's at 1e-13; the production apply is
    the f32 one, ~1e-7 away."""
    cfg = _cfg(pt, JXJP["jxjp"], ed_backend="dense", ed_precision="mixed")
    hloc, bath, _, sec = _sector(pt, cfg)
    op, apply = pfac.make_sector_op(cfg, sec, hloc, bath, "cpu")
    assert op.nd_b is not None and op.nd_b.dtype == torch.float64
    polish = pfac.exact_apply(op)
    assert not pfac.apply_is_exact(apply) and polish is not apply
    jcfg = _cfg(ed, JXJP["jxjp"])
    jhloc, jbath, _, jsec = _sector(ed, jcfg)
    jop = jx_build_dense_op(jcfg, jsec, jhloc, jbath)
    x = np.random.default_rng(7).standard_normal((2, sec.dim))
    for xi in x:
        y_ref = np.asarray(jx_dense_flat(jop, xi))
        scale = np.abs(y_ref).max()
        y = polish(op, torch.as_tensor(xi)).numpy()
        assert np.abs(y - y_ref).max() <= APPLY_TOL * scale
        y32 = apply(op, torch.as_tensor(xi)).numpy()
        assert np.abs(y32 - y_ref).max() > APPLY_TOL * scale



def test_polish_hold_converges_the_lowest_alone(monkeypatch):
    """A handover whose second vector mixes a pair 1e-8 apart, one above
    the lowest level and 1e-3 below the rest (a cut pair, as the T = 0
    scan of the Mott side hands it over): without ``hold`` the polish
    spends all twelve rounds on the pair; with it the lowest alone grows
    rows and holds the rounds, which end once it reaches the target. The
    lowest level comes out to 1e-12 either way."""
    from dmft_lanc_ed_tpu_torch.ops import lanczos as plz
    n = 1500
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([[-2.0, -1.0, -1.0 + 1e-8],
                        -1.0 + np.linspace(1e-3, 3.0, n - 3)])
    h = torch.as_tensor((q * w) @ q.T)
    v0 = q[:, 0] + 1e-5 * rng.standard_normal(n)
    v1 = q[:, 1] + q[:, 2] + 1e-5 * rng.standard_normal(n)
    vecs = torch.as_tensor(np.stack([v0 / np.linalg.norm(v0),
                                     v1 / np.linalg.norm(v1)]))
    real = plz._refine_once
    rounds = []

    def counted(*a, **kw):
        rounds[-1] += 1
        return real(*a, **kw)
    monkeypatch.setattr(plz, "_refine_once", counted)
    for hold in (None, 1e-6):
        rounds.append(0)
        vals, out = plz.refine_eigenpairs(h, lambda op, v: op @ v, vecs,
                                          hold=hold)
        assert abs(vals[0] - w[0]) <= 1e-12
        r = h @ out[0] - vals[0] * out[0]
        assert float(torch.linalg.vector_norm(r)) <= 2e-9 * abs(vals[0])
    assert rounds[0] == 12 and rounds[1] <= 3
