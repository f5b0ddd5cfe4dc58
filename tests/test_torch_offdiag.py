"""PyTorch port, the off-diagonal Green's function: impurity solves with a
hybrid bath, a replica bath and a normal bath with ``ed_solve_offdiag_gf``
against the JAX package's EDSolver on CPU; the forced B4 route (every GF
target, the mixed chains included, through the chain kernel's plain
version); the pole-weight identities; the hybrid and replica chi2 fits'
value and gradient against jax.grad.

Tolerances, each with its origin:
- Egs 1e-9; G (G_01 included), Sigma and the observables 1e-6: the bars of
  test_torch_dmft.py, both packages on dense f64 operators;
- the forced B4 route against the JAX dense backend: atol 5e-5, rtol 3e-5,
  the f32-chain GF contract of test_torch_solve.py / test_bs_chain.py;
- the real axis of the dense route against the JAX package's f64 chain:
  per case, ``REAL_AXIS_BARS`` (2-4x what was measured, relative to
  max|f|);
- the pole weights: per state a chain's weights sum to its norm^2 times
  the Boltzmann weight whatever its length, so each diagonal channel sums
  to <{c_a, c_a^+}> = 1 and each recombined off-diagonal channel to
  1/2 (|c_a+c_b|^2 - |c_a|^2 - |c_b|^2) = <{c_a, c_b^+}> = 0: 1e-12;
- chi2 and gradient at a fixed bath: 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import fit as jfit
from dmft_lanc_ed_tpu import solver as jsolver
from dmft_lanc_ed_tpu.bath import Bath as JBath
from dmft_lanc_ed_tpu_torch import fit as pfit
from dmft_lanc_ed_tpu_torch import solver as psolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The matrices here are small: one torch intra-op thread and one BLAS
    thread (the host eigh of every sector, in both packages) are as fast
    alone and keep parallel test workers from oversubscribing the cores
    (a BHZ run took 62 s against 13 s beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _hloc(m):
    h = np.zeros((1, 1, 2, 2))
    h[0, 0] = m
    return h


def _replica_basis():
    """test_hamiltonian.py:test_replica_bath's basis: identity + orbital
    sigma_x."""
    basis = np.zeros((2, 1, 1, 2, 2))
    basis[0, 0, 0] = np.eye(2)
    basis[1, 0, 0] = [[0.0, 1.0], [1.0, 0.0]]
    return basis


GRID = dict(beta=100.0, lmats=48, lreal=16)
# name -> (config kwargs, hloc, h_basis, lambda_imp)
CASES = {
    # test_phonon_solver.py:test_hybrid_offdiag_gf_vs_full
    "hybrid": (dict(norb=2, nbath=2, uloc=(1.0, 1.0), ust=0.4,
                    bath_type="hybrid", **GRID),
               _hloc([[0.1, 0.2], [0.2, -0.1]]), None, None),
    # test_hamiltonian.py:test_replica_bath
    "replica": (dict(norb=2, nbath=2, uloc=(1.0, 1.0), ust=0.4, jh=0.1,
                     bath_type="replica", **GRID),
                _hloc([[0.2, 0.1], [0.1, -0.2]]), _replica_basis(),
                np.array([0.05, 0.1])),
    # test_hamiltonian.py:test_two_orbital_offdiag_hloc, off-diagonal GF on
    "normal-offdiag": (dict(norb=2, nbath=2, uloc=(2.0, 1.5), ust=0.8,
                            jh=0.2, xmu=0.05, ed_solve_offdiag_gf=True,
                            **GRID),
                       _hloc([[0.1, 0.3], [0.3, -0.2]]), None, None),
}
# the dense route's real axis against the JAX package's f64 chain, relative
# to max|f|: measured 5.9e-13 / 7.6e-12 (hybrid: every chain exhausts its
# sector of <= 36 states), 5.4e-6 / 4.3e-5 (replica) and 2.1e-5 / 3.5e-3
# (normal-offdiag; Sigma = G0^-1 - G^-1 carries dG / |G|^2 where |G| is
# small); each bar 2-4x its measurement
REAL_AXIS_BARS = {
    "hybrid": {"g_real": 1e-11, "sigma_real": 3e-11},
    "replica": {"g_real": 2e-5, "sigma_real": 1e-4},
    "normal-offdiag": {"g_real": 5e-5, "sigma_real": 1e-2},
}
_SOLVES = {}


def _solve(name, port_kw=None, ref_kw=None, **kw):
    """(port result, JAX result, port solver, JAX solver) of one solve of
    the case's default bath; the port on the CPU. Cached per arguments."""
    key = (name, tuple(sorted((port_kw or {}).items())),
           tuple(sorted((ref_kw or {}).items())), tuple(sorted(kw.items())))
    if key not in _SOLVES:
        base, hloc, basis, lam = CASES[name]
        cfg_p = pt.EDConfig(**base, **kw, **(port_kw or {}))
        cfg_j = ed.EDConfig(**base, **kw, **(ref_kw or {}))
        sp = pt.EDSolver(cfg_p, hloc, h_basis=basis, lambda_imp=lam,
                         device="cpu")
        sj = ed.EDSolver(cfg_j, hloc, h_basis=basis, lambda_imp=lam)
        bath = sj.init_bath()
        assert bath.tobytes() == sp.init_bath().tobytes()
        _SOLVES[key] = sp.solve(bath), sj.solve(bath), sp, sj
    return _SOLVES[key]


def _dense(name):
    """The dense-backend solve: host eigh for the diag, every GF chain,
    mixed ones included, through the batched dense scan."""
    return _solve(name, port_kw=dict(ed_backend="dense"),
                  ref_kw=dict(ed_backend="dense"), lanc_dim_threshold=1024)


def _b4(name):
    """The forced B4 route: every GF target, mixed chains included,
    through the chain kernel's plain version; host eigh for the diag."""
    return _solve(name, port_kw=dict(ed_backend="pallas",
                                     ed_batch_sectors=False,
                                     ed_gf_chain_min_dim=0),
                  ref_kw=dict(ed_backend="dense"), lanc_dim_threshold=1024,
                  lanc_ngfiter=48)


@pytest.mark.parametrize("name", list(CASES))
def test_offdiag_solve_matches_reference(name):
    rp, rj, _, _ = _dense(name)
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-9
    assert rp.gf.routing[1] > 0
    for f in ("g_mats", "sigma_mats", "g0_mats", "g0_real"):
        np.testing.assert_allclose(getattr(rp, f), getattr(rj, f), atol=1e-6,
                                   err_msg=f)
    # the real axis (eps = 0.01 off it) against the JAX package's f64 chain
    # from the same states, relative to max|f|: two f64 chains without
    # reorthogonalization split their ghost copies differently, and at
    # eps = 0.01 the interior poles show it (ROADMAP C13)
    for f in ("g_real", "sigma_real"):
        got, want = getattr(rp, f), getattr(rj, f)
        d = np.abs(got - want).max() / np.abs(want).max()
        assert d <= REAL_AXIS_BARS[name][f], (f, d)
    # the off-diagonal channel is there, and symmetric
    assert np.abs(rp.g_mats[0, 0, 0, 1]).max() > 1e-3
    assert np.array_equal(rp.g_mats[0, 0, 0, 1], rp.g_mats[0, 0, 1, 0])
    for f in ("dens", "docc", "imp_dm"):
        np.testing.assert_allclose(getattr(rp.observables, f),
                                   getattr(rj.observables, f), atol=1e-6,
                                   err_msg=f)
    for f in ("egs", "epot", "ehartree", "eknot"):
        assert abs(getattr(rp.observables, f)
                   - getattr(rj.observables, f)) < 1e-6, f


def test_solver_getters_and_grids_match_reference():
    """The ED_IO getters and frequency grids of the reference's EDSolver
    on one hybrid solve."""
    _, _, sp, sj = _dense("hybrid")
    for get in ("get_mag", "get_eimp", "get_doubles", "get_imp_dm",
                "get_dens", "get_docc", "get_sigma_matsubara",
                "get_gimp_matsubara", "get_g0imp_matsubara"):
        np.testing.assert_allclose(getattr(sp, get)(), getattr(sj, get)(),
                                   atol=1e-6, err_msg=get)
    assert sp.get_imp_dm().shape == (1, 2, 2)
    assert abs(sp.get_imp_dm()[0, 0, 1]) > 1e-3
    cfg_p, cfg_j = sp.cfg, sj.cfg
    for grid in ("bosonic_grid", "tau_grid", "matsubara_grid", "real_grid"):
        got = getattr(psolver, grid)(cfg_p)
        assert np.array_equal(got, getattr(jsolver, grid)(cfg_j)), grid
    assert psolver.tau_grid(cfg_p)[-1] == cfg_p.beta


@pytest.mark.parametrize("name", ["hybrid", "replica"])
def test_offdiag_b4_route_matches_reference_dense(name):
    rp, rj, _, _ = _b4(name)
    assert rp.gf.routing[0] > 0 and rp.gf.routing[1] == 0
    assert abs(rp.state_list.emin - rj.state_list.emin) < 1e-9
    np.testing.assert_allclose(rp.g_mats, rj.g_mats, atol=5e-5, rtol=3e-5)
    np.testing.assert_allclose(rp.g_mats[0, 0, 0, 1], rj.g_mats[0, 0, 0, 1],
                               atol=5e-5, rtol=3e-5)


@pytest.mark.parametrize("name,route", [(n, "dense") for n in CASES]
                         + [("hybrid", "b4"), ("replica", "b4")])
def test_pole_weight_identities(name, route):
    gf = (_dense if route == "dense" else _b4)(name)[0].gf
    assert (0, 0, 1) in gf.channels and (0, 1, 0) in gf.channels
    for (s, a, b), gp in gf.channels.items():
        want = 1.0 if a == b else 0.0
        assert abs(gp.weights.sum() - want) <= 1e-12, (s, a, b)


def _fit_inputs(cfg_p, seed):
    rng = np.random.default_rng(seed)
    lfit = cfg_p.lfit
    wm = pt.matsubara_grid(cfg_p)[:lfit]
    # a smooth causal-looking 2x2 target with off-diagonal parts
    base = 1.0 / (1j * wm + 0.3j * np.sign(wm))
    tgt = np.zeros((cfg_p.nspin, cfg_p.nspin, 2, 2, lfit), complex)
    for s in range(cfg_p.nspin):
        m = rng.normal(size=(2, 2)) * 0.2
        m = m + m.T
        tgt[s, s] = np.eye(2)[:, :, None] * base + m[:, :, None] * base ** 2
    return wm, tgt


@pytest.mark.parametrize("scheme", ["delta", "weiss"])
@pytest.mark.parametrize("name", ["hybrid", "replica"])
def test_fit_chi2_value_and_grad_match_reference(name, scheme):
    base, hloc, basis, lam = CASES[name]
    kw = dict(base, lmats=64, lfit=48, cg_scheme=scheme, cg_weight=2)
    cfg_p, cfg_j = pt.EDConfig(**kw), ed.EDConfig(**kw)
    wm, target = _fit_inputs(cfg_p, 6)
    rng = np.random.default_rng(11)
    nb = cfg_p.nbath
    z = torch.as_tensor(1j * wm, dtype=torch.complex128)
    wgt = torch.as_tensor(pfit._fit_weight(cfg_p, wm), dtype=torch.float64)
    zj, wj = jnp.asarray(1j * wm), jnp.asarray(jfit._fit_weight(cfg_j, wm))
    fn = jfit._target_fn(cfg_j)
    if name == "hybrid":
        theta = np.concatenate([rng.normal(size=nb),
                                0.3 + rng.random(2 * nb)])
        tgt = torch.as_tensor(target[0, 0], dtype=torch.complex128)
        val_p, grad_p = pfit.value_and_grad(
            lambda t: pfit.chi2_hybrid(cfg_p, t, z, tgt, wgt, hloc[0, 0]),
            theta)

        def chi2_j(t):
            bath = JBath(e=t[:nb].reshape(1, 1, nb),
                         v=t[nb:].reshape(1, 2, nb))
            d = fn(bath, jnp.asarray(hloc), zj, None)[0, 0]
            r = jfit._cabs_pow(jnp.asarray(target[0, 0]) - d, cfg_j.cg_pow)
            return (r / wj[None, None, :]).sum() / len(wm)
    else:
        nsym = basis.shape[0]
        theta = np.concatenate([0.3 + rng.random(nb),
                                rng.normal(size=nb * nsym)])
        tgt = torch.as_tensor(target, dtype=torch.complex128)
        val_p, grad_p = pfit.value_and_grad(
            lambda t: pfit.chi2_replica(cfg_p, t, z, tgt, wgt, hloc, basis),
            theta)

        def chi2_j(t):
            # the reference fit's own closure (fit.py replica branch)
            bath = JBath(lam=t[nb:].reshape(nb, nsym),
                         v_rep=t[:nb].reshape(nb, 1))
            d = fn(bath, jnp.asarray(hloc), zj, jnp.asarray(basis))
            r = jfit._cabs_pow(jnp.asarray(target) - d, cfg_j.cg_pow)
            return (r / wj).sum() / len(wm)
    val_j, grad_j = jax.value_and_grad(chi2_j)(jnp.asarray(theta))
    assert abs(val_p - float(val_j)) <= 1e-10 * abs(float(val_j))
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(grad_p, grad_j, rtol=1e-10,
                               atol=1e-10 * np.abs(grad_j).max())


@pytest.mark.parametrize("name", ["hybrid", "replica"])
def test_fit_runs_and_lowers_chi2(name):
    """chi2_fitgf on a hybrid / replica bath: a finite packed bath of the
    reference's dimension and layout, with a lower chi2 than the start."""
    base, hloc, basis, lam = CASES[name]
    kw = dict(base, lmats=64, lfit=48, cg_niter=40)
    cfg = pt.EDConfig(**kw)
    wm, target = _fit_inputs(cfg, 6)
    start = pt.pack_bath(cfg, pt.init_bath(cfg, lam, basis))
    fitted = pfit.chi2_fitgf(cfg, target, start, hloc, h_basis=basis)
    nsym = None if basis is None else basis.shape[0]
    assert len(fitted) == pt.bath_dimension(cfg, nsym)
    assert np.all(np.isfinite(fitted))
    z = 1j * wm

    def chi2(packed):
        f = pt.bath_functions.g0and_bath(cfg, hloc,
                                         pt.unpack_bath(cfg, packed, nsym),
                                         z, basis).numpy()
        return float((np.abs(target - f) ** 2).sum())
    assert chi2(fitted) < chi2(start)
    if name == "replica":
        assert np.array_equal(fitted[:cfg.nbath], start[:cfg.nbath])
        assert np.all(pt.unpack_bath(cfg, fitted, nsym).v_rep >= 0)
    else:
        assert np.all(pt.unpack_bath(cfg, fitted).v >= 0)
