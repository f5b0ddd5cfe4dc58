"""PyTorch port, the real axis of the B4 route (ROADMAP C13): G(w), Sigma(w)
and chi(w) at the input's eps = 0.01 above the real axis, three ways, on
the CPU at nbath = 4, finite T (beta = 100, ten states):

- the port's forced B4 route (every GF and chi chain through the chain
  kernel's six-pass plain version);
- the JAX package's forced B4 route, its Pallas kernel in interpret mode
  (``ops/blocksparse.py:_auto_interpret``);
- the f64 chain from the same start vectors: each package's own state
  list through its dense f64 scan.

The diag is host eigh in all three (``lanc_dim_threshold`` above every
sector), so the state lists are exact and the routes differ in their
chains alone. Two chain lengths: "whole", the default 200 steps, which
every sector of at most 100 states exhausts; "short", 32 steps, fewer than
the sectors' states, as the 200 steps are at the 854k-state sectors on
the card.

What was measured, and the bars (each a relative distance to the f64
chain, max over the grid over max|f| of the f64 chain):

- G(w), whole chains: the port 1.3e-4, the JAX package 1.3e-4. A chain
  with f32 products places each pole within ~1e-7 x |E| of its f64
  position; at eps = 0.01 above the axis that moves G by max|G| x dp / eps
  next to the pole. Short chains: both 4.4e-2. Where a chain has not
  converged (the interior of the spectrum), the f32 and the f64 chain part
  after orthogonality is lost, and their unconverged poles differ. The
  JAX package shows the same distances: the reference is fragile there
  (ROADMAP, "Where the reference is fragile"). Both packages are pinned at
  2-3x: 3e-4 and 1e-1 (the Matsubara axis meets B4's contract, 2e-5, in
  both cases).
- Sigma(w) = G0^-1 - G^-1 carries dG / |G|^2 where |G| is small (the
  grid's ends): whole 5.8e-3 and 5.7e-3, short 1.37e-1 in both; pinned at
  1.2e-2 and 3e-1.
- chi(w): the port sat 9.6e-2 (whole) and 9.96e-2 (short) of max|chi| off
  the f64 chain before this check existed; the JAX package 2.8e-5 and
  2.1e-3. A port fault, not the chains' pole noise: the B4 Ritz copy of
  the state list's top state landed 1e-7 above emax, past the 1e-8
  reverse-ordering tolerance, and its pair was counted twice. A Ritz value
  of the port's chains with f32 products within 1e-6 x |E| of a listed
  energy of the chain's sector now counts as that listed state
  (``chi._F32_RITZ_RTOL``): 4.2e-6 and 1.7e-4, held at 1e-4 and 4e-4. The
  JAX package's B4 copies cross that tolerance too where they land higher
  (short chains here; through its band-sparse diag at this model, 3.5e-2):
  held at 1e-4 and 5e-3. The last test holds that rule's other side: a
  level outside the list 9.6e-7 above its top keeps its reverse pair.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import chi as jchi
from dmft_lanc_ed_tpu import gf as jgf
from dmft_lanc_ed_tpu_torch import chi as pchi
from dmft_lanc_ed_tpu_torch import gf as pgf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matrices: one torch thread and one BLAS thread keep parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


BASE = dict(norb=1, nbath=4, uloc=(2.0,), beta=100.0, lmats=64, lreal=400,
            ed_finite_temp=True, lanc_nstates_total=10, chispin_flag=True,
            lanc_dim_threshold=1024)
B4 = dict(ed_backend="pallas", ed_batch_sectors=False, ed_gf_chain_min_dim=0)
CHAINS = {"whole": {}, "short": dict(lanc_ngfiter=32)}
# relative distances to the f64 chain (module docstring)
BARS = {
    "whole": {("port", "G"): 3e-4, ("jax", "G"): 3e-4,
              ("port", "sigma"): 1.2e-2, ("jax", "sigma"): 1.2e-2,
              ("port", "chi"): 1e-4, ("jax", "chi"): 1e-4},
    "short": {("port", "G"): 1e-1, ("jax", "G"): 1e-1,
              ("port", "sigma"): 3e-1, ("jax", "sigma"): 3e-1,
              ("port", "chi"): 4e-4, ("jax", "chi"): 5e-3},
}
B4_MATS = 2e-5            # B4's GF contract on the Matsubara axis
_RUNS = {}


def _routes(pkg_name, chains):
    """{"b4": (G, Sigma, chi) on the real axis, "f64": the same from the
    package's own state list through its dense f64 scan, "mats": (G(iw)
    by B4, by f64)} for the port or the JAX package."""
    key = (pkg_name, chains)
    if key in _RUNS:
        return _RUNS[key]
    kw = dict(BASE, **B4, **CHAINS[chains])
    if pkg_name == "port":
        pkg, gfm, chim = pt, pgf, pchi
        solver = pt.EDSolver(pt.EDConfig(**kw), device="cpu")
    else:
        pkg, gfm, chim = ed, jgf, jchi
        solver = ed.EDSolver(ed.EDConfig(**kw))
    packed = solver.init_bath()
    res = solver.solve(packed)
    cfg = solver.cfg
    if pkg is pt:
        assert res.gf.routing[1] == 0 and pchi.routing["spin"][1] == 0
    dense = cfg.replace(ed_backend="dense")
    bath = pkg.unpack_bath(dense, packed)
    kw = dict(device="cpu") if pkg is pt else {}
    hcache = gfm.HCache(dense, solver.table, solver.hloc, bath, **kw)
    gf64 = gfm.build_gf_normal(dense, solver.table, hcache, res.state_list)
    chi64 = chim.build_chi_spin(dense, solver.table, hcache, res.state_list)
    wr = pt.real_grid(cfg)
    sigma64, g64 = gfm.build_sigma(dense, solver.hloc, bath, gf64,
                                   wr + 1j * cfg.eps)
    g64_mats = gfm.build_sigma(dense, solver.hloc, bath, gf64,
                               1j * pt.matsubara_grid(cfg))[1]
    out = {"b4": (res.g_real, res.sigma_real,
                  res.chi_spin[(0, 0)].realaxis(cfg.beta, wr, cfg.eps)),
           "f64": (np.asarray(g64), np.asarray(sigma64),
                   chi64[(0, 0)].realaxis(cfg.beta, wr, cfg.eps)),
           "mats": (res.g_mats, np.asarray(g64_mats))}
    _RUNS[key] = out
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("what", ["G", "sigma", "chi"])
@pytest.mark.parametrize("pkg_name", ["port", "jax"])
@pytest.mark.parametrize("chains", list(CHAINS))
def test_real_axis_against_the_f64_chain(chains, pkg_name, what):
    runs = _routes(pkg_name, chains)
    i = ("G", "sigma", "chi").index(what)
    assert _rel(runs["b4"][i], runs["f64"][i]) <= \
        BARS[chains][(pkg_name, what)]


@pytest.mark.parametrize("pkg_name", ["port", "jax"])
@pytest.mark.parametrize("chains", list(CHAINS))
def test_matsubara_axis_against_the_f64_chain(chains, pkg_name):
    g_b4, g_64 = _routes(pkg_name, chains)["mats"]
    assert _rel(g_b4, g_64) <= B4_MATS


# the two packages' f64 references, G, Sigma, chi: measured 2.5e-13 (whole);
# 2.3e-4, 1.1e-2, 1.2e-3 (short: the states of a degenerate multiplet are
# another basis of it in each package, whose short chains leave other
# unconverged poles; on the Matsubara axis 5e-14), each bar 2-4x that
F64_BARS = {"whole": (1e-12, 1e-12, 1e-12), "short": (5e-4, 2.5e-2, 2.5e-3)}


@pytest.mark.parametrize("chains", list(CHAINS))
def test_the_packages_f64_chains_agree(chains):
    """The two f64 references: each package's own states through its own
    dense scan (the states are host eigh's in both)."""
    for i in range(3):
        d = _rel(_routes("port", chains)["f64"][i],
                 _routes("jax", chains)["f64"][i])
        assert d <= F64_BARS[chains][i], i
    assert _rel(_routes("port", chains)["mats"][1],
                _routes("jax", chains)["mats"][1]) <= 1e-12


# nspin = 2 and the spin-down bath levels 1e-6 above the spin-up ones: each
# spin doublet splits by ~1e-6, and five states end on the lower half of the
# doublet 0.588 above the ground state
SPLIT = dict(norb=1, nbath=4, nspin=2, uloc=(2.0,), beta=5.0, lmats=64,
             lreal=400, ed_finite_temp=True, lanc_nstates_total=5,
             chispin_flag=True, lanc_dim_threshold=1024)


def test_chi_keeps_the_pair_of_a_level_just_above_the_list():
    """The upper half of that doublet lies 9.6e-7 above the list's top, in
    the sector of a listed ground state, outside the list. Its pair with
    that ground state counts in reverse through B4 as through the f64
    chain: measured 1.9e-5 of max|chi| (the bar of whole chains above,
    1e-4). A f32 tolerance on every Ritz value, instead of on the copies of
    the listed energies alone (``chi._F32_RITZ_RTOL``), dropped that pair:
    5.6e-2."""
    cfg = pt.EDConfig(**SPLIT, **B4)
    solver = pt.EDSolver(cfg, device="cpu")
    bath = pt.init_bath(cfg)
    bath.e[1] += 1e-6
    packed = pt.pack_bath(cfg, bath)
    res = solver.solve(packed)
    assert res.gf.routing[1] == 0 and pchi.routing["spin"][1] == 0
    sl = res.state_list
    top = sl.states[-1]
    mirror = (top.qn[1], top.qn[0])
    assert len(sl.states) == 5 and 0.58 < top.e - sl.emin < 0.59
    assert mirror in [st.qn for st in sl.states]
    dense = cfg.replace(ed_backend="dense")
    hcache = pgf.HCache(dense, solver.table, solver.hloc,
                        pt.unpack_bath(dense, packed), device="cpu")
    chi64 = pchi.build_chi_spin(dense, solver.table, hcache, sl)
    wr = pt.real_grid(cfg)
    assert _rel(res.chi_spin[(0, 0)].realaxis(cfg.beta, wr, cfg.eps),
                chi64[(0, 0)].realaxis(cfg.beta, wr, cfg.eps)) <= 1e-4
