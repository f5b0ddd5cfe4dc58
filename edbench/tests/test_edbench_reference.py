"""The plain reference held to a brute-force diagonalization of the whole
Fock space (CPU, nbath <= 3)."""
import numpy as np
import pytest

from edbench.reference import dmft, iteration
from edbench.reference.model import Model, SectorOp


def _fock_ops(nmodes):
    """Dense annihilators of nmodes fermion modes, Jordan-Wigner ordered."""
    dim = 1 << nmodes
    states = np.arange(dim)
    ops = []
    for m in range(nmodes):
        c = np.zeros((dim, dim))
        occ = (states >> m) & 1
        sign = (-1.0) ** np.array([bin(s & ((1 << m) - 1)).count("1")
                                   for s in states])
        src = states[occ == 1]
        c[src ^ (1 << m), src] = sign[occ == 1]
        ops.append(c)
    return ops


def _brute(model):
    """Whole-Fock-space H of the model as its docstring writes it, and the
    (Nup, Ndw) of each basis state."""
    ns, norb = model.ns, model.norb
    c = _fock_ops(2 * ns)
    up = lambda i: c[i]
    dw = lambda i: c[ns + i]
    n = {(i, s): (up(i) if s == 0 else dw(i)).T @ (up(i) if s == 0
                                                    else dw(i))
         for i in range(ns) for s in (0, 1)}
    dim = 1 << (2 * ns)
    h = np.zeros((dim, dim))
    u, ust, jh = model.uloc, model.ust, model.jh
    for s in (0, 1):
        cs = up if s == 0 else dw
        for a in range(norb):
            h += (model.hloc[a] - model.xmu) * n[a, s]
            for k in range(model.nbath):
                b = model.bath_site(a, k)
                h += model.e[a, k] * n[b, s]
                h += model.v[a, k] * (cs(a).T @ cs(b) + cs(b).T @ cs(a))
    one = np.eye(dim)
    for a in range(norb):
        h += u[a] * (n[a, 0] - 0.5 * one) @ (n[a, 1] - 0.5 * one)
    for a in range(norb):
        for b in range(a + 1, norb):
            nat, nbt = n[a, 0] + n[a, 1], n[b, 0] + n[b, 1]
            h += ust * (n[a, 0] @ n[b, 1] + n[a, 1] @ n[b, 0])
            h += (ust - jh) * (n[a, 0] @ n[b, 0] + n[a, 1] @ n[b, 1])
            h -= 0.5 * (2 * ust - jh) * (nat + nbt)
            h += 0.25 * (2 * ust - jh) * one
    # U n+ n- expanded above carries U/4; the Fortran's constant is the same
    states = np.arange(dim)
    mask = (1 << ns) - 1
    nup = np.array([bin(s & mask).count("1") for s in states])
    ndw = np.array([bin(s >> ns).count("1") for s in states])
    return h, nup, ndw, up


def _model(norb, nbath, seed):
    rng = np.random.default_rng(seed)
    e = np.sort(rng.uniform(-1.5, 1.5, (norb, nbath)), axis=1)
    v = rng.uniform(0.2, 0.6, (norb, nbath))
    return Model(norb=norb, nbath=nbath,
                 uloc=(2.0, 2.5, 2.5)[:norb] if norb > 1 else (2.0,),
                 ust=1.5 if norb > 1 else 0.0, jh=0.5 if norb > 1 else 0.0,
                 xmu=0.0, hloc=(0.0,) * norb, e=e, v=v)


@pytest.mark.parametrize("norb,nbath", [(1, 3), (2, 1), (1, 2)])
def test_sector_energies_match_whole_space(norb, nbath):
    model = _model(norb, nbath, 7)
    h, nup, ndw, _ = _brute(model)
    for q in [(a, b) for a in range(model.ns + 1)
              for b in range(model.ns + 1)]:
        sel = (nup == q[0]) & (ndw == q[1])
        want = np.linalg.eigvalsh(h[np.ix_(sel, sel)])
        got = np.linalg.eigvalsh(SectorOp(model, *q).dense())
        assert np.allclose(np.sort(got), want, atol=1e-10)


@pytest.mark.parametrize("norb,nbath", [(1, 3), (2, 1)])
def test_iteration_matches_lehmann(norb, nbath):
    model = _model(norb, nbath, 11)
    h, nup, ndw, up = _brute(model)
    w, vec = np.linalg.eigh(h)
    beta, lmats = 100.0, 64
    z = 1j * dmft.matsubara(beta, lmats)
    gs = np.flatnonzero(w <= w[0] + 1e-9)
    g_want = np.zeros((norb, lmats), complex)
    for i in gs:
        for a in range(norb):
            cp = vec.T @ (up(a).T @ vec[:, i])     # <m|c+_a|gs>
            cm = vec.T @ (up(a) @ vec[:, i])       # <m|c_a|gs>
            g_want[a] += ((cp ** 2)[None, :] / (z[:, None] - (w - w[i]))
                          + (cm ** 2)[None, :] / (z[:, None] + (w - w[i]))
                          ).sum(1)
    g_want /= len(gs)
    p = iteration.Problem(
        model=dict(norb=norb, nbath=nbath, uloc=model.uloc, ust=model.ust,
                   jh=model.jh, xmu=0.0, hloc=model.hloc),
        bath=dmft.pack_normal(model.e, model.v),
        sectors=iteration.scan_sectors(model.ns, None), beta=beta,
        lmats=lmats, lfit=32, gf_steps=200, gs_threshold=1e-9, wband=1.0,
        n_energies=500, wmixing=0.5, cg_ftol=1e-5, cg_niter=500)
    got = iteration.solve_iteration(p, 3, workers=2)
    top = np.argmax(np.abs(vec[:, gs]), axis=0)   # each state's sector
    ground = sorted({(int(nup[i]), int(ndw[i])) for i in top})
    assert got.ground == ground
    for q, e in got.energies.items():
        sel = (nup == q[0]) & (ndw == q[1])
        assert abs(e - np.linalg.eigvalsh(h[np.ix_(sel, sel)])[0]) < 1e-10
    assert np.abs(got.g - g_want).max() < 1e-10 * np.abs(g_want).max()
    for a in range(norb):
        g0inv = z - dmft.hybridization(z, model.e[a], model.v[a])
        assert np.allclose(got.sigma[a], g0inv - 1.0 / g_want[a],
                           atol=1e-8)
        assert np.allclose(got.weiss[a],
                           1.0 / (1.0 / got.gloc[a] + got.sigma[a]))


def test_bethe_gloc_is_the_semicircle():
    z = 1j * dmft.matsubara(10.0, 16)
    e, wts = dmft.bethe_dos(1.0, 40001)
    got = dmft.gloc_bethe(z, 0.0, 0.0, np.zeros_like(z), e, wts)
    want = 2.0 * (z - np.sqrt(z * z - 1.0)) * np.where(
        (z - np.sqrt(z * z - 1.0)).imag < 0, 1, 0)
    want = np.where(want == 0, 2.0 * (z + np.sqrt(z * z - 1.0)), want)
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fit_recovers_a_bath(dtype):
    rng = np.random.default_rng(5)
    e = np.sort(rng.uniform(-1, 1, 4))
    v = rng.uniform(0.2, 0.5, 4)
    z = 1j * dmft.matsubara(100.0, 256)
    target = 1.0 / dmft.g0_inverse(z, 0.0, 0.0, e, v)
    e1, v1, chi2 = dmft.fit_orbital(
        target, e + 0.05, v * 1.1, 100.0, 256, 0.0, 0.0, dtype=dtype)
    fitted = 1.0 / dmft.g0_inverse(z, 0.0, 0.0, e1, v1)
    assert chi2 < 1e-7
    # the fit stops at cg_ftol = 1e-5 on chi2's change
    assert np.abs(fitted - target).max() < 5e-3
    assert chi2 == pytest.approx(dmft.chi2(target, e1, v1, 100.0, 256, 0.0,
                                           0.0), rel=1e-3, abs=1e-12)


def test_mix_first_call_hands_on():
    a, b = np.array([1.0, 2.0]), np.array([3.0, 4.0])
    assert np.array_equal(dmft.mix(a, None, 0.5), a)
    assert np.array_equal(dmft.mix(a, b, 0.5), 0.5 * a + 0.5 * b)
