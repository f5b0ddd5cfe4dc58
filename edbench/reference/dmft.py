"""The DMFT loop's host layers in plain NumPy/SciPy: the Anderson
Weiss field of a bath, Dyson's self-energy, the local Green's function
of a semicircular (Bethe) density of states, the Weiss self-consistency,
the chi2 fit of the bath and the linear mixing.

The fit follows dmft-lanc-ed's ``ed_chi2_fitgf`` for a normal bath
(``cg_scheme = weiss``, ``cg_pow = 2``, ``cg_weight = 1``): for each
orbital, theta = [e_k, V_k] minimizes

    chi2 = (1 / Lfit) sum_{n < Lfit} |W(iw_n) - G0_and(iw_n; theta)|^2,

    G0_and(z)^-1 = z + mu - h - sum_k V_k^2 / (z - e_k),

by L-BFGS-B from the bath handed in, stopping when both
|F_{n-1} - F_n| < ftol (1 + F_n) and |x_{n-1} - x_n| < ftol (1 + |x_n|)
(``cg_stop = 0``); the fitted V_k are taken by absolute value.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.optimize import minimize


def matsubara(beta: float, n: int) -> np.ndarray:
    return np.pi / beta * (2 * np.arange(n) + 1)


def bethe_dos(wband: float, n_energies: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(energies, weights) of the semicircle of half-width wband on
    n_energies points of [-wband, wband], weights summing to ~1
    (edn_hm_bethe.f90: linspace, dens_bethe times de)."""
    e = np.linspace(-wband, wband, n_energies)
    x = np.clip(e / wband, -1.0, 1.0)
    rho = 2.0 / (np.pi * wband) * np.sqrt(np.maximum(1.0 - x * x, 0.0))
    return e, rho * (e[1] - e[0])


def hybridization(z: np.ndarray, e: np.ndarray, v: np.ndarray
                  ) -> np.ndarray:
    """Delta(z) = sum_k V_k^2 / (z - e_k) of one orbital."""
    return (v[None, :] ** 2 / (z[:, None] - e[None, :])).sum(-1)


def g0_inverse(z: np.ndarray, mu: float, h: float, e: np.ndarray,
               v: np.ndarray) -> np.ndarray:
    return z + mu - h - hybridization(z, e, v)


def sigma(z, mu, h, e, v, g):
    """Dyson: Sigma = G0_and^-1 - G^-1."""
    return g0_inverse(z, mu, h, e, v) - 1.0 / g


def gloc_bethe(z, mu, h, sig, energies, weights):
    """G_loc(z) = sum_e D(e) / (z + mu - h - Sigma(z) - e)."""
    zeta = z + mu - h - sig
    return (weights[None, :] / (zeta[:, None] - energies[None, :])).sum(-1)


def weiss(gloc: np.ndarray, sig: np.ndarray) -> np.ndarray:
    """The Weiss field [G_loc^-1 + Sigma]^-1."""
    return 1.0 / (1.0 / gloc + sig)


def _chi2_and_grad(theta, z, target, mu, h, nb, dtype):
    e = theta[:nb].astype(dtype)
    v = theta[nb:].astype(dtype)
    d = z[:, None] - e[None, :]
    delta = (v[None, :] ** 2 / d).sum(-1)
    g = 1.0 / (z + mu - h - delta)
    r = target - g
    n = len(z)
    chi2 = float((r.real ** 2 + r.imag ** 2).sum() / n)
    # d chi2 = -(2/n) Re sum conj(r) dg, dg = g^2 d(Delta)
    c = np.conj(r) * g * g
    de = (v[None, :] ** 2 / d ** 2)
    dv = 2.0 * v[None, :] / d
    ge = -2.0 / n * (c[:, None] * de).real.sum(0)
    gv = -2.0 / n * (c[:, None] * dv).real.sum(0)
    return chi2, np.concatenate([ge, gv]).astype(np.float64)


class _Stop:
    """The fmin_cg stopping rule (cg_stop = 0), as a callback."""

    def __init__(self, fun, ftol):
        self.fun, self.ftol = fun, ftol
        self.prev = None

    def __call__(self, xk, *_):
        xk = np.asarray(xk, np.float64).copy()
        fk = self.fun(xk)
        if self.prev is not None:
            px, pf = self.prev
            c1 = abs(pf - fk) < self.ftol * (1.0 + abs(fk))
            c2 = np.linalg.norm(px - xk) < self.ftol * (1.0 + np.linalg.norm(xk))
            if c1 and c2:
                raise StopIteration
        self.prev = (xk, fk)


def fit_orbital(target: np.ndarray, e0: np.ndarray, v0: np.ndarray,
                beta: float, lfit: int, mu: float, h: float,
                ftol: float = 1e-5, niter: int = 500, dtype=np.float64
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(e, |V|, chi2) of one orbital's bath fitted to target[:lfit], the
    chi2 computed in `dtype`."""
    nb = len(e0)
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    z = (1j * matsubara(beta, lfit)).astype(cdt)
    tgt = np.asarray(target[:lfit]).astype(cdt)
    real = np.dtype(dtype).type

    def fg(t):
        return _chi2_and_grad(t, z, tgt, real(mu), real(h), nb, dtype)

    def f(t):
        return fg(t)[0]

    theta0 = np.concatenate([e0, v0]).astype(np.float64)
    res = minimize(fg, theta0, jac=True, method="L-BFGS-B",
                   callback=_Stop(f, ftol),
                   options={"maxiter": niter, "ftol": ftol * 1e-3,
                            "gtol": 1e-12})
    theta = np.asarray(res.x, np.float64)
    return theta[:nb], np.abs(theta[nb:]), f(theta)


def chi2(target: np.ndarray, e: np.ndarray, v: np.ndarray, beta: float,
         lfit: int, mu: float, h: float) -> float:
    """The fit's chi2 of one orbital's bath (e, V) against target[:lfit],
    in float64."""
    z = 1j * matsubara(beta, lfit)
    r = np.asarray(target[:lfit], np.complex128) - 1.0 / g0_inverse(
        z, mu, h, np.asarray(e, np.float64), np.asarray(v, np.float64))
    return float((r.real ** 2 + r.imag ** 2).sum() / lfit)


def mix(new: np.ndarray, prev, alpha: float) -> np.ndarray:
    """Linear mixing alpha new + (1 - alpha) prev; the first call of a run
    (prev None) hands new on."""
    new = np.asarray(new, np.float64)
    if prev is None:
        return new.copy()
    return alpha * new + (1.0 - alpha) * np.asarray(prev, np.float64)


def unpack_normal(bath: np.ndarray, norb: int, nbath: int
                  ) -> Dict[str, np.ndarray]:
    """A normal bath of one spin as dmft-lanc-ed packs it: every level by
    (orbital, k), then every hybridization."""
    n = norb * nbath
    return {"e": bath[:n].reshape(norb, nbath),
            "v": bath[n:2 * n].reshape(norb, nbath)}


def pack_normal(e: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(e).reshape(-1),
                           np.asarray(v).reshape(-1)])
