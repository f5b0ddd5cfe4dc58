"""The lowest state of a sector and the impurity Green's function, in
plain NumPy/SciPy: restarted two-pass Lanczos over the Kronecker apply of
:mod:`.model` (dense ``eigh`` for small sectors), and a plain Lanczos
chain (no reorthogonalization) whose continued fraction gives G(iw)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.linalg import eigh_tridiagonal
from scipy.linalg.blas import get_blas_funcs

from .model import Model, SectorOp, SpinFactor

DENSE_MAX = 1500          # sectors up to this many states: dense eigh


def lowest_state(op: SectorOp, seed: int = 0, max_steps: int = 3000,
                 restarts: int = 6) -> Tuple[float, np.ndarray]:
    """(energy, vector) of the sector's lowest state, in the operator's
    precision: dense eigh for small sectors, else plain Lanczos without
    reorthogonalization, run twice (once for the tridiagonal matrix, once
    more to sum the Ritz vector), restarted from that vector until its
    residual |H x - E x| is under tol max(1, |E|), tol = 1e-10 in float64
    (the energy then good to ~1e-20 / gap) and 10 eps in float32."""
    dt = op.dtype
    if op.dim <= DENSE_MAX:
        w, v = np.linalg.eigh(op.dense())
        return float(w[0]), np.ascontiguousarray(v[:, 0])
    tol = 1e-10 if dt == np.float64 else 10 * float(np.finfo(dt).eps)
    x = np.random.default_rng(seed).standard_normal(op.dim).astype(dt)
    best = None
    for _ in range(restarts):
        x /= np.linalg.norm(x)
        al, be = _lanczos_lowest(op, x, max_steps, tol)
        w, s = eigh_tridiagonal(al, be[:-1], select="i", select_range=(0, 0))
        y = _ritz_vector(op, x, al, be, s[:, 0])
        y /= np.linalg.norm(y)
        hy = op.apply(y)
        e = float(np.dot(y, hy))
        res = float(np.linalg.norm(hy - e * y))
        if best is None or res < best[0]:
            best = (res, e, y)
        if res <= tol * max(1.0, abs(e)):
            break
        x = y
    return best[1], best[2]


def _axpy(dt):
    return get_blas_funcs("axpy", dtype=dt)


def _lanczos_lowest(op, v, max_steps, tol):
    """The chain's alphas and betas, run until the lowest Ritz value's
    residual estimate beta_k |s_k| is under tol max(1, |E|)."""
    axpy = _axpy(op.dtype)
    al, be = [], []
    v_prev = np.zeros_like(v)
    beta = 0.0
    for k in range(min(max_steps, op.dim)):
        w = op.apply(v)
        a = float(np.dot(v, w))
        w = axpy(v, w, a=-a)
        w = axpy(v_prev, w, a=-beta)
        beta = float(np.linalg.norm(w))
        al.append(a)
        be.append(beta)
        if beta <= 1e-12 * max(1.0, abs(a)):
            break
        if (k + 1) % 10 == 0:
            e, s = eigh_tridiagonal(al, be[:-1], select="i",
                                    select_range=(0, 0))
            if beta * abs(s[-1, 0]) <= 0.1 * tol * max(1.0, abs(e[0])):
                break
        w *= 1.0 / beta
        v_prev, v = v, w
    return np.array(al), np.array(be)


def _ritz_vector(op, v, al, be, s):
    """sum_i s_i v_i over the chain's vectors, rebuilt from v."""
    axpy = _axpy(op.dtype)
    y = v * op.dtype.type(s[0])
    v_prev = np.zeros_like(v)
    for i in range(len(s) - 1):
        w = op.apply(v)
        w = axpy(v, w, a=-al[i])
        w = axpy(v_prev, w, a=-(be[i - 1] if i else 0.0))
        w *= 1.0 / be[i]
        v_prev, v = v, w
        y = axpy(v, y, a=s[i + 1])
    return y


def lanczos_chain(op: SectorOp, v0: np.ndarray, steps: int
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(|v0|^2, alphas, betas) of a plain Lanczos chain from v0; betas[i]
    couples step i to i + 1. Stops early where the Krylov space closes."""
    norm = float(np.linalg.norm(v0))
    if norm == 0.0:
        return 0.0, np.zeros(0), np.zeros(0)
    v = (v0 / norm).astype(op.dtype)
    v_prev = np.zeros_like(v)
    axpy = _axpy(op.dtype)
    beta = 0.0
    alphas: List[float] = []
    betas: List[float] = []
    for _ in range(min(steps, op.dim)):
        w = op.apply(v)
        a = float(np.dot(v, w))
        w = axpy(v, w, a=-a)
        w = axpy(v_prev, w, a=-beta)
        alphas.append(a)
        beta = float(np.linalg.norm(w))
        betas.append(beta)
        if beta <= 1e-10 * max(1.0, abs(a)):
            break
        w *= 1.0 / beta
        v_prev, v = v, w
    return norm * norm, np.array(alphas), np.array(betas)


def continued_fraction(z: np.ndarray, weight: float, alphas: np.ndarray,
                       betas: np.ndarray) -> np.ndarray:
    """weight / (z - a0 - b0^2 / (z - a1 - ...)) over the chain, in z's
    precision."""
    z = np.asarray(z)
    if not np.iscomplexobj(z):
        z = z.astype(np.complex128)
    real = z.real.dtype.type
    tail = np.zeros_like(z)
    for i in range(len(alphas) - 1, -1, -1):
        b2 = real(betas[i]) ** 2 if i < len(alphas) - 1 else real(0.0)
        tail = 1.0 / (z - real(alphas[i]) - b2 * tail)
    return real(weight) * tail


def excitation(model: Model, nup: int, ndw: int, vec: np.ndarray, a: int,
               particle: bool, dtype=np.float64):
    """(target sector op, c+_a|v> or c_a|v>) for an up-spin electron of
    orbital a, from the state vec of sector (nup, ndw)."""
    src = SpinFactor(model, nup, dtype, with_const=True)
    n2 = nup + 1 if particle else nup - 1
    if n2 < 0 or n2 > model.ns:
        return None, None
    dst = SpinFactor(model, n2, dtype, with_const=True)
    x = vec.reshape(src.dim, -1)
    if particle:
        y = src.cdag(dst, a, dtype) @ x
    else:
        y = dst.cdag(src, a, dtype).T @ x
    return SectorOp(model, n2, ndw, dtype), np.ascontiguousarray(y)
