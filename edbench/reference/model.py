"""Sector Hamiltonians of the normal-bath Anderson impurity model, in
plain NumPy/SciPy.

The model is the one the DMFT drivers of dmft-lanc-ed solve (EDIpack's
``ED_HAMILTONIAN`` local, bath and hybridization terms, ``hfmode``
form): ``norb`` impurity orbitals, each with ``nbath`` bath levels of its
own, both spins alike (``nspin = 1``)::

    H = sum_{a,s} (h_a - mu) n_as + sum_{a,k,s} e_ak n_aks
        + sum_{a,k,s} V_ak (c+_as c_aks + c+_aks c_as)
        + sum_a U_a n_a+ n_a- + U' sum_{a != b} n_a+ n_b-
        + (U' - J) sum_{a < b, s} n_as n_bs
        - sum_a (U_a / 2 + (2U' - J)(norb - 1) / 2) (n_a+ + n_a-)
        + sum_a U_a / 4 + (2U' - J) / 4 * norb (norb - 1) / 2

(the last two lines are the Hartree shift of ``hfmode``, written as the
Fortran writes it). A sector holds ``nup`` up and ``ndw`` down electrons
over ``ns = norb (nbath + 1)`` sites a spin: site ``a`` is impurity
orbital ``a``, site ``norb + a nbath + k`` its bath level ``k``. A state
of one spin is an ``ns``-bit integer; the fermion sign of ``c+_i c_j`` is
``(-1)`` to the number of occupied sites strictly between ``i`` and
``j``. A sector vector is an array ``[dim_up, dim_dw]`` and

    H X = H_up X + X H_dw^T + C * X,   C[i, j] = sum_ab W_ab nu_ia nd_jb,

with ``W = diag(U) + U' (1 - I)``. Nothing here imports the program under
test.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Tuple

import numpy as np
import scipy.sparse as sp


@dataclass(frozen=True)
class Model:
    """One impurity problem: interaction, local levels and the bath."""
    norb: int
    nbath: int
    uloc: Tuple[float, ...]
    ust: float
    jh: float
    xmu: float
    hloc: Tuple[float, ...]     # impurity levels h_a
    e: np.ndarray               # [norb, nbath] bath levels
    v: np.ndarray               # [norb, nbath] hybridizations

    @property
    def ns(self) -> int:
        return self.norb * (self.nbath + 1)

    def bath_site(self, a: int, k: int) -> int:
        return self.norb + a * self.nbath + k


def spin_states(ns: int, n: int) -> np.ndarray:
    """All ns-bit states with n bits set, ascending."""
    out = [sum(1 << i for i in c) for c in combinations(range(ns), n)]
    return np.array(sorted(out), dtype=np.int64)


def _bits(states: np.ndarray, ns: int) -> np.ndarray:
    return ((states[:, None] >> np.arange(ns)[None, :]) & 1).astype(np.int64)


def _hop(states: np.ndarray, index: dict, i: int, j: int):
    """(rows, cols, signs) of c+_i c_j within one spin's basis."""
    occ_j = (states >> j) & 1
    occ_i = (states >> i) & 1
    sel = np.flatnonzero((occ_j == 1) & (occ_i == 0))
    src = states[sel]
    dst = src ^ (1 << i) ^ (1 << j)
    lo, hi = min(i, j), max(i, j)
    between = ((1 << hi) - 1) & ~((1 << (lo + 1)) - 1)
    cnt = np.array([bin(int(s) & between).count("1") for s in src],
                   dtype=np.int64)
    rows = np.array([index[int(d)] for d in dst], dtype=np.int64)
    return rows, sel, np.where(cnt % 2 == 0, 1.0, -1.0)


class SpinFactor:
    """One spin's basis with n electrons and its factor of H: the hopping,
    the one-spin diagonal and the impurity occupations."""

    def __init__(self, model: Model, n: int, dtype=np.float64,
                 with_const: bool = False):
        ns, norb = model.ns, model.norb
        self.n = n
        self.states = spin_states(ns, n)
        self.index = {int(s): i for i, s in enumerate(self.states)}
        self.dim = len(self.states)
        occ = _bits(self.states, ns).astype(np.float64)
        self.nimp = occ[:, :norb]
        uloc = np.asarray(model.uloc[:norb], np.float64)
        ust, jh = model.ust, model.jh
        diag = self.nimp @ (np.asarray(model.hloc, np.float64) - model.xmu)
        for a in range(norb):
            for k in range(model.nbath):
                diag = diag + model.e[a, k] * occ[:, model.bath_site(a, k)]
        if norb > 1:
            tot = self.nimp.sum(1)
            diag = diag + (ust - jh) * 0.5 * (tot ** 2
                                              - (self.nimp ** 2).sum(1))
        # the Hartree shift, one spin's half of it
        diag = diag - 0.5 * (self.nimp @ uloc)
        diag = diag - 0.5 * (2 * ust - jh) * (norb - 1) * self.nimp.sum(1)
        if with_const:
            npairs = norb * (norb - 1) // 2
            diag = diag + 0.25 * uloc.sum() + 0.25 * (2 * ust - jh) * npairs
        rows, cols, vals = [np.arange(self.dim)], [np.arange(self.dim)], [diag]
        for a in range(norb):
            for k in range(model.nbath):
                vak = float(model.v[a, k])
                if vak == 0.0:
                    continue
                b = model.bath_site(a, k)
                for i, j in ((a, b), (b, a)):
                    r, c, s = _hop(self.states, self.index, i, j)
                    rows.append(r)
                    cols.append(c)
                    vals.append(vak * s)
        self.h = sp.csr_matrix(
            (np.concatenate(vals).astype(dtype),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.dim, self.dim))
        self.h.sum_duplicates()

    def cdag(self, other: "SpinFactor", a: int, dtype=np.float64):
        """c+_a from this basis (n) into `other` (n + 1), sparse
        [other.dim, self.dim]."""
        occ = (self.states >> a) & 1
        sel = np.flatnonzero(occ == 0)
        src = self.states[sel]
        below = (1 << a) - 1
        cnt = np.array([bin(int(s) & below).count("1") for s in src],
                       dtype=np.int64)
        rows = np.array([other.index[int(s | (1 << a))] for s in src],
                        dtype=np.int64)
        sign = np.where(cnt % 2 == 0, 1.0, -1.0).astype(dtype)
        return sp.csr_matrix((sign, (rows, sel)), shape=(other.dim, self.dim))


class SectorOp:
    """H on the sector (nup, ndw) as the Kronecker form above."""

    def __init__(self, model: Model, nup: int, ndw: int, dtype=np.float64):
        self.model = model
        self.dtype = np.dtype(dtype)
        self.up = SpinFactor(model, nup, dtype, with_const=True)
        self.dw = SpinFactor(model, ndw, dtype)
        w = (np.diag(np.asarray(model.uloc[:model.norb], np.float64))
             + model.ust * (1.0 - np.eye(model.norb)))
        self.cross = ((self.up.nimp @ w) @ self.dw.nimp.T).astype(dtype)
        self.shape = (self.up.dim, self.dw.dim)
        self.dim = self.up.dim * self.dw.dim

    def apply(self, x: np.ndarray) -> np.ndarray:
        """H x for x of shape [dim] or [dim_up, dim_dw] (H_dw is
        symmetric: X H_dw^T = X H_dw)."""
        x2 = x.reshape(self.shape)
        y = self.up.h @ x2
        y += x2 @ self.dw.h
        y += self.cross * x2
        return y.reshape(x.shape)

    def dense(self) -> np.ndarray:
        """The sector matrix (small sectors and the tests only)."""
        iu, idw = sp.identity(self.up.dim), sp.identity(self.dw.dim)
        h = (sp.kron(self.up.h, idw) + sp.kron(iu, self.dw.h)
             + sp.diags(self.cross.reshape(-1)))
        return np.asarray(h.todense(), dtype=self.dtype)
