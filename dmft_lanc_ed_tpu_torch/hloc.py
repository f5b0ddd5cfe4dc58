"""Local-Hamiltonian symmetry decomposition (port of
``dmft_lanc_ed_tpu/hloc.py``, host numpy, copied so this package never
imports the JAX one).

Re-design of ED_HLOC_DECOMPOSITION.f90: expresses the impurity local
Hamiltonian as Hloc = sum_i lambda_i B_i over a symmetric matrix basis
{B_i}. Used by the replica bath (each replica is parameterized by its own
lambda vector over the same basis) and by `set_hloc`-style initialization.

- :func:`decompose_hloc` — auto-extraction: one basis element per nonzero
  upper-triangle entry of the [nspin*norb, nspin*norb] matrix
  (ED_HLOC_DECOMPOSITION.f90:73-176)
- :func:`h_from_sym` — reconstruction sum_i lambda_i B_i (:60-70)
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .config import EDConfig


def nn2so(h: np.ndarray, nspin: int, norb: int) -> np.ndarray:
    """[nspin,nspin,norb,norb] -> [nspin*norb, nspin*norb]."""
    return np.asarray(h).transpose(0, 2, 1, 3).reshape(
        nspin * norb, nspin * norb)


def so2nn(h: np.ndarray, nspin: int, norb: int) -> np.ndarray:
    return np.asarray(h).reshape(nspin, norb, nspin, norb).transpose(
        0, 2, 1, 3)


def decompose_hloc(cfg: EDConfig, hloc: np.ndarray, tol: float = 1e-12
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Auto-extract (h_basis [nsym, nspin,nspin,norb,norb], lambda [nsym]).

    One symmetric basis matrix per distinct nonzero upper-triangle entry of
    the spin-orbital matrix, unit-normalized so lambda carries the value.
    """
    nspin, norb = cfg.nspin, cfg.norb
    nso = nspin * norb
    hso = nn2so(hloc, nspin, norb)
    if not np.allclose(hso, hso.T, atol=tol):
        raise ValueError("hloc must be symmetric for decomposition")
    basis = []
    lams = []
    for i in range(nso):
        for j in range(i, nso):
            if abs(hso[i, j]) > tol:
                b = np.zeros((nso, nso))
                b[i, j] = 1.0
                b[j, i] = 1.0
                if i == j:
                    b[i, i] = 1.0
                basis.append(so2nn(b, nspin, norb))
                lams.append(hso[i, j])
    if not basis:
        # identity fallback so the replica bath always has >= 1 symmetry
        basis.append(so2nn(np.eye(nso), nspin, norb))
        lams.append(0.0)
    return np.stack(basis), np.array(lams)


def h_from_sym(h_basis: np.ndarray, lam: Sequence[float]) -> np.ndarray:
    """Hloc = sum_i lambda_i B_i, in [nspin,nspin,norb,norb] layout."""
    return np.einsum("i,ijklm->jklm", np.asarray(lam, float),
                     np.asarray(h_basis))


def validate_basis(cfg: EDConfig, h_basis: np.ndarray) -> None:
    """Each basis matrix must be symmetric (hermitian, real case)."""
    for i, b in enumerate(np.asarray(h_basis)):
        bso = nn2so(b, cfg.nspin, cfg.norb)
        if not np.allclose(bso, bso.T, atol=1e-12):
            raise ValueError(f"h_basis[{i}] is not symmetric")
