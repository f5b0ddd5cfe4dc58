"""Bethe-lattice DOS utilities (DMFT_Tools dens_bethe analogue)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def dens_bethe(e: np.ndarray, half_bandwidth: float) -> np.ndarray:
    """Semicircular DOS rho(e) = 2/(pi D) sqrt(1 - (e/D)^2)."""
    x = np.clip(e / half_bandwidth, -1.0, 1.0)
    return 2.0 / (np.pi * half_bandwidth) * np.sqrt(np.maximum(1 - x * x, 0.0))


def bethe_bands(norb: int, wband, h0=None, n_energies: int = 500
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Discretized Bethe bands (Ebands, Dbands, H0) as in edn_hm_bethe.f90:75-79.

    Dbands includes the integration measure de so sum(Dbands) ~= 1.
    """
    wband = np.broadcast_to(np.atleast_1d(np.asarray(wband, float)), (norb,))
    h0 = np.zeros(norb) if h0 is None else np.broadcast_to(
        np.atleast_1d(np.asarray(h0, float)), (norb,))
    ebands = np.zeros((norb, n_energies))
    dbands = np.zeros((norb, n_energies))
    for a in range(norb):
        e = np.linspace(-wband[a], wband[a], n_energies)
        de = e[1] - e[0]
        ebands[a] = e
        dbands[a] = dens_bethe(e, wband[a]) * de
    return ebands, dbands, h0


def dens_flat(e: np.ndarray, half_bandwidth: float) -> np.ndarray:
    """Flat (box) DOS on [-W, W] (SciFortran dens_flat; AFO driver
    dos_model='flat')."""
    e = np.asarray(e, dtype=np.float64)
    return np.where(np.abs(e) <= half_bandwidth,
                    1.0 / (2.0 * half_bandwidth), 0.0)


def dens_2dsquare(e: np.ndarray, ts: float = 1.0) -> np.ndarray:
    """2D square-lattice DOS with the van Hove log singularity at e=0
    (SciFortran dens_2dsquare; used by the VHS workload, edn_hm_VHS.f90:71):

        rho(e) = 1/(2 pi^2 ts) K(1 - (e/4ts)^2),   |e| < 4 ts

    with K the complete elliptic integral of the first kind (m convention).
    """
    from scipy.special import ellipk
    e = np.asarray(e, dtype=np.float64)
    x = e / (4.0 * ts)
    m = np.clip(1.0 - x * x, 0.0, 1.0)
    # guard the K(m->1) log divergence at the band center for grid points
    # landing exactly on 0 (finite grids integrate through it fine)
    m = np.where(m >= 1.0, 1.0 - 1e-15, m)
    rho = ellipk(m) / (2.0 * np.pi ** 2 * ts)
    return np.where(np.abs(x) < 1.0, rho, 0.0)
