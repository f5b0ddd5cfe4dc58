"""DMFT self-consistency update (dmft_self_consistency analogue).

Produces the next Weiss field / hybridization from (G_loc, Sigma):
    weiss: G0^-1 = G_loc^-1 + Sigma  ->  Weiss = [G_loc^-1 + Sigma]^-1
    delta: Delta = (z + mu) - Hloc - Sigma - G_loc^-1
plus the Bethe shortcut Delta = (D/2)^2 G (wbands form of the driver).
"""
from __future__ import annotations

import numpy as np


def _inv_blocks(g: np.ndarray) -> np.ndarray:
    """Per-spin per-frequency orbital-matrix inverse of [ns,ns,no,no,L]."""
    out = np.zeros_like(g)
    nspin, _, norb, _, L = g.shape
    for s in range(nspin):
        if norb == 1:
            out[s, s, 0, 0] = 1.0 / g[s, s, 0, 0]
        else:
            blk = g[s, s].transpose(2, 0, 1)
            out[s, s] = np.linalg.inv(blk).transpose(1, 2, 0)
    return out


def weiss_from_gloc(gloc: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    return _inv_blocks(_inv_blocks(gloc) + sigma)


def delta_from_gloc(gloc: np.ndarray, sigma: np.ndarray, hloc: np.ndarray,
                    z: np.ndarray, xmu: float = 0.0) -> np.ndarray:
    nspin, _, norb, _, L = gloc.shape
    ginv = _inv_blocks(gloc)
    out = -ginv - sigma
    eye = np.eye(norb)
    for s in range(nspin):
        out[s, s] += ((z + xmu)[None, None, :] * eye[:, :, None]
                      - hloc[s, s][:, :, None])
    return out


def self_consistency(gloc: np.ndarray, sigma: np.ndarray, hloc: np.ndarray,
                     z: np.ndarray, sctype: str = "weiss",
                     xmu: float = 0.0, wbands=None) -> np.ndarray:
    """Next fit target per cg_scheme. wbands given -> Bethe Delta=(D/2)^2 G."""
    if wbands is not None:
        nspin, _, norb, _, L = gloc.shape
        delta = np.zeros_like(gloc)
        wb = np.broadcast_to(np.atleast_1d(wbands), (norb,))
        for s in range(nspin):
            for a in range(norb):
                delta[s, s, a, a] = (wb[a] / 2.0) ** 2 * gloc[s, s, a, a]
        if sctype == "delta":
            return delta
        # weiss from the Bethe delta: G0^-1 = z + mu - Hloc - Delta
        out = np.zeros_like(gloc)
        for s in range(nspin):
            for a in range(norb):
                out[s, s, a, a] = 1.0 / (z + xmu - hloc[s, s, a, a]
                                         - delta[s, s, a, a])
        return out
    if sctype == "delta":
        return delta_from_gloc(gloc, sigma, hloc, z, xmu)
    return weiss_from_gloc(gloc, sigma)
