"""Local lattice Green's function (dmft_gloc_matsubara/realaxis analogue).

Two flavors:
- :func:`gloc_dos` — DOS integration for orbital-diagonal dispersions
  (Ebands/Dbands form used by the Bethe/square drivers)
- :func:`gloc_hk`  — k-sum of [(z + mu) - H(k) - Sigma(z)]^-1 for full
  multi-orbital Hamiltonians (BHZ & co), fully batched instead of the
  reference's double loop.

The inverse batches run on the host (vectorized LAPACK zgetri via
np.linalg.inv), as in the JAX package: the k-sum is O(L Nk nso^3) with
nso <= 8 for every reference driver, negligible next to the ED solve.
Copied verbatim from ``dmft_lanc_ed_tpu/dmft/gloc.py``.
"""
from __future__ import annotations

import numpy as np


def gloc_dos(ebands: np.ndarray, dbands: np.ndarray, h0: np.ndarray,
             sigma: np.ndarray, z: np.ndarray, xmu: float = 0.0
             ) -> np.ndarray:
    """G_loc for orbital-diagonal dispersion.

    ebands/dbands: [Nso, Le]; sigma: [nspin,nspin,norb,norb,L]; z: [L].
    Returns [nspin,nspin,norb,norb,L] with diagonal entries filled.
    """
    nspin, _, norb, _, L = sigma.shape
    out = np.zeros_like(sigma)
    z = np.asarray(z)
    # plain NumPy: [L, Le] broadcasts are small and host-side
    for s in range(nspin):
        for a in range(norb):
            io = a + s * norb if ebands.shape[0] > norb else a
            e, d = ebands[io], dbands[io]
            zeta = z + xmu - h0[io] - sigma[s, s, a, a]    # [L]
            out[s, s, a, a] = (d[None, :]
                               / (zeta[:, None] - e[None, :])).sum(-1)
    return out


def _gloc_hk_kernel(hk, zeta_mat):
    """hk: [Nk, Nso, Nso]; zeta_mat: [L, Nso, Nso] -> gloc [L, Nso, Nso].

    Host LAPACK, frequency-blocked so the [Lb, Nk, Nso, Nso] inverse batch
    stays cache-sized."""
    L = zeta_mat.shape[0]
    out = np.empty_like(zeta_mat)
    blk = max(1, (1 << 22) // max(hk.nbytes, 1))             # ~4 MB steps
    for i0 in range(0, L, blk):
        zm = zeta_mat[i0:i0 + blk]
        out[i0:i0 + blk] = np.linalg.inv(
            zm[:, None, :, :] - hk[None]).mean(axis=1)
    return out


def gloc_hk(hk: np.ndarray, sigma: np.ndarray, z: np.ndarray,
            xmu: float = 0.0) -> np.ndarray:
    """G_loc = 1/Nk sum_k [(z+mu) I - H(k) - Sigma]^-1.

    hk: [Nk, Nso, Nso] (Nso = nspin*norb); sigma in reference layout.
    """
    nspin, _, norb, _, L = sigma.shape
    nso = nspin * norb
    sig_so = sigma.transpose(0, 2, 1, 3, 4).reshape(nso, nso, L)
    eye = np.eye(nso)
    zeta = ((z + xmu)[:, None, None] * eye[None]
            - sig_so.transpose(2, 0, 1))                     # [L, nso, nso]
    g_so = _gloc_hk_kernel(np.asarray(hk), zeta)
    g = g_so.transpose(1, 2, 0).reshape(nspin, norb, nspin, norb, L)
    return g.transpose(0, 2, 1, 3, 4)


def gloc_blocks(hk: np.ndarray, sigma_ii: np.ndarray, z: np.ndarray,
                xmu: float = 0.0) -> np.ndarray:
    """Site-resolved local GF of an Nlat-block lattice Hamiltonian.

    hk: [Nk, Nlat*nso, Nlat*nso] with per-site blocks in spin-major nso
    layout; sigma_ii: [Nlat, nspin, nspin, norb, norb, L]. Embeds every
    site's self-energy, inverts ([Nk] batch per frequency), and returns the site-diagonal blocks in the same
    shape as sigma_ii. The real-space analogue of dmft_gloc_matsubara
    with tridiag/full inversion (edn_bhz_2d_edge.f90, edn_wsm_slab.f90,
    edn_hm_square_afm2.f90 Gloc construction)."""
    nlat, nspin, _, norb, _, L = sigma_ii.shape
    nso = nspin * norb
    nlso = hk.shape[1]
    assert nlso == nlat * nso, (nlso, nlat, nso)
    sig_lso = np.zeros((L, nlso, nlso), dtype=np.complex128)
    for il in range(nlat):
        o = il * nso
        blk = sigma_ii[il].transpose(0, 2, 1, 3, 4).reshape(nso, nso, L)
        sig_lso[:, o:o + nso, o:o + nso] = blk.transpose(2, 0, 1)
    eye = np.eye(nlso, dtype=np.complex128)
    zeta = (z + xmu)[:, None, None] * eye[None] - sig_lso
    g_lso = _gloc_hk_kernel(np.asarray(hk), zeta)
    out = np.zeros_like(sigma_ii)
    for il in range(nlat):
        o = il * nso
        blk = g_lso[:, o:o + nso, o:o + nso]          # [L, nso, nso]
        out[il] = blk.transpose(1, 2, 0).reshape(
            nspin, norb, nspin, norb, L).transpose(0, 2, 1, 3, 4)
    return out


def gloc_dos_bipartite(ebands: np.ndarray, dbands: np.ndarray,
                       h0: np.ndarray, sigma: np.ndarray, z: np.ndarray,
                       xmu: float = 0.0) -> np.ndarray:
    """G_loc on a bipartite lattice with two sublattices A/B for
    orbital-diagonal dispersion (the AFO/AFM two-site geometry,
    edn_hm_2bands_dos_2sites_ineq_AFO.f90 He_b construction: hopping only
    connects sublattices, so the [2, 2] sublattice block at energy eps is
    [[zeta_A, eps], [eps, zeta_B]] and

        G_A(z) = int deps D(eps) zeta_B / (zeta_A zeta_B - eps^2)

    (and A<->B). sigma: [2, nspin, nspin, norb, norb, L]; returns the same
    shape with the diagonal entries filled.
    """
    nspin, _, norb = sigma.shape[1:4]
    out = np.zeros_like(sigma)
    z = np.asarray(z)
    # NumPy for the same reason as gloc_dos (small host-side integrals)
    for s in range(nspin):
        for a in range(norb):
            io = a + s * norb if ebands.shape[0] > norb else a
            e, d = ebands[io], dbands[io]
            za = z + xmu - h0[io] - sigma[0, s, s, a, a]
            zb = z + xmu - h0[io] - sigma[1, s, s, a, a]
            den = za[:, None] * zb[:, None] - (e ** 2)[None, :]   # [L, Le]
            out[0, s, s, a, a] = (d[None, :] * zb[:, None] / den).sum(-1)
            out[1, s, s, a, a] = (d[None, :] * za[:, None] / den).sum(-1)
    return out
