"""Lattice kinetic energy (dmft_kinetic_energy analogue, DOS form).

E_kin = T sum_n sum_e D(e) e G(e, iw_n) with proper high-frequency tail
correction via the model function G_tail = 1/(iw - e - Re Sigma_inf):
    E_kin = 2/beta sum_n sum_e D(e) e Re[G - G_tail] + sum_e D(e) e f(e*)
(factor 2 = spin degeneracy when nspin == 1).
"""
from __future__ import annotations

import numpy as np


def kinetic_energy_dos(ebands: np.ndarray, dbands: np.ndarray,
                       h0: np.ndarray, sigma_mats: np.ndarray,
                       wm: np.ndarray, beta: float, xmu: float = 0.0
                       ) -> float:
    nspin, _, norb, _, L = sigma_mats.shape
    spin_deg = 2.0 / nspin
    ekin = 0.0
    z = 1j * wm
    for s in range(nspin):
        for a in range(norb):
            io = a + s * norb if ebands.shape[0] > norb else a
            e = ebands[io]
            d = dbands[io]
            sig = sigma_mats[s, s, a, a]
            sig_inf = sig[-1].real
            g = 1.0 / (z[:, None] + xmu - h0[io] - e[None, :] - sig[:, None])
            gt = 1.0 / (z[:, None] + xmu - h0[io] - e[None, :] - sig_inf)
            summand = (e[None, :] * (g - gt).real * d[None, :]).sum()
            ekin += spin_deg * (2.0 / beta) * summand
            # tail: exact free sum with shifted levels
            estar = e + h0[io] + sig_inf - xmu
            fermi = 1.0 / (1.0 + np.exp(np.clip(beta * estar, -500, 500)))
            ekin += spin_deg * (e * fermi * d).sum()
    return float(ekin)


def kinetic_energy_hk(hk: np.ndarray, sigma_mats: np.ndarray,
                      wm: np.ndarray, beta: float, xmu: float = 0.0
                      ) -> float:
    """H(k)-form lattice kinetic energy (dmft_kinetic_energy for the Hk
    drivers): E_kin = 2/(Nk beta) sum_{k,n} Tr[Hk Re(G - G_tail)] + exact
    free tail with the static level Hk + Re Sigma(inf) - mu.

    hk: [Nk, Nso, Nso]; sigma_mats in the reference [nspin,nspin,norb,
    norb,L] layout; spin degeneracy applied when nspin == 1.
    """
    nspin, _, norb, _, L = sigma_mats.shape
    nso = nspin * norb
    spin_deg = 2.0 / nspin
    sig_so = sigma_mats.transpose(0, 2, 1, 3, 4).reshape(nso, nso, L)
    sig_inf = sig_so[..., -1].real
    z = 1j * wm
    eye = np.eye(nso)

    zeta_dyn = ((z + xmu)[:, None, None] * eye[None]
                - sig_so.transpose(2, 0, 1))
    zeta_tail = ((z + xmu)[:, None, None] * eye[None]
                 - sig_inf[None])
    nk = hk.shape[0]
    # host LAPACK, frequency-blocked like dmft.gloc._gloc_hk_kernel so the [Lb, Nk, nso, nso] batch stays
    # cache-sized
    acc = 0.0
    blk = max(1, (1 << 22) // max(hk.nbytes, 1))
    for i0 in range(0, L, blk):
        g = np.linalg.inv(zeta_dyn[i0:i0 + blk, None] - hk[None])
        gt = np.linalg.inv(zeta_tail[i0:i0 + blk, None] - hk[None])
        acc += float(np.einsum("kij,lkji->", hk, (g - gt).real).real)
    ekin = spin_deg * (2.0 / beta) / nk * acc
    # exact tail: eigenbasis of the static Hamiltonian per k
    hstat = hk + sig_inf[None] - xmu * eye[None]
    w, v = np.linalg.eigh(hstat)
    fermi = 1.0 / (1.0 + np.exp(np.clip(beta * w, -500, 500)))
    # Tr[Hk f(Hstat)] = sum_n f_n <v_n|Hk|v_n>
    hv = np.einsum("kin,kij,kjn->kn", v.conj(), hk, v).real
    ekin += spin_deg / nk * float((hv * fermi).sum())
    return float(ekin)
