"""BHZ ribbon/slab with open edges — real-space (inequivalent-layers) DMFT
(port of ``dmft_lanc_ed_tpu/models/bhz_slab.py``).

Driver for the edn_bhz_2d_edge.f90 / edn_wsm_slab.f90 workload class: the BHZ
model on a ribbon periodic in x with Ly open layers in y. Every layer is an
inequivalent impurity problem (edge layers differ from bulk); the layered
local GF embeds all layer self-energies at once:

    G_l(iw) = 1/Nk sum_kx [((iw+mu) - H(kx) - diag_l' Sigma_l')^-1]_{ll}

Derivation of the layered H(kx) from the BHZ bulk model
(m(k) Gamma5 + lam sin kx Gamma1 + lam sin ky Gamma2):
  on-site:   (M - 4t + 2t cos kx) sz + lam sin kx sx
  y-hopping: -t sz - i (lam/2) sy   (forward; backward = dagger)
per spin, with the spin-down block the kx -> -kx conjugate.

The layer solves run on ``device``, the card by default (``device=cpu``
to run without one); the k-sums, mixing and fits on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.bhz_slab [inputfile] \
        [NAME=value ...] [ly=N nk=N m0=X lam=X t=X wmixing=X] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
import time

import numpy as np

from ..config import EDConfig, read_input
from ..dmft import ConvergenceCheck, LinearMixer
from ..dmft.gloc import _gloc_hk_kernel
from ..dmft.selfcons import self_consistency
from ..hloc import decompose_hloc
from ..lattice import LatticeSolver
from ..solver import matsubara_grid
from .dos_driver import parse_driver_argv
from .layered import lattice_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def hk_bhz_slab(nk: int, ly: int, m0: float = 1.0, lam: float = 0.3,
                t: float = 0.5) -> np.ndarray:
    """[Nk, 4*Ly, 4*Ly] ribbon Hamiltonian; per-layer basis
    [up-orb1, up-orb2, dw-orb1, dw-orb2]."""
    sz = np.diag([1.0, -1.0]).astype(np.complex128)
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])
    ks = 2.0 * np.pi * (np.arange(nk) / nk) - np.pi
    nso = 4 * ly
    hk = np.zeros((nk, nso, nso), dtype=np.complex128)
    hop_up = -t * sz - 0.5j * lam * sy
    for i, kx in enumerate(ks):
        ons_up = (m0 - 4 * t + 2 * t * np.cos(kx)) * sz \
            + lam * np.sin(kx) * sx
        ons_dw = ((m0 - 4 * t + 2 * t * np.cos(-kx)) * sz
                  + lam * np.sin(-kx) * sx).conj()
        hop_dw = (-t * sz - 0.5j * lam * sy).conj()
        for l in range(ly):
            o = 4 * l
            hk[i, o:o + 2, o:o + 2] = ons_up
            hk[i, o + 2:o + 4, o + 2:o + 4] = ons_dw
            if l + 1 < ly:
                o2 = 4 * (l + 1)
                hk[i, o:o + 2, o2:o2 + 2] = hop_up
                hk[i, o2:o2 + 2, o:o + 2] = hop_up.conj().T
                hk[i, o + 2:o + 4, o2 + 2:o2 + 4] = hop_dw
                hk[i, o2 + 2:o2 + 4, o + 2:o + 4] = hop_dw.conj().T
    return hk


def gloc_layers(hk: np.ndarray, sigma_ii: np.ndarray, z: np.ndarray,
                xmu: float = 0.0) -> np.ndarray:
    """Layer-resolved local GF with embedded per-layer self-energies.

    sigma_ii: [Ly, nspin, nspin, norb, norb, L] -> returns same shape.
    """
    ly = sigma_ii.shape[0]
    L = sigma_ii.shape[-1]
    nso = hk.shape[1]
    # embed sigma into the [4*Ly] spin-orbital basis (spin-diagonal blocks)
    sig_so = np.zeros((L, nso, nso), dtype=np.complex128)
    for l in range(ly):
        o = 4 * l
        for s in range(2):
            sig_so[:, o + 2 * s:o + 2 * s + 2, o + 2 * s:o + 2 * s + 2] = \
                sigma_ii[l, s, s].transpose(2, 0, 1)
    # host LAPACK, the frequency-blocked kernel of dmft.gloc.gloc_hk
    zeta = ((np.asarray(z)[:, None, None] + xmu) * np.eye(nso)[None]
            - sig_so)                                   # [L, nso, nso]
    g_all = _gloc_hk_kernel(np.asarray(hk), zeta)
    out = np.zeros_like(sigma_ii)
    for l in range(ly):
        o = 4 * l
        for s in range(2):
            out[l, s, s] = g_all[:, o + 2 * s:o + 2 * s + 2,
                                 o + 2 * s:o + 2 * s + 2].transpose(1, 2, 0)
    return out


def run_dmft(cfg: EDConfig, ly: int = 4, m0: float = 1.0, lam: float = 0.3,
             t: float = 0.5, nk: int = 16, wmixing: float = 0.5,
             verbose: bool = True, device="cuda"):
    """Real-space DMFT over Ly inequivalent layers, one mixer a layer.
    Returns (LatticeResult, history, converged); history entries are
    :func:`~.layered.lattice_entry`'s."""
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("bhz_slab: norb=2, nspin=2")
    hk = hk_bhz_slab(nk, ly, m0=m0, lam=lam, t=t)
    # per-layer local Hamiltonian (edge layers lose neighbors -> same on-site)
    hloc_l = np.zeros((ly, 2, 2, 2, 2))
    hmean = hk.mean(axis=0)
    for l in range(ly):
        o = 4 * l
        blk = hmean[o:o + 4, o:o + 4].real
        hloc_l[l] = blk.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3)
    h_basis, lam_imp = decompose_hloc(cfg, hloc_l[0])

    bank = LatticeSolver(cfg, ly, hloc=hloc_l, h_basis=h_basis,
                         lambda_imp=lam_imp, device=device)
    baths = bank.init_baths()
    wm = matsubara_grid(cfg)
    z = 1j * wm
    mixers = [LinearMixer(wmixing) for _ in range(ly)]
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    history = []
    res = None
    converged = False

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        baths_in = baths.copy()
        res = bank.solve(baths)
        sig_ii = res.sigma_mats                     # [Ly, ...]
        gloc_ii = gloc_layers(hk, sig_ii, z, xmu=cfg.xmu)
        weiss_ii = np.stack([
            self_consistency(gloc_ii[l], sig_ii[l], hloc_l[l], z,
                             sctype=cfg.cg_scheme, xmu=cfg.xmu)
            for l in range(ly)])
        baths = bank.fit_baths(weiss_ii, baths)
        baths = np.stack([mixers[l](baths[l]) for l in range(ly)])
        gtest = weiss_ii[:, 0, 0, 0, 0].mean(axis=0)
        converged = conv(gtest)
        history.append(lattice_entry(iloop, conv.error, res, bank,
                                     baths_in, t0))
        if verbose:
            log.info("slab loop %02d: err=%.3e dens(edge)=%s dens(bulk)=%s",
                     iloop, conv.error, np.round(res.dens[0], 4),
                     np.round(res.dens[ly // 2], 4))
        if converged and conv.error < cfg.dmft_error:
            break
    return res, history, converged


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("m0", "lam", "t", "wmixing"))
    for k in ("ly", "nk"):
        if k in overrides:
            extra[k] = int(overrides.pop(k))
    cfg = read_input(path, **{"norb": 2, "nspin": 2, "bath_type": "replica",
                              **overrides})
    res, history, converged = run_dmft(cfg, **extra)
    print(f"converged={converged} loops={len(history)}")
    print("per-layer dens:", np.round(res.dens, 4))
    return res


if __name__ == "__main__":
    main()
