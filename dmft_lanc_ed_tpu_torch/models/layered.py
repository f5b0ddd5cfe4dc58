"""Generic real-space (inequivalent-sites) DMFT loop over an Nlat-block
H(k) (port of ``dmft_lanc_ed_tpu/models/layered.py``).

Shared machinery of the layered and multi-sublattice reference workloads
(edn_bhz_2d_edge.f90, edn_wsm_slab.f90, edn_hm_square_afm2.f90): every
site or layer is an impurity problem of a :class:`~..lattice.LatticeSolver`
bank; the block lattice GF (:func:`~..dmft.gloc.gloc_blocks`) embeds all
self-energies at once; the per-site Weiss fields are fitted independently.
The site solves run on ``device`` (the card by default, every visible card
round robin; ``device="cpu"`` without one); the k-sums, mixing and fits on
the host.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from ..bath import break_symmetry_bath, spin_symmetrize_bath
from ..config import EDConfig
from ..dmft import ConvergenceCheck, LinearMixer
from ..dmft.gloc import gloc_blocks
from ..dmft.selfcons import self_consistency
from ..hloc import decompose_hloc
from ..lattice import LatticeResult, LatticeSolver
from ..solver import matsubara_grid
from .hm_bethe import loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def hloc_blocks_from_hk(hk: np.ndarray, nlat: int, nspin: int,
                        norb: int) -> np.ndarray:
    """Per-site local Hamiltonians = BZ average of the diagonal blocks."""
    nso = nspin * norb
    hmean = hk.mean(axis=0)
    out = np.zeros((nlat, nspin, nspin, norb, norb))
    for il in range(nlat):
        o = il * nso
        blk = hmean[o:o + nso, o:o + nso]
        if not np.allclose(blk.imag, 0.0, atol=1e-10):
            raise ValueError("site Hloc has imaginary parts (real ED)")
        out[il] = blk.real.reshape(nspin, norb, nspin, norb
                                   ).transpose(0, 2, 1, 3)
    return out


def lattice_entry(iloop: int, error: float, res: LatticeResult,
                  bank: LatticeSolver, baths_in: np.ndarray,
                  t0: float) -> dict:
    """A real-space loop's history entry: its error, the sites' dens, docc,
    mag and Egs stacked, the input baths, and ``sites``, one
    :func:`~.hm_bethe.loop_entry` a site (its solve's diag / gf seconds,
    its fit's seconds, its input bath, its ``diag_log``, the device it ran
    on; loop 1's also the site's whole ``SolveResult``)."""
    sites = [loop_entry(iloop, error, r, baths_in[i], bank.fit_seconds[i],
                        t0, device=str(bank.solvers[i].device))
             for i, r in enumerate(res.results)]
    return dict(iloop=iloop, error=error, dens=res.dens.copy(),
                docc=res.docc.copy(), mag=res.mag.copy(),
                egs=np.array([s["egs"] for s in sites]), bath=baths_in,
                sites=sites, time=time.perf_counter() - t0)


def run_layered(cfg: EDConfig, hk: np.ndarray, nlat: int,
                wmixing: float = 0.5, afm_seed: bool = False,
                spinsym: bool = False,
                bath0: Optional[np.ndarray] = None, name: str = "layered",
                verbose: bool = True, device="cuda"):
    """Nlat-site real-space DMFT. Returns (LatticeResult, history,
    converged); history entries are :func:`lattice_entry`'s.

    afm_seed: stagger the initial bath with +-sb_field (AFM workloads;
    skipped when spinsym=True, as the reference drivers zero sb_field for
    paramagnetic runs). spinsym: fit spin up only and copy."""
    hloc_l = hloc_blocks_from_hk(hk, nlat, cfg.nspin, cfg.norb)
    h_basis = lam_imp = None
    if cfg.bath_type == "replica":
        h_basis, lam_imp = decompose_hloc(cfg, hloc_l[0])
    bank = LatticeSolver(cfg, nlat, hloc=hloc_l, h_basis=h_basis,
                         lambda_imp=lam_imp, device=device)
    if bath0 is not None:
        baths = np.asarray(bath0).copy()
    else:
        baths = bank.init_baths()
        if afm_seed and not spinsym:
            for i in range(nlat):
                baths[i] = break_symmetry_bath(cfg, baths[i], cfg.sb_field,
                                               sign=(-1.0) ** i)
    wm = matsubara_grid(cfg)
    z = 1j * wm
    mixer = LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    history: List[dict] = []
    res = None
    converged = False

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        baths_in = baths.copy()
        res = bank.solve(baths)
        sig_ii = res.sigma_mats                       # [Nlat, ...]
        gloc_ii = gloc_blocks(hk, sig_ii, z, xmu=cfg.xmu)
        weiss_ii = np.stack([
            self_consistency(gloc_ii[il], sig_ii[il], hloc_l[il], z,
                             sctype=cfg.cg_scheme, xmu=cfg.xmu)
            for il in range(nlat)])
        if spinsym:
            fitted = bank.fit_baths(weiss_ii, baths, ispin=0)
            baths = mixer(np.stack(
                [spin_symmetrize_bath(cfg, b) for b in fitted]))
        else:
            baths = mixer(bank.fit_baths(weiss_ii, baths))
        gtest = weiss_ii[:, 0, 0, 0, 0].mean(axis=0)
        converged = conv(gtest)
        history.append(lattice_entry(iloop, conv.error, res, bank, baths_in,
                                     t0))
        if verbose:
            log.info("%s loop %02d: err=%.3e dens=%s", name, iloop,
                     conv.error, np.round(res.dens.ravel(), 4))
        if converged and conv.error < cfg.dmft_error:
            break
    return res, history, converged
