"""Two-band Hubbard, two inequivalent sublattices (AFO/AFM ordering)
(port of ``dmft_lanc_ed_tpu/models/hm_2b_afo.py``).

Driver for the reference's edn_hm_2bands_dos_2sites_ineq_AFO.f90 workload:
two orbitals with different bandwidths on a bipartite (Bethe or flat DOS)
lattice, two inequivalent sublattice sites A/B solved as separate impurity
problems (the lattice `ed_solve` overload), coupled through the bipartite
local GF and seeded with an alternating symmetry-breaking field
(break_symmetry_bath with sign (-1)^(ip+1), reference :175-178).

Options mirrored from the reference driver:
- ``wband``      per-orbital half-bandwidths (WBAND, default (1.0, 0.5))
- ``delta``      crystal-field splitting +-delta/2 between the orbitals
- ``dos_model``  "bethe" | "flat" (reference :219-229)
- ``fullsym``    solve only site A; site B self-energy is site A spin-flipped
                 (reference :196-201)
- ``spinsym``    fit spin up only, then spin_symmetrize_bath (reference :224)

The site solves run on ``device``, the card by default (every visible card
round robin; ``device=cpu`` to run without one); the DOS sums, mixing and
fits on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_2b_afo [inputfile] \
        [NAME=value ...] [wband=1.0,0.5 delta=X dos_model=bethe|flat \
        fullsym=T spinsym=T wmixing=X] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import numpy as np

from ..bath import break_symmetry_bath, spin_symmetrize_bath
from ..config import EDConfig, read_input
from ..dmft import ConvergenceCheck, LinearMixer, self_consistency
from ..dmft.bethe import dens_bethe, dens_flat
from ..dmft.gloc import gloc_dos_bipartite
from ..lattice import LatticeSolver
from ..solver import matsubara_grid
from .dos_driver import parse_driver_argv
from .hm_bethe import DMFTResult
from .layered import lattice_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def afo_bands(cfg: EDConfig, wband, dos_model: str, n_energies: int = 500):
    """[Nso, Le] discretized per-spin-orbital bands (reference :93-115)."""
    nso = cfg.nspin * cfg.norb
    ebands = np.zeros((nso, n_energies))
    dbands = np.zeros((nso, n_energies))
    dens = {"bethe": dens_bethe, "flat": dens_flat}[dos_model]
    for s in range(cfg.nspin):
        for a in range(cfg.norb):
            e = np.linspace(-wband[a], wband[a], n_energies)
            de = e[1] - e[0]
            io = s * cfg.norb + a
            ebands[io] = e
            dbands[io] = dens(e, wband[a]) * de
    return ebands, dbands


def run_dmft(cfg: EDConfig, wband=(1.0, 0.5), delta: float = 0.0,
             dos_model: str = "bethe", wmixing: float = 0.5,
             fullsym: bool = False, spinsym: bool = False,
             bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    """The AFO loop; history entries are :func:`~.layered.lattice_entry`'s
    (one site with fullsym)."""
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("AFO driver: norb=2, nspin=2")
    nineq = 1 if fullsym else 2
    ebands, dbands = afo_bands(cfg, wband, dos_model)
    h0 = np.array([-delta / 2, delta / 2] * cfg.nspin)   # [Nso] diagonal
    hloc_site = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    for s in range(cfg.nspin):
        hloc_site[s, s] = np.diag([-delta / 2, delta / 2])
    hloc = np.stack([hloc_site] * nineq)

    lat = LatticeSolver(cfg, nineq, hloc=hloc, device=device)
    if bath0 is None:
        baths = lat.init_baths()
        if not spinsym:
            # spinsym=T zeroes sb_field in the reference driver so the
            # paramagnetic run starts unbroken (reference :89)
            for i in range(nineq):
                baths[i] = break_symmetry_bath(cfg, baths[i], cfg.sb_field,
                                               sign=(-1.0) ** i)
    else:
        baths = np.asarray(bath0).copy()
    wm = matsubara_grid(cfg)
    z = 1j * wm
    mixer = LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    history = []
    res = weiss = None
    converged = False

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        baths_in = baths.copy()
        res = lat.solve(baths)
        sig = res.sigma_mats                       # [nineq, ...]
        if fullsym:   # (site B, s) = (site A, -s), reference :196-201
            sig_b = sig[0][::-1, ::-1].copy()
            smats = np.stack([sig[0], sig_b])
        else:
            smats = sig
        gloc = gloc_dos_bipartite(ebands, dbands, h0, smats, z, xmu=cfg.xmu)
        weiss = np.stack([
            self_consistency(gloc[i], smats[i], hloc_site, z,
                             sctype=cfg.cg_scheme, xmu=cfg.xmu)
            for i in range(nineq)])
        if spinsym:
            # fit only spin-up, then copy up->down (reference :224): saves
            # the spin-down fit that spin_symmetrize_bath would discard
            fitted = lat.fit_baths(weiss, baths, ispin=0)
            baths = mixer(np.stack(
                [spin_symmetrize_bath(cfg, b) for b in fitted]))
        else:
            baths = mixer(lat.fit_baths(weiss, baths))
        gtest = np.mean([weiss[:, 0, 0, a, a] for a in range(cfg.norb)],
                        axis=0).reshape(-1)
        converged = conv(gtest)
        history.append(lattice_entry(iloop, conv.error, res, lat, baths_in,
                                     t0))
        if verbose:
            log.info("AFO loop %02d: err=%.3e dens=%s mag=%s",
                     iloop, conv.error, np.round(res.dens, 5),
                     np.round(res.mag, 5))
        if converged and conv.error < cfg.dmft_error:
            break

    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.dens, docc=res.docc, xmu=cfg.xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=baths,
        observables=res.results[0].observables, history=history)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("wmixing", "delta"),
        bool_keys=("fullsym", "spinsym"), str_keys=("dos_model", "wband"))
    if "wband" in extra:
        extra["wband"] = tuple(float(x) for x in
                               extra["wband"].strip("()").split(","))
    overrides = {"norb": 2, "nspin": 2, **overrides}
    cfg = read_input(path, **overrides)
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc}")
    return result


if __name__ == "__main__":
    main()
