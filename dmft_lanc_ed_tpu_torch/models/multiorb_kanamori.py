"""Multi-orbital Kanamori materials-class workload (port of
``dmft_lanc_ed_tpu/models/multiorb_kanamori.py``).

Driver for the reference's materials-like models (edn_VO2model.f90,
edn_PCO.f90, edn_DFT.f90): Norb in {2,3} orbitals with Kanamori
interaction (Uloc, Ust, Jh, Jx, Jp; Jx/Jp sectors take the dense
operator), user-supplied
crystal-field split local Hamiltonian and per-orbital semicircular or user
DOS, solved with DOS-based local GF. Wannier/DFT input reduces to (Hloc,
per-orbital bands), which this driver accepts directly. The impurity solves
run on ``device``, the card by default (``device=cpu`` to run without
one); the DOS sums, mixing and fit on the host. At ``nbath=3`` the
half-filled (6,6) sector holds 853,776 states and runs on the band-sparse
kernels B2-B4.

Usage (the defaults: norb=3, uloc=2.5,2.5,2.5, ust=1.5, jh=0.5):
    python -m dmft_lanc_ed_tpu_torch.models.multiorb_kanamori \\
        [inputfile] [NAME=value ...] [wband=X wmixing=X \\
        crystal_field=a,b,c] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft import (ConvergenceCheck, LinearMixer, bethe_bands, gloc_dos,
                    kinetic_energy_dos, self_consistency)
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid
from .dos_driver import parse_driver_argv
from .hm_bethe import DMFTResult, loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

# the driver's model (main's defaults when the command line does not set
# them)
DEFAULTS = dict(norb=3, uloc=(2.5, 2.5, 2.5), ust=1.5, jh=0.5)


def run_dmft(cfg: EDConfig, wband=1.0, crystal_field=None,
             ebands: Optional[np.ndarray] = None,
             dbands: Optional[np.ndarray] = None,
             wmixing: float = 0.5, bath0: Optional[np.ndarray] = None,
             n_energies: int = 400, verbose: bool = True,
             device="cuda") -> DMFTResult:
    """The multi-orbital loop; history entries are
    :func:`~.hm_bethe.loop_entry`'s."""
    norb = cfg.norb
    cf = np.zeros(norb) if crystal_field is None else np.asarray(crystal_field)
    if ebands is None:
        ebands, dbands, _ = bethe_bands(norb, wband, cf, n_energies)
    h0 = cf
    hloc = np.zeros((cfg.nspin, cfg.nspin, norb, norb))
    for s in range(cfg.nspin):
        hloc[s, s] = np.diag(cf)

    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_bath() if bath0 is None else np.asarray(bath0).copy()
    wm = matsubara_grid(cfg)
    z = 1j * wm
    mixer = LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    history = []
    res = weiss = None
    converged = False

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        bath_in = np.asarray(bath).copy()
        res = solver.solve(bath)
        gloc = gloc_dos(ebands, dbands, h0, res.sigma_mats, z, xmu=cfg.xmu)
        weiss = self_consistency(gloc, res.sigma_mats, hloc, z,
                                 sctype=cfg.cg_scheme, xmu=cfg.xmu)
        t_fit = time.perf_counter()
        bath = chi2_fitgf(cfg, weiss, bath, hloc)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)
        gtest = np.mean([weiss[0, 0, a, a] for a in range(norb)], axis=0)
        converged = conv(gtest)
        history.append(loop_entry(iloop, conv.error, res, bath_in, t_fit,
                                  t0))
        if verbose:
            log.info("multiorb loop %02d: err=%.3e dens=%s docc=%s",
                     iloop, conv.error, np.round(res.observables.dens, 5),
                     np.round(res.observables.docc, 5))
        if converged and conv.error < cfg.dmft_error:
            break

    ekin = kinetic_energy_dos(ebands, dbands, h0, res.sigma_mats, wm,
                              cfg.beta, xmu=cfg.xmu)
    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=cfg.xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath, ekin=ekin,
        observables=res.observables, history=history)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("wband", "wmixing"))
    if "crystal_field" in overrides:
        extra["crystal_field"] = overrides.pop("crystal_field")
    cfg = read_input(path, **{**DEFAULTS, **overrides})
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations}")
    print(f"dens={result.dens} docc={result.docc} ekin={result.ekin:.6f}")
    return result


if __name__ == "__main__":
    main()
