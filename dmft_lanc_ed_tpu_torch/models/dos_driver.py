"""Generic DOS-driven DMFT loop (port of
``dmft_lanc_ed_tpu/models/dos_driver.py``).

Factor common to every Ebands/Dbands reference driver (edn_hm_VHS.f90,
edn_VO2model.f90, edn_hm_bethe.f90 variants): solve impurity -> DOS-integral
G_loc -> self-consistency -> chi2 fit -> mix, until the Weiss field is
stationary. Model modules supply the discretized bands [Nso, Le] (Dbands
pre-multiplied by the integration measure de) and the diagonal crystal
field H0 [Nso]. The impurity solves run on ``device``, the card by default
(``device="cpu"`` to run without one); the lattice sums, mixing and fit on
the host.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import EDConfig
from ..dmft import (BroydenMixer, ConvergenceCheck, DensitySearch,
                    LinearMixer, gloc_dos, kinetic_energy_dos,
                    self_consistency)
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid
from .hm_bethe import DMFTResult, _cli_value, loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def run_dmft_dos(cfg: EDConfig, ebands: np.ndarray, dbands: np.ndarray,
                 h0: np.ndarray, wmixing: float = 0.5,
                 broyden: bool = False,
                 bath0: Optional[np.ndarray] = None, name: str = "dos",
                 verbose: bool = True, device="cuda") -> DMFTResult:
    """The DOS-driven loop; history entries are
    :func:`~.hm_bethe.loop_entry`'s, with the loop's xmu."""
    norb = cfg.norb
    hloc = np.zeros((cfg.nspin, cfg.nspin, norb, norb))
    for s in range(cfg.nspin):
        hloc[s, s] = np.diag(h0[:norb])

    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_bath() if bath0 is None else np.asarray(bath0).copy()
    wm = matsubara_grid(cfg)
    z = 1j * wm

    mixer = BroydenMixer(wmixing) if broyden else LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    musearch = DensitySearch(cfg.nread, cfg.nerr, cfg.ndelta) \
        if cfg.nread != 0.0 else None
    xmu = cfg.xmu
    history: List[Dict] = []
    converged = False
    weiss = res = None

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        if xmu != solver.cfg.xmu:
            solver = EDSolver(cfg.replace(xmu=xmu), hloc, device=device)
        bath_in = np.asarray(bath).copy()
        res = solver.solve(bath)
        gloc = gloc_dos(ebands, dbands, h0, res.sigma_mats, z, xmu=xmu)
        weiss = self_consistency(gloc, res.sigma_mats, hloc, z,
                                 sctype=cfg.cg_scheme, xmu=xmu)
        t_fit = time.perf_counter()
        bath = chi2_fitgf(solver.cfg, weiss, bath, hloc)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)

        gtest = np.mean([weiss[0, 0, a, a] for a in range(norb)], axis=0)
        converged = conv(gtest)
        if musearch is not None:
            xmu, converged = musearch.update(
                xmu, float(res.observables.dens.sum()), converged)
        entry = loop_entry(iloop, conv.error, res, bath_in, t_fit, t0,
                           xmu=xmu)
        history.append(entry)
        if verbose:
            log.info("%s loop %02d: err=%.3e dens=%s docc=%s (%.1fs)",
                     name, iloop, conv.error, np.round(entry["dens"], 6),
                     np.round(entry["docc"], 6), entry["time"])
        if converged and conv.error < cfg.dmft_error:
            break

    ekin = kinetic_energy_dos(ebands, dbands, h0, res.sigma_mats, wm,
                              cfg.beta, xmu=xmu)
    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath, ekin=ekin,
        observables=res.observables, history=history)


def parse_driver_argv(argv, float_keys=(), bool_keys=(), str_keys=()):
    """Shared NAME=value CLI parsing for driver mains -> (input file path,
    config overrides, the driver's own keyword arguments). Config fields
    are parsed as the input file parses them (``ed_batch_sectors=F`` is a
    Fortran logical); ``device=`` (``cuda`` or ``cpu``) goes to the
    driver."""
    path = None
    overrides = {}
    extra = {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            k = k.lower()
            if k in float_keys:
                extra[k] = float(v)
            elif k in bool_keys:
                extra[k] = v.lower() in ("t", "true", "1")
            elif k in str_keys or k == "device":
                extra[k] = v
            else:
                overrides[k] = _cli_value(k, v)
        else:
            path = arg
    return path, overrides, extra
