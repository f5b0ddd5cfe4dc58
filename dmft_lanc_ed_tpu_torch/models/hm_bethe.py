"""Hubbard model on the Bethe lattice — the designated example workload
(port of ``dmft_lanc_ed_tpu/models/hm_bethe.py``; reference
drivers/edn_hm_bethe.f90).

N-band Hubbard with semicircular DOS: full DMFT self-consistency with chi2
bath fitting, linear or Broyden mixing, optional fixed-density mu search,
and the exact Bethe shortcut Delta = (D/2)^2 G (betheSC flag). The impurity
solves run on ``device``, the card by default (``device=cpu`` to run
without one); the lattice, mixing and fit layers on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_bethe [inputfile] \\
        [NAME=value ...] [device=cpu]
    torchrun --nproc-per-node N -m dmft_lanc_ed_tpu_torch.models.hm_bethe \\
        [inputfile] mesh_shape=N [NAME=value ...]
or programmatically:  run_dmft(cfg, device="cuda") -> DMFTResult

Under torchrun every rank runs the loop, sharding the large sectors of
each solve over the ranks (``mesh_shape``); each rank computes on its own
card, ``cuda:{LOCAL_RANK % cards}``, and rank 0 prints.
"""
from __future__ import annotations

import ast
import dataclasses
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..config import EDConfig, _parse_value, read_input
from ..dmft import (BroydenMixer, ConvergenceCheck, DensitySearch,
                    LinearMixer, bethe_bands, gloc_dos, kinetic_energy_dos,
                    self_consistency)
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


@dataclass
class DMFTResult:
    converged: bool
    iterations: int
    error: float
    dens: np.ndarray
    docc: np.ndarray
    xmu: float
    sigma_mats: np.ndarray
    sigma_real: np.ndarray
    g_mats: np.ndarray
    weiss: np.ndarray
    bath: np.ndarray
    ekin: float = 0.0
    observables: object = None
    history: List[Dict] = field(default_factory=list)


def loop_entry(iloop: int, error: float, res, bath_in: np.ndarray,
               t_fit: float, t0: float, **extra) -> Dict:
    """A DMFT iteration's history entry: its error, dens, docc and Egs,
    the solve's diag / gf seconds, ``timings`` (with the ``kernel_*``
    counters) and GF routing (chain, scan), the fit's seconds, the packed
    bath the solve took, the sector scan's ``diag_log`` (sector, energies,
    Krylov-solved) and the seconds since `t0`, plus `extra`; loop 1's
    also carries its solve's Sigma and G and the whole ``SolveResult``
    (``result``)."""
    entry = dict(iloop=iloop, error=error, dens=res.observables.dens.copy(),
                 docc=res.observables.docc.copy(), egs=res.observables.egs,
                 diag=res.timings["diag"], gf=res.timings["gf"], fit=t_fit,
                 timings=dict(res.timings), routing=res.gf.routing,
                 bath=bath_in, diag_log=res.state_list.diag_log,
                 time=time.perf_counter() - t0, **extra)
    if iloop == 1:
        entry.update(sigma_mats=res.sigma_mats, g_mats=res.g_mats,
                     result=res)
    return entry


def run_dmft(cfg: EDConfig, wband=1.0, h0=None, wmixing: float = 0.5,
             bethe_sc: bool = False, broyden: bool = False,
             n_energies: int = 500, bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    """Full DMFT loop (edn_hm_bethe.f90:104-167 behavior); the history
    entries are :func:`loop_entry`'s, with the loop's xmu."""
    norb = cfg.norb
    ebands, dbands, h0v = bethe_bands(norb, wband, h0, n_energies)
    hloc = np.zeros((cfg.nspin, cfg.nspin, norb, norb))
    for s in range(cfg.nspin):
        hloc[s, s] = np.diag(h0v[:norb])

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
    weiss = None
    res = None

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        if xmu != solver.cfg.xmu:
            solver = EDSolver(cfg.replace(xmu=xmu), hloc, device=device)
        bath_in = np.asarray(bath).copy()
        res = solver.solve(bath)
        gloc = gloc_dos(ebands, dbands, h0v, res.sigma_mats, z, xmu=xmu)
        wb = wband if bethe_sc else None
        weiss = self_consistency(gloc, res.sigma_mats, hloc, z,
                                 sctype=cfg.cg_scheme, xmu=xmu, wbands=wb)
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
            log.info("DMFT loop %02d: err=%.3e dens=%s docc=%s (%.1fs)",
                     iloop, conv.error, np.round(entry["dens"], 6),
                     np.round(entry["docc"], 6), entry["time"])
        if converged and conv.error < cfg.dmft_error:
            break

    ekin = kinetic_energy_dos(ebands, dbands, h0v, res.sigma_mats, wm,
                              cfg.beta, xmu=xmu)
    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath, ekin=ekin,
        observables=res.observables, history=history)


_FIELDS = {f.name: f for f in dataclasses.fields(EDConfig)}


def _cli_value(name: str, raw: str):
    """A command-line value parsed as the input-file parser parses it, so
    ``ed_batch_sectors=F`` is a Fortran logical, not the string 'F'."""
    f = _FIELDS.get(name)
    if f is not None and isinstance(f.default, (bool, str, tuple)):
        ftype = tuple if isinstance(f.default, tuple) else type(f.default)
        return _parse_value(ftype, raw)
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s", datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path = None
    overrides = {}
    extra = {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            k = k.lower()
            if k in ("wband", "wmixing"):
                extra[k] = float(v)
            elif k in ("bethe_sc", "broyden"):
                extra[k] = v.lower() in ("t", "true", "1")
            elif k == "device":
                extra[k] = v
            else:
                overrides[k] = _cli_value(k, v)
        else:
            path = arg
    cfg = read_input(path, **overrides)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # launched by torchrun: join the ranks, compute on this rank's card
        import torch.distributed as dist
        from ..parallel.multihost import init_multihost, rank_device
        device = extra.get("device", "cuda")
        init_multihost(device=device)
        extra["device"] = rank_device(device)
        try:
            result = run_dmft(cfg, **extra)
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) != 0:
            return result
    else:
        result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc} ekin={result.ekin:.6f}")
    return result


if __name__ == "__main__":
    main()
