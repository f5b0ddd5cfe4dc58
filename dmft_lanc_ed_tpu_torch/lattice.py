"""Inequivalent-sites (real-space / lattice) solver bank (port of
``dmft_lanc_ed_tpu/lattice.py``).

The reference's lattice driver layer (`ed_solve_lattice[_mpi]`,
ED_MAIN.f90:373-674): N inequivalent impurity problems with per-site
baths, per-site local Hamiltonians and optional per-site interaction
overrides, each an :class:`~.solver.EDSolver`. Where the JAX package puts
site i's compute on ``devices[i % n]`` through ``jax.default_device``,
site i's solver here takes ``devices[i % n]``, a round robin over torch
devices: by default every visible card (with one card every site shares
``cuda:0``); ``device="cpu"`` runs without one. Across processes the
sites go round robin over the ranks (``parallel.multihost.my_sites``) and
the per-site arrays are merged by a zero-fill + sum all-reduce
(:meth:`LatticeSolver.solve_multihost`, the ed_solve_lattice_mpi protocol,
ED_MAIN.f90:603-672; the fit's merge, ED_FIT_CHI2.f90:215-240). Also the
per-site chi2 fit loop with the reference's per-site file suffix
``_ineq<NNNN>`` (ED_MAIN.f90:455).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .config import EDConfig
from .fit import chi2_fitgf
from .ops.factory import resolve_device
from .solver import EDSolver, SolveResult

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def site_devices(device="cuda") -> List[torch.device]:
    """The devices the sites go round robin over: a list as given; "cuda"
    (no index) every visible card; else the one device. Raises for a card
    that is not there."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


@dataclass
class LatticeResult:
    results: List[SolveResult]

    def _stack(self, attr):
        return np.stack([getattr(r, attr) for r in self.results])

    @property
    def sigma_mats(self):      # [nlat, nspin, nspin, norb, norb, L]
        return self._stack("sigma_mats")

    @property
    def sigma_real(self):
        return self._stack("sigma_real")

    @property
    def g_mats(self):
        return self._stack("g_mats")

    @property
    def dens(self):
        return np.stack([r.observables.dens for r in self.results])

    @property
    def docc(self):
        return np.stack([r.observables.docc for r in self.results])

    @property
    def mag(self):
        return np.stack([r.observables.mag for r in self.results])


@dataclass
class LatticeArrays:
    """Merged per-site result arrays of a multi-process lattice solve (the
    AllReduce'd [Nlat, ...] arrays of ED_MAIN.f90:603-672)."""
    sigma_mats: np.ndarray     # [nlat, nspin, nspin, norb, norb, Lmats]
    sigma_real: np.ndarray
    g_mats: np.ndarray
    dens: np.ndarray           # [nlat, norb]
    docc: np.ndarray
    mag: np.ndarray
    egs: np.ndarray            # [nlat]


class LatticeSolver:
    """N-site impurity solver bank (`ed_init_solver` lattice overload)."""

    def __init__(self, cfg: EDConfig, nlat: int,
                 hloc: Optional[np.ndarray] = None,
                 uloc_ii: Optional[np.ndarray] = None,
                 ust_ii: Optional[np.ndarray] = None,
                 jh_ii: Optional[np.ndarray] = None,
                 h_basis=None, lambda_imp=None, device="cuda"):
        """hloc: [nlat, nspin, nspin, norb, norb]; per-site interaction
        overrides Uloc_ii [nlat, norb], Ust_ii [nlat], Jh_ii [nlat]
        (ED_MAIN.f90:377-379,458-460); `device`: as :func:`site_devices`,
        site i on the i % n-th."""
        self.cfg = cfg
        self.nlat = nlat
        devs = site_devices(device)
        self.solvers: List[EDSolver] = []
        for i in range(nlat):
            over = {}
            if uloc_ii is not None:
                over["uloc"] = tuple(uloc_ii[i])
            if ust_ii is not None:
                over["ust"] = float(ust_ii[i])
            if jh_ii is not None:
                over["jh"] = float(jh_ii[i])
            cfg_i = cfg.replace(**over) if over else cfg
            hloc_i = None if hloc is None else hloc[i]
            self.solvers.append(
                EDSolver(cfg_i, hloc_i, h_basis=h_basis,
                         lambda_imp=lambda_imp, device=devs[i % len(devs)]))

    def init_baths(self) -> np.ndarray:
        """[nlat, nb] initial packed baths."""
        return np.stack([s.init_bath() for s in self.solvers])

    def solve(self, baths: np.ndarray, devices=None) -> LatticeResult:
        """Solve all sites, site i on its solver's device, or on
        ``devices[i % n]`` when `devices` is given (which then stays the
        site's device)."""
        if devices is not None:
            devs = site_devices(devices)
            for i, solver in enumerate(self.solvers):
                solver.device = devs[i % len(devs)]
        results = []
        for i, solver in enumerate(self.solvers):
            log.info("lattice site %d/%d on %s", i + 1, self.nlat,
                     solver.device)
            results.append(solver.solve(baths[i]))
        return LatticeResult(results)

    def solve_multihost(self, baths: np.ndarray) -> LatticeArrays:
        """Multi-process lattice solve: each rank solves its round-robin
        subset of the sites and the per-site arrays are merged across the
        ranks (call ``parallel.multihost.init_multihost`` first on every
        rank). Returns the merged [nlat, ...] arrays, identical on every
        rank; the SolveResults of the sites this rank solved stay in
        ``self.local_results``."""
        from .parallel.multihost import allreduce_sites, my_sites
        mine = list(my_sites(self.nlat))
        self.local_results = {}
        for i in mine:
            log.info("lattice site %d/%d (this rank)", i + 1, self.nlat)
            self.local_results[i] = self.solvers[i].solve(baths[i])

        def merge(get, shape, dtype=np.float64):
            return allreduce_sites(
                {i: get(r) for i, r in self.local_results.items()},
                self.nlat, shape, dtype)

        cfg = self.cfg
        gl = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
        return LatticeArrays(
            sigma_mats=merge(lambda r: r.sigma_mats, gl + (cfg.lmats,),
                             np.complex128),
            sigma_real=merge(lambda r: r.sigma_real, gl + (cfg.lreal,),
                             np.complex128),
            g_mats=merge(lambda r: r.g_mats, gl + (cfg.lmats,),
                         np.complex128),
            dens=merge(lambda r: r.observables.dens, (cfg.norb,)),
            docc=merge(lambda r: r.observables.docc, (cfg.norb,)),
            mag=merge(lambda r: r.observables.mag, (cfg.norb,)),
            egs=merge(lambda r: np.float64(r.observables.egs), ()))

    def fit_baths_multihost(self, weiss: np.ndarray, baths: np.ndarray,
                            ispin: Optional[int] = None) -> np.ndarray:
        """Per-site chi2 fit over the ranks, merged (ED_FIT_CHI2.f90:
        215-240)."""
        from .parallel.multihost import allreduce_sites, my_sites
        local = {}
        for i in my_sites(self.nlat):
            local[i] = chi2_fitgf(self.solvers[i].cfg, weiss[i], baths[i],
                                  self.solvers[i].hloc, ispin=ispin,
                                  h_basis=self.solvers[i].h_basis)
        return allreduce_sites(local, self.nlat, baths.shape[1:])

    def fit_baths(self, weiss: np.ndarray, baths: np.ndarray,
                  ispin: Optional[int] = None,
                  outdir: Optional[str] = None) -> np.ndarray:
        """Per-site chi2 fit; weiss: [nlat, nspin, nspin, norb, norb, L].
        With ``outdir`` the fit's files carry the per-site suffix
        ``_ineq<NNNN>`` (ineq_site_suffix + site_indx_padding,
        ED_MAIN.f90:455). Each site's fit seconds are left in
        ``self.fit_seconds``."""
        out = np.empty_like(baths)
        self.fit_seconds = []
        for i, solver in enumerate(self.solvers):
            t0 = time.perf_counter()
            out[i] = chi2_fitgf(solver.cfg, weiss[i], baths[i], solver.hloc,
                                ispin=ispin, h_basis=solver.h_basis,
                                outdir=outdir, suffix=f"_ineq{i + 1:04d}")
            self.fit_seconds.append(time.perf_counter() - t0)
        return out
