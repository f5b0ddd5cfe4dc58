"""Solver orchestration — the `ed_init_solver` / `ed_solve` API (port of
``dmft_lanc_ed_tpu/solver.py``).

The call sequence inside `solve` mirrors ed_solve_single
(ED_MAIN.f90:259-302):

    set bath -> diagonalize_impurity -> build GF -> observables
             -> local_energy -> Dyson self-energy -> chi, phonon GF

on the solver's ``device`` — the card unless the caller asks for
``device="cpu"``; without a card the solver raises rather than fall back
to the CPU. The sector operators and Krylov chains live there; the sector
tables, eigenstates, GF poles and frequency-grid math
live on the host. Frequency grids match allocate_grids
(ED_AUX_FUNX.f90:278-304): wm = pi/beta (2n+1), wr = linspace(wini, wfin),
tau = [0, beta]. A replica bath takes the symmetry basis `h_basis` and the
impurity's coefficients `lambda_imp` (``hloc.decompose_hloc``). Each solve
resets ``utils.kernel_stats`` and reports its matvecs and the nonzeros
they applied as ``timings["kernel_matvecs"]`` and
``timings["kernel_nnz_applied"]``, and their rates over the diag + gf
seconds as ``timings["kernel_matvecs_per_s"]`` and
``timings["kernel_nnz_per_s"]`` (as the JAX package defines them), and
the two-stage solve's mixed top-off restarts, parity splits and f64
top-offs as ``timings["topoff_restarts"]``, ``["parity_splits"]`` and
``["f64_topoffs"]`` (``diag.topoff_counts``); with ``utils.trace``
recording, each solve is one ``ed.solve`` span with a child for each block of
``timings``. ``restore`` re-seeds a solver from the restart
files ``io.write_all`` writes. ``chispin_flag`` / ``chidens_flag`` add
the spin and charge susceptibilities (``chi.py``), phonons (``nph > 0``)
the displacement GF; ``ed_diag_type="full"`` takes every one of them, and
the GF, from the full spectrum. A solver keeps its band-sparse sector
operators on the device from one solve to the next (``op_cache``,
``ops/op_cache.py``): a later solve refills their bath-dependent values
there, and each solve drops the operators it did not use.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .bath import init_bath, pack_bath, unpack_bath
from .bath_functions import g0and_bath
from .config import EDConfig
from .diag import DiagState, diagonalize_impurity, topoff_counts
from .eigenspace import StateList
from .gf import GFData, HCache, build_gf_full, build_gf_normal, build_sigma
from .ops.factory import resolve_device
from .ops.op_cache import SectorOpCache
from .observables import (Observables, local_energy_impurity,
                          observables_impurity, zimp_simp)
from .sectors import SectorTable
from .utils.observability import kernel_stats, trace

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def matsubara_grid(cfg: EDConfig) -> np.ndarray:
    n = np.arange(cfg.lmats)
    return np.pi / cfg.beta * (2 * n + 1)


def bosonic_grid(cfg: EDConfig) -> np.ndarray:
    n = np.arange(cfg.lmats)
    return np.pi / cfg.beta * (2 * n)


def real_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(cfg.wini, cfg.wfin, cfg.lreal)


def tau_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.beta, cfg.ltau)


@dataclass
class SolveResult:
    """Everything one impurity solve produces (the ED_IO getter surface)."""
    sigma_mats: np.ndarray      # [nspin,nspin,norb,norb,Lmats]
    sigma_real: np.ndarray
    g_mats: np.ndarray
    g_real: np.ndarray
    g0_mats: np.ndarray
    g0_real: np.ndarray
    observables: Observables
    state_list: StateList
    gf: GFData
    chi_spin: Optional[Dict] = None
    chi_dens: Optional[Dict] = None
    gf_phonon: Optional[object] = None
    timings: Dict[str, float] = field(default_factory=dict)


class EDSolver:
    """One impurity solver instance (`ed_init_solver` + `ed_solve`)."""

    def __init__(self, cfg: EDConfig, hloc: Optional[np.ndarray] = None,
                 h_basis: Optional[np.ndarray] = None,
                 lambda_imp: Optional[np.ndarray] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.table = SectorTable(cfg)
        nso = (cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
        self.hloc = np.zeros(nso) if hloc is None else np.asarray(
            hloc, dtype=np.float64)
        self.h_basis = h_basis          # replica symmetry basis
        self.lambda_imp = lambda_imp
        self.diag_state = DiagState(
            lanc_nstates_total=cfg.lanc_nstates_total)
        self.wm = matsubara_grid(cfg)
        self.wr = real_grid(cfg)
        self.last_result: Optional[SolveResult] = None
        # band-sparse sector operators kept across solves (ops/op_cache.py)
        self.op_cache = SectorOpCache()

    # -- checkpoint/restart (reference .restart file protocol) -------------
    def restore(self, workdir: str = ".", suffix: str = ""
                ) -> Optional[np.ndarray]:
        """Re-seed solver state from a reference-style restart directory:
        the state list (``state_list*.restart``, else ``.ed``: the spectrum
        shape, neigen_sector and the sector restriction hints) into
        ``diag_state``, and the bath from ``hamiltonian*.restart``.
        Returns the restored packed bath or None."""
        from . import io as edio
        ctl = edio.read_state_list_restart(self.cfg, outdir=workdir,
                                           suffix=suffix)
        if ctl is not None:
            self.diag_state = ctl
        return edio.read_bath_restart(self.cfg, outdir=workdir, suffix=suffix)

    def init_bath(self) -> np.ndarray:
        """Default bath guess as packed user array (ed_init_solver output)."""
        return pack_bath(self.cfg, init_bath(
            self.cfg, lambda_imp=self.lambda_imp, h_basis=self.h_basis))

    def solve(self, bath) -> SolveResult:
        """One impurity solve on the solver's device. On a card that is not
        the current one the solve runs with it made current: the kernels
        launch on the current device's stream, and CUDA refuses a launch
        into another device's stream."""
        self.op_cache.begin_solve()
        try:
            with trace.span("ed.solve"):
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        return self._solve(bath)
                return self._solve(bath)
        finally:
            self.op_cache.end_solve()

    def _solve(self, bath) -> SolveResult:
        cfg = self.cfg
        t_all = time.perf_counter()
        nsym = self.h_basis.shape[0] if self.h_basis is not None else None
        bath = unpack_bath(cfg, np.asarray(bath), nsym=nsym)
        h_basis = self.h_basis
        kernel_stats.reset()
        timings = {}
        counts0 = dict(topoff_counts)

        def synced_time():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        with trace.span("ed.diag"):
            t0 = synced_time()
            state_list = diagonalize_impurity(
                cfg, self.table, self.hloc, bath, self.diag_state,
                device=self.device, h_basis=h_basis, op_cache=self.op_cache)
            timings["diag"] = synced_time() - t0
        log.info("diag: %d states, Egs=%.12f (%.2fs)", state_list.size,
                 state_list.emin, timings["diag"])

        with trace.span("ed.gf"):
            t0 = synced_time()
            hcache = HCache(cfg, self.table, self.hloc, bath,
                            device=self.device, h_basis=h_basis,
                            op_cache=self.op_cache)
            if cfg.ed_diag_type == "full":
                gf = build_gf_full(cfg, self.table, state_list)
            else:
                gf = build_gf_normal(cfg, self.table, hcache, state_list)
            timings["gf"] = synced_time() - t0

        with trace.span("ed.observables"):
            t0 = time.perf_counter()
            obs = observables_impurity(cfg, self.table, state_list)
            local_energy_impurity(cfg, self.table, state_list, self.hloc,
                                  obs)
            timings["observables"] = time.perf_counter() - t0

        with trace.span("ed.sigma"):
            t0 = time.perf_counter()
            zmats = 1j * self.wm
            zreal = self.wr + 1j * cfg.eps
            sigma_mats, g_mats = build_sigma(cfg, self.hloc, bath, gf, zmats,
                                             h_basis)
            sigma_real, g_real = build_sigma(cfg, self.hloc, bath, gf, zreal,
                                             h_basis)
            g0_mats = g0and_bath(cfg, self.hloc, bath, zmats,
                                 h_basis).numpy()
            g0_real = g0and_bath(cfg, self.hloc, bath, zreal,
                                 h_basis).numpy()
            timings["sigma"] = time.perf_counter() - t0
        obs.zimp, obs.simp = zimp_simp(cfg, sigma_mats, self.wm)

        chi_spin = chi_dens = gf_ph = None
        if cfg.chipair_flag or cfg.chiexct_flag:
            log.warning("chipair/chiexct susceptibilities are disabled in "
                        "the reference live tree (ED_GREENS_FUNCTIONS.f90:"
                        "85-89) and not computed here")
        if cfg.chispin_flag or cfg.chidens_flag or cfg.dim_ph > 1:
            from . import chi as chi_mod
            full = cfg.ed_diag_type == "full"

            def build(name):
                if full:
                    return getattr(chi_mod, f"full_build_{name}")(
                        cfg, self.table, state_list)
                return getattr(chi_mod, f"build_{name}")(
                    cfg, self.table, hcache, state_list)
            with trace.span("ed.chi"):
                t0 = synced_time()
                if cfg.chispin_flag:
                    chi_spin = build("chi_spin")
                if cfg.chidens_flag:
                    chi_dens = build("chi_dens")
                if cfg.dim_ph > 1:
                    gf_ph = build("gf_phonon")
                timings["chi"] = synced_time() - t0
        timings["total"] = time.perf_counter() - t_all
        timings.update({k: n - counts0[k] for k, n in topoff_counts.items()})
        kernel_stats.seconds = timings["diag"] + timings["gf"]
        timings.update({f"kernel_{k}": v
                        for k, v in kernel_stats.summary().items()})

        result = SolveResult(
            sigma_mats=sigma_mats, sigma_real=sigma_real,
            g_mats=g_mats, g_real=g_real, g0_mats=g0_mats, g0_real=g0_real,
            observables=obs, state_list=state_list, gf=gf,
            chi_spin=chi_spin, chi_dens=chi_dens, gf_phonon=gf_ph,
            timings=timings)
        self.last_result = result
        return result

    # -- getters (ED_IO surface) -------------------------------------------
    def get_sigma_matsubara(self):
        return self.last_result.sigma_mats

    def get_sigma_realaxis(self):
        return self.last_result.sigma_real

    def get_gimp_matsubara(self):
        return self.last_result.g_mats

    def get_gimp_realaxis(self):
        return self.last_result.g_real

    def get_g0imp_matsubara(self):
        return self.last_result.g0_mats

    def get_dens(self):
        return self.last_result.observables.dens

    def get_docc(self):
        return self.last_result.observables.docc

    def get_mag(self):
        return self.last_result.observables.mag

    def get_eimp(self):
        o = self.last_result.observables
        return np.array([o.epot, o.eint, o.ehartree, o.eknot])

    def get_doubles(self):
        o = self.last_result.observables
        return np.array([o.dust, o.dund, o.dse, o.dph])

    def get_imp_dm(self):
        return self.last_result.observables.imp_dm
