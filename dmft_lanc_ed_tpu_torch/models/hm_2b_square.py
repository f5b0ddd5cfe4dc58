"""Two-band Hubbard (+Hund) on the square lattice (port of
``dmft_lanc_ed_tpu/models/hm_2b_square.py``).

Driver for the edn_hm_2b_square.f90 workload: two orbitals with Kanamori
interaction (Uloc, Ust, Jh, Jx, Jp; Jx/Jp sectors take the dense
operator) on an orbital-diagonal square dispersion, DMFT with H(k)-based local GF and chi2
bath fitting. The impurity solves run on ``device``, the card by default
(``device=cpu`` to run without one); the k-sum, mixing and fit on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_2b_square [inputfile] \\
        [NAME=value ...] [nk=N wmixing=X] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft import ConvergenceCheck, LinearMixer, self_consistency
from ..dmft.gloc import gloc_hk
from ..dmft.hk import hk_square, hloc_from_hk
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid
from .dos_driver import parse_driver_argv
from .hm_bethe import DMFTResult, loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def run_dmft(cfg: EDConfig, t=(0.25, 0.25), nk: int = 24,
             wmixing: float = 0.5, bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    """The two-band loop; history entries are
    :func:`~.hm_bethe.loop_entry`'s."""
    if cfg.norb != 2:
        raise ValueError("two-band driver: norb=2")
    hk_orb = hk_square(nk, cfg.norb, t=t)           # [Nk, 2, 2]
    nso = cfg.nspin * cfg.norb
    if cfg.nspin == 1:
        hk = hk_orb
    else:   # embed spin-diagonally
        nk_tot = hk_orb.shape[0]
        hk = np.zeros((nk_tot, nso, nso), dtype=np.complex128)
        hk[:, :2, :2] = hk_orb
        hk[:, 2:, 2:] = hk_orb
    hloc = hloc_from_hk(hk, cfg.nspin, cfg.norb)

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
        gloc = gloc_hk(hk, res.sigma_mats, z, xmu=cfg.xmu)
        weiss = self_consistency(gloc, res.sigma_mats, hloc, z,
                                 sctype=cfg.cg_scheme, xmu=cfg.xmu)
        t_fit = time.perf_counter()
        bath = chi2_fitgf(cfg, weiss, bath, hloc)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)
        gtest = np.mean([weiss[0, 0, a, a] for a in range(cfg.norb)], axis=0)
        converged = conv(gtest)
        history.append(loop_entry(iloop, conv.error, res, bath_in, t_fit,
                                  t0))
        if verbose:
            log.info("2b-square loop %02d: err=%.3e dens=%s docc=%s",
                     iloop, conv.error, np.round(res.observables.dens, 5),
                     np.round(res.observables.docc, 5))
        if converged and conv.error < cfg.dmft_error:
            break

    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=cfg.xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath,
        observables=res.observables, history=history)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(argv, float_keys=("wmixing",))
    if "nk" in overrides:
        extra["nk"] = int(overrides.pop("nk"))
    cfg = read_input(path, **{"norb": 2, **overrides})
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc}")
    return result


if __name__ == "__main__":
    main()
