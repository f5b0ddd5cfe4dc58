"""AFM-ordered Hubbard on the bipartite Bethe lattice, nspin=2 (port of
``dmft_lanc_ed_tpu/models/hm_bethe_afm.py``).

Driver for the reference's antiferromagnetic Bethe workloads
(drivers square_afm2 / AFO variants): two sublattices A/B related by spin
flip; the self-consistency couples sublattices,
    Delta_A,s(z) = (D/2)^2 G_B,s(z) = (D/2)^2 G_A,-s(z),
seeded by a symmetry-breaking field (sb_field / break_symmetry_bath). The
impurity solves run on ``device``, the card by default (``device=cpu`` to
run without one).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_bethe_afm [inputfile] \
        [NAME=value ...] [wband=X wmixing=X] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import numpy as np

from ..bath import break_symmetry_bath
from ..config import EDConfig, read_input
from ..dmft import ConvergenceCheck, LinearMixer
from ..fit import chi2_fitgf
from ..solver import EDSolver, matsubara_grid
from .dos_driver import parse_driver_argv
from .hm_bethe import DMFTResult, loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def run_dmft(cfg: EDConfig, wband: float = 1.0, wmixing: float = 0.5,
             bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    """The AFM loop; history entries are :func:`~.hm_bethe.loop_entry`'s,
    with the loop's magnetization ``mag``."""
    if not (cfg.nspin == 2 and cfg.norb == 1):
        raise ValueError("AFM driver: nspin=2, norb=1")
    hloc = np.zeros((2, 2, 1, 1))
    solver = EDSolver(cfg, hloc, device=device)
    bath = solver.init_bath() if bath0 is None else np.asarray(bath0).copy()
    bath = break_symmetry_bath(cfg, bath, cfg.sb_field)
    wm = matsubara_grid(cfg)
    z = 1j * wm
    mixer = LinearMixer(wmixing)
    conv = ConvergenceCheck(cfg.dmft_error, cfg.nsuccess, cfg.nloop)
    history = []
    res = weiss = None
    converged = False
    d2 = (wband / 2.0) ** 2

    for iloop in range(1, cfg.nloop + 1):
        t0 = time.perf_counter()
        bath_in = np.asarray(bath).copy()
        res = solver.solve(bath)
        g = res.g_mats                     # [2,2,1,1,L]
        # AFM Bethe self-consistency: Delta_s = (D/2)^2 G_{-s}
        weiss = np.zeros_like(g)
        for s in range(2):
            delta = d2 * g[1 - s, 1 - s, 0, 0]
            if cfg.cg_scheme == "delta":
                weiss[s, s, 0, 0] = delta
            else:
                weiss[s, s, 0, 0] = 1.0 / (z + cfg.xmu - delta)
        t_fit = time.perf_counter()
        bath = chi2_fitgf(cfg, weiss, bath, hloc)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)
        gtest = weiss[0, 0, 0, 0]
        converged = conv(gtest)
        mag = float(res.observables.mag[0])
        history.append(loop_entry(iloop, conv.error, res, bath_in, t_fit,
                                  t0, mag=mag))
        if verbose:
            log.info("AFM loop %02d: err=%.3e mag=%.6f dens=%.6f",
                     iloop, conv.error, mag, res.observables.dens[0])
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
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("wband", "wmixing"))
    cfg = read_input(path, **{"nspin": 2, **overrides})
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} mag={result.observables.mag[0]:.6f} "
          f"dens={result.dens}")
    return result


if __name__ == "__main__":
    main()
