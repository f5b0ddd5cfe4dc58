"""BHZ 2D topological insulator with interaction — replica-bath DMFT (port
of ``dmft_lanc_ed_tpu/models/bhz_2d.py``; reference drivers
edn_bhz_2d.f90 / edn_bhz_2d_replica.f90).

The Bernevig-Hughes-Zhang 4-band model (2 orbitals x 2 spins) with local
Kanamori interaction, solved with nspin=2, norb=2 and a replica bath whose
symmetry basis is extracted from the local Hamiltonian
(ED_HLOC_DECOMPOSITION set_Hloc path). The impurity solves run on
``device``, the card by default (``device=cpu`` to run without one); the
k-sum, mixing and fit on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.bhz_2d [inputfile] \\
        [NAME=value ...] [nk=N m0=X lam=X t=X wmixing=X] [device=cpu]
or programmatically:  run_dmft(cfg, device="cuda") -> DMFTResult
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
from ..dmft.hk import hk_bhz_2d, hloc_from_hk
from ..fit import chi2_fitgf
from ..hloc import decompose_hloc
from ..solver import EDSolver, matsubara_grid
from .hm_bethe import DMFTResult, _cli_value

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def run_dmft(cfg: EDConfig, m0: float = 1.0, lam: float = 0.3,
             t: float = 0.5, nk: int = 20, wmixing: float = 0.5,
             bath0: Optional[np.ndarray] = None, verbose: bool = True,
             device="cuda") -> DMFTResult:
    """Full DMFT loop (edn_bhz_2d.f90 behavior). Each history entry also
    carries the iteration's Egs, diag / gf / fit seconds, the GF routing
    (chain, scan), the packed bath its solve took and the sector scan's
    ``diag_log``; loop 1's also its solve's Sigma and G."""
    assert cfg.norb == 2 and cfg.nspin == 2, "BHZ needs norb=2, nspin=2"
    hk = hk_bhz_2d(nk, m0=m0, lam=lam, t=t)        # [Nk, 4, 4]
    hloc = hloc_from_hk(hk, cfg.nspin, cfg.norb)

    h_basis = lambda_imp = None
    if cfg.bath_type == "replica":
        h_basis, lambda_imp = decompose_hloc(cfg, hloc)
    solver = EDSolver(cfg, hloc, h_basis=h_basis, lambda_imp=lambda_imp,
                      device=device)
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
        bath = chi2_fitgf(cfg, weiss, bath, hloc, h_basis=h_basis)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)
        gtest = np.stack([weiss[s, s, a, a]
                          for s in range(2) for a in range(2)]).mean(0)
        converged = conv(gtest)
        entry = dict(iloop=iloop, error=conv.error,
                     dens=res.observables.dens.copy(),
                     egs=res.observables.egs,
                     diag=res.timings["diag"], gf=res.timings["gf"],
                     fit=t_fit, routing=res.gf.routing, bath=bath_in,
                     diag_log=res.state_list.diag_log,
                     time=time.perf_counter() - t0)
        if iloop == 1:
            entry.update(sigma_mats=res.sigma_mats, g_mats=res.g_mats,
                         state_list=res.state_list, gf_data=res.gf)
        history.append(entry)
        if verbose:
            log.info("BHZ loop %02d: err=%.3e dens=%s (%.1fs)",
                     iloop, conv.error, np.round(res.observables.dens, 5),
                     entry["time"])
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
    path = None
    overrides = dict(norb=2, nspin=2, bath_type="replica")
    extra = {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            k = k.lower()
            if k == "nk":
                extra[k] = int(v)
            elif k in ("m0", "lam", "t", "wmixing"):
                extra[k] = float(v)
            elif k == "device":
                extra[k] = v
            else:
                overrides[k] = _cli_value(k, v)
        else:
            path = arg
    cfg = read_input(path, **overrides)
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens}")
    return result


if __name__ == "__main__":
    main()
