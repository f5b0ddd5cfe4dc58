"""Square/triangular-lattice H(k) driver family (port of
``dmft_lanc_ed_tpu/models/square_family.py``).

Thin drivers over the generic H(k) DMFT loop (:mod:`.from_hk`) covering the
reference's remaining single-site lattice workloads:

- :func:`run_square`   — plain square lattice (edn_hm_square_lattice.f90)
- :func:`run_2nn`      — square lattice with t' (edn_hm_square_2nn.f90)
- :func:`run_daghofer` — 3-band pnictide model (edn_hm_daghofer.f90)
- :func:`run_pxpy`     — px/py triangular lattice (edn_triang_pxpy.f90)

Each accepts the model dials of its reference driver and ``device`` (the
card by default) and returns the standard DMFTResult.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.square_family \
        <square|2nn|daghofer|pxpy> [inputfile] [NAME=value ...] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft.hk import (hk_daghofer, hk_square, hk_square_2nn,
                       hk_triang_pxpy)
from .dos_driver import parse_driver_argv
from .from_hk import run_dmft as run_dmft_hk
from .hm_bethe import DMFTResult

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def _embed_spin(hk: np.ndarray, nspin: int) -> np.ndarray:
    """[Nk, norb, norb] spin-degenerate block -> [Nk, Nso, Nso]."""
    if nspin == 1:
        return hk
    nk, no, _ = hk.shape
    out = np.zeros((nk, 2 * no, 2 * no), dtype=hk.dtype)
    out[:, :no, :no] = hk
    out[:, no:, no:] = hk.conj()    # h_dw(k) = h_up(-k)^* = h_up(k)^* here
    return out


def run_square(cfg: EDConfig, ts: float = 0.25, nk: int = 20,
               wmixing: float = 0.5, bath0: Optional[np.ndarray] = None,
               verbose: bool = True, device="cuda") -> DMFTResult:
    """Plain 1-band square lattice (edn_hm_square_lattice.f90)."""
    if not cfg.norb == 1:
        raise ValueError("square driver: norb=1")
    hk = _embed_spin(hk_square(nk, 1, t=ts), cfg.nspin)
    return run_dmft_hk(cfg, hk, wmixing=wmixing, bath0=bath0,
                       verbose=verbose, device=device)


def run_2nn(cfg: EDConfig, ts: float = 0.25, tsp: float = 0.0,
            nk: int = 20, wmixing: float = 0.5,
            bath0: Optional[np.ndarray] = None,
            verbose: bool = True, device="cuda") -> DMFTResult:
    """Square lattice with next-nearest hopping (edn_hm_square_2nn.f90)."""
    if not cfg.norb == 1:
        raise ValueError("square_2nn driver: norb=1")
    hk = _embed_spin(hk_square_2nn(nk, ts, tsp), cfg.nspin)
    return run_dmft_hk(cfg, hk, wmixing=wmixing, bath0=bath0,
                       verbose=verbose, device=device)


def run_daghofer(cfg: EDConfig, alpha: float = 1.0, theta: float = 0.0,
                 etanm: float = 0.0, nk: int = 20, wmixing: float = 0.5,
                 bath0: Optional[np.ndarray] = None,
                 verbose: bool = True, device="cuda") -> DMFTResult:
    """Three-band pnictide (Daghofer) model (edn_hm_daghofer.f90)."""
    if not cfg.norb == 3:
        raise ValueError("daghofer driver: norb=3")
    hk = _embed_spin(hk_daghofer(nk, alpha, theta, etanm), cfg.nspin)
    return run_dmft_hk(cfg, hk, wmixing=wmixing, bath0=bath0,
                       verbose=verbose, device=device)


def run_pxpy(cfg: EDConfig, vsigma: float = 1.0, vpi: float = -1.0,
             lam_isb: float = 0.1, lam_soc: float = 0.0, nk: int = 20,
             wmixing: float = 0.75, bath0: Optional[np.ndarray] = None,
             spinsym: bool = True, verbose: bool = True,
             device="cuda") -> DMFTResult:
    """px/py triangular lattice (edn_triang_pxpy.f90); norb=2, nspin=2."""
    if not (cfg.norb == 2 and cfg.nspin == 2):
        raise ValueError("pxpy driver: norb=2, nspin=2")
    hk = hk_triang_pxpy(nk, vsigma, vpi, lam_isb, lam_soc)
    return run_dmft_hk(cfg, hk, wmixing=wmixing, bath0=bath0,
                       spinsym=spinsym, verbose=verbose, device=device)


_MODELS = {"square": (run_square, ("ts", "wmixing")),
           "2nn": (run_2nn, ("ts", "tsp", "wmixing")),
           "daghofer": (run_daghofer, ("alpha", "theta", "etanm",
                                       "wmixing")),
           "pxpy": (run_pxpy, ("vsigma", "vpi", "lam_isb", "lam_soc",
                               "wmixing"))}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] not in _MODELS:
        raise SystemExit(f"usage: square_family <{'|'.join(_MODELS)}> "
                         "[input] [NAME=value ...]")
    run, float_keys = _MODELS[argv.pop(0)]
    path, overrides, extra = parse_driver_argv(argv, float_keys=float_keys)
    if "nk" in overrides:
        extra["nk"] = int(overrides.pop("nk"))
    cfg = read_input(path, **overrides)
    result = run(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc}")
    return result


if __name__ == "__main__":
    main()
