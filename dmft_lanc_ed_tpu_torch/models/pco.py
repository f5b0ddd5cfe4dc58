"""PCO (perovskite cobaltite / t2g materials) workload — edn_PCO.f90 (port
of ``dmft_lanc_ed_tpu/models/pco.py``).

The reference driver reads a Wannier90 ``*_hr.dat`` tight-binding
Hamiltonian (3 t2g orbitals per site, Nlat sites), builds H(k) on a 3D
grid, and runs bulk or magnetically-ordered DMFT with per-site baths:

- geometry="bulk", zsym="FERRO": all sites equivalent -> one impurity
  (edn_PCO.f90 geometry/z_symmetry dials, :95-97)
- zsym="ANTIFERRO": two sublattices with staggered symmetry breaking,
  solved as inequivalent sites through the Nlat-block lattice GF

Here the same workload runs through :func:`hk_from_w90_hr` +
:mod:`.from_hk` (single site) or :mod:`.layered` (AFM), with the spin
structure embedded spin-degenerately (the reference's normal phase). The
impurity solves run on ``device``, the card by default (``device=cpu`` to
run without one).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.pco <file_hr.dat> [inputfile] \
        [NAME=value ...] [nk=N nlat=N zsym=FERRO|ANTIFERRO wmixing=X] \
        [device=cpu]
"""
from __future__ import annotations

import logging
import sys

import numpy as np

from ..config import EDConfig, read_input
from .dos_driver import parse_driver_argv
from .from_hk import hk_from_w90_hr
from .from_hk import run_dmft as run_dmft_hk
from .layered import run_layered

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def _embed_spin(hk: np.ndarray, nspin: int, nlat: int = 1) -> np.ndarray:
    """[Nk, Nlat*norb, Nlat*norb] orbital-only H(k) -> spin-major Nso
    blocks per site ([ilat, ispin, iorb] ordering)."""
    if nspin == 1:
        return hk
    nk, n, _ = hk.shape
    no = n // nlat
    out = np.zeros((nk, 2 * n, 2 * n), dtype=hk.dtype)
    for il in range(nlat):
        for jl in range(nlat):
            blk = hk[:, il * no:(il + 1) * no, jl * no:(jl + 1) * no]
            oi, oj = il * 2 * no, jl * 2 * no
            out[:, oi:oi + no, oj:oj + no] = blk
            out[:, oi + no:oi + 2 * no, oj + no:oj + 2 * no] = blk.conj()
    return out


def run_dmft(cfg: EDConfig, hr_file: str, nk: int = 8, nlat: int = 1,
             zsym: str = "FERRO", wmixing: float = 0.5,
             verbose: bool = True, device="cuda"):
    """PCO DMFT from a Wannier90 hr file. Returns a DMFTResult (bulk) or
    (LatticeResult, history, converged) for the AFM geometry."""
    hk_orb = hk_from_w90_hr(hr_file, nk=nk)
    nw = hk_orb.shape[1]
    if nw != nlat * cfg.norb:
        raise ValueError(f"hr file has {nw} Wannier functions != "
                         f"nlat*norb = {nlat * cfg.norb}")
    if zsym.upper() == "ANTIFERRO" or nlat > 1:
        hk = _embed_spin(hk_orb, cfg.nspin, nlat)
        return run_layered(cfg, hk, nlat, wmixing=wmixing,
                           afm_seed=zsym.upper() == "ANTIFERRO",
                           name="PCO", verbose=verbose, device=device)
    hk = _embed_spin(hk_orb, cfg.nspin)
    return run_dmft_hk(cfg, hk, wmixing=wmixing, verbose=verbose,
                       device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    hr_file = None
    rest = []
    for arg in argv:
        if arg.endswith("hr.dat"):
            hr_file = arg
        elif arg.startswith("hr_file="):
            hr_file = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    path, overrides, extra = parse_driver_argv(
        rest, float_keys=("wmixing",), str_keys=("zsym",))
    for k in ("nk", "nlat"):
        if k in overrides:
            extra[k] = int(overrides.pop(k))
    if hr_file is None:
        raise SystemExit("usage: pco <file_hr.dat> [input] [NAME=value ...]")
    cfg = read_input(path, **overrides)
    result = run_dmft(cfg, hr_file, **extra)
    if isinstance(result, tuple):           # the AFM geometry
        res, history, converged = result
        print(f"converged={converged} loops={len(history)}")
        print("per-site dens:", np.round(res.dens, 4))
    else:
        print(f"converged={result.converged} dens={result.dens}")
    return result


if __name__ == "__main__":
    main()
