"""Single-band Hubbard with the 2D square-lattice (van Hove) DOS (port of
``dmft_lanc_ed_tpu/models/hm_vhs.py``).

Driver for drivers/edn_hm_VHS.f90: the DOS-driven DMFT loop with the
square-lattice density of states (log-divergent at the band center), or a
user-supplied tabulated DOS file (two columns: e, rho(e); the reference's
``dos.dat`` path, edn_hm_VHS.f90:54-73).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_vhs [inputfile] \\
        [NAME=value ...] [ts=X wmixing=X dos_file=PATH] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft.bethe import dens_2dsquare
from .dos_driver import parse_driver_argv, run_dmft_dos
from .hm_bethe import DMFTResult

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def vhs_bands(cfg: EDConfig, ts: float = 1.0, n_energies: int = 500,
              dos_file: Optional[str] = None):
    """[1, Le] square-lattice bands; integral of Dbands normalized to 1."""
    if dos_file:
        data = np.loadtxt(dos_file)
        e, rho = data[:, 0], data[:, 1]
        de = e[1] - e[0]
        return e[None, :], (rho * de)[None, :]
    e = np.linspace(cfg.wini, cfg.wfin, n_energies)
    de = e[1] - e[0]
    return e[None, :], (dens_2dsquare(e, ts) * de)[None, :]


def run_dmft(cfg: EDConfig, ts: float = 1.0, wmixing: float = 0.5,
             n_energies: int = 500, dos_file: Optional[str] = None,
             bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    if not (cfg.norb == 1 and cfg.nspin == 1):
        raise ValueError("VHS driver: norb=1, nspin=1")
    ebands, dbands = vhs_bands(cfg, ts, n_energies, dos_file)
    return run_dmft_dos(cfg, ebands, dbands, np.zeros(1), wmixing=wmixing,
                        bath0=bath0, name="VHS", verbose=verbose,
                        device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("ts", "wmixing"), str_keys=("dos_file",))
    cfg = read_input(path, **overrides)
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc} ekin={result.ekin:.6f}")
    return result


if __name__ == "__main__":
    main()
