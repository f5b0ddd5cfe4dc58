"""VO2 two-band model with phonon-distorted peaked DOS (port of
``dmft_lanc_ed_tpu/models/vo2.py``).

Driver for drivers/edn_VO2model.f90: two orbitals, nspin=1; orbital 1
carries a double-peaked DOS gapped by the lattice distortion x1 through the
electron-lattice coupling lambda (band edges pushed to
+-sqrt(W1^2 + (lambda x1)^2), spectral weight removed from |e| < |lambda x1|),
orbital 2 a Bethe/flat band; the distortion x2 adds a phononic crystal-field
contribution cfp*x2^2 to the orbital splitting delta
(edn_VO2model.f90:58-103). The distortions enter the bands and the crystal
field; a configuration with phonon modes (``nph > 0``, ``g_ph``, ``w0_ph``)
adds the impurity's Holstein terms, solved on the dense operator, as in
the JAX driver.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.vo2 [inputfile] \
        [NAME=value ...] [x1=X x2=X lam=X cfp=X delta=X wband=W1,W2 \
        dos_model=bethe|flat wmixing=X] [device=cpu]
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np

from ..config import EDConfig, read_input
from ..dmft.bethe import dens_bethe, dens_flat
from .dos_driver import parse_driver_argv, run_dmft_dos
from .hm_bethe import DMFTResult

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def dens_peaks(e: np.ndarray, wband: float) -> np.ndarray:
    """Quartic double-peak DOS a e^2 - b e^4 + const on [-W, W]
    (edn_VO2model.f90 dens_peaks_one; a=1.9, b=2.1, normalized)."""
    e = np.asarray(e, dtype=np.float64)
    a, b = 1.9, 2.1
    w = wband
    norm = abs(2 * w * a ** 2 / (15 * b)
               + 4 * w * a * np.sqrt((a / (2 * b)) ** 2
                                     + w ** 2 * (b * w ** 2 - a) / b) / 15
               + 24 * w ** 3 * (b * w ** 2 - a) / 15)
    rho = (a * e ** 2 - b * e ** 4 + w ** 2 * (b * w ** 2 - a)) / norm
    return np.where(np.abs(e) < w, rho, 0.0)


def dens_peaks_phon(e: np.ndarray, wlx: float, wband: float) -> np.ndarray:
    """Peaked DOS folded through the lattice-distortion gap
    E -> sign(E) sqrt(E^2 - (lambda x1)^2) (dens_peaks_phon_one)."""
    e = np.asarray(e, dtype=np.float64)
    eps = 1e-7
    root = np.sqrt(np.maximum(e ** 2 - wlx ** 2, 0.0) + eps)
    jac = np.abs(e) / root
    return jac * dens_peaks(np.sign(e) * np.sqrt(
        np.maximum(e ** 2 - wlx ** 2, 0.0)), wband)


def vo2_bands(cfg: EDConfig, x1: float, lam: float, wband,
              dos_model: str = "bethe", n_energies: int = 500):
    """[2, Le] VO2 bands (edn_VO2model.f90:64-101): orbital 1 on the gapped
    two-branch grid, orbital 2 on a regular grid; each branch of orbital 1
    renormalized to weight 1/2 (the reference's norm1/norm2 loop)."""
    le = n_energies
    wlx = abs(lam * x1)
    www = np.sqrt(wband[0] ** 2 + wlx ** 2)
    ebands = np.zeros((2, le))
    dbands = np.zeros((2, le))
    de1 = (www - wlx) / (le / 2.0 - 1.0)
    half = le // 2
    for i in range(half):
        ebands[0, i] = -www + i * de1
        ebands[0, le - 1 - i] = www - i * de1
    e2 = np.linspace(-wband[1], wband[1], le)
    de2 = e2[1] - e2[0]
    ebands[1] = e2
    if dos_model == "bethe":
        dbands[1] = dens_bethe(e2, wband[1]) * de2
        dbands[0] = dens_peaks_phon(ebands[0], wlx, wband[0]) * de1
    elif dos_model == "flat":
        dbands[0] = dens_flat(ebands[0], wband[0]) * de1
        dbands[1] = dens_flat(e2, wband[1]) * de2
    else:
        raise ValueError("dos_model must be bethe|flat")
    # clip the inverse-sqrt divergence at the folded band edges (:86-90)
    dbands[0] = np.where(dbands[0] / de1 > 20.0, 0.0, dbands[0])
    # renormalize each branch to weight 1/2 (:92-103)
    lower = dbands[0, :half]
    upper = dbands[0, half:]
    n1 = 0.5 * (lower[:-1] + lower[1:]).sum()
    n2 = 0.5 * (upper[:-1] + upper[1:]).sum()
    if n1 > 0:
        dbands[0, :half] = lower / (2.0 * n1)
    if n2 > 0:
        dbands[0, half:] = upper / (2.0 * n2)
    return ebands, dbands


def run_dmft(cfg: EDConfig, x1: float = 0.0, x2: float = 0.0,
             lam: float = 1.0, cfp: float = 0.1, delta: float = 0.0,
             wband=(1.0, 0.5), dos_model: str = "bethe",
             wmixing: float = 0.5, n_energies: int = 500,
             bath0: Optional[np.ndarray] = None,
             verbose: bool = True, device="cuda") -> DMFTResult:
    if not (cfg.norb == 2 and cfg.nspin == 1):
        raise ValueError("VO2 driver: norb=2, nspin=1")
    delta = delta + cfp * x2 ** 2        # phononic crystal field (:58)
    ebands, dbands = vo2_bands(cfg, x1, lam, wband, dos_model, n_energies)
    h0 = np.array([-delta / 2.0, delta / 2.0])
    return run_dmft_dos(cfg, ebands, dbands, h0, wmixing=wmixing,
                        bath0=bath0, name="VO2", verbose=verbose,
                        device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("x1", "x2", "lam", "cfp", "delta", "wmixing"),
        str_keys=("dos_model",))
    if "wband" in overrides:
        extra["wband"] = tuple(np.atleast_1d(overrides.pop("wband")))
    cfg = read_input(path, norb=2, nspin=1, **overrides)
    result = run_dmft(cfg, **extra)
    print(f"converged={result.converged} iterations={result.iterations} "
          f"error={result.error:.3e}")
    print(f"dens={result.dens} docc={result.docc}")
    return result


if __name__ == "__main__":
    main()
