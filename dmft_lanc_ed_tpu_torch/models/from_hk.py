"""DMFT from a user-supplied H(k) — the DFT/Wannier-input workload (port
of ``dmft_lanc_ed_tpu/models/from_hk.py``).

Driver for the edn_DFT.f90 analogue: load a tight-binding Hamiltonian from a
file and run DMFT on it. Accepted formats:

- .npy       : complex array [Nk, Nso, Nso] (Nso = nspin*norb)
- *_hr.dat   : wannier90 real-space listing, Fourier-transformed onto an
               nk^3 grid (:func:`hk_from_w90_hr`; edn_PCO.f90:653-793)

The impurity solves run on ``device``, the card by default (``device=cpu``
to run without one); the k-sum, mixing and fit on the host.

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.from_hk <hk.npy | hk=PATH> \
        [inputfile] [NAME=value ...] [wmixing=X] [device=cpu]
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
from ..dmft.hk import hloc_from_hk
from ..bath import spin_symmetrize_bath
from ..dmft.kinetic import kinetic_energy_hk
from ..fit import chi2_fitgf
from ..hloc import decompose_hloc
from ..solver import EDSolver, matsubara_grid
from .dos_driver import parse_driver_argv
from .hm_bethe import DMFTResult, loop_entry

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def load_hk(path: str, nk: int = 8) -> np.ndarray:
    if path.endswith(".npy"):
        hk = np.load(path)
    elif path.endswith("hr.dat") or path.endswith("_hr.dat"):
        hk = hk_from_w90_hr(path, nk=nk)
    else:
        raise ValueError(f"unsupported H(k) file format: {path}")
    if hk.ndim != 3 or hk.shape[1] != hk.shape[2]:
        raise ValueError(f"H(k) must be [Nk, Nso, Nso]; got {hk.shape}")
    if not np.allclose(hk, hk.conj().transpose(0, 2, 1), atol=1e-10):
        raise ValueError("H(k) is not hermitian")
    return hk.astype(np.complex128)


def read_w90_hr(path: str):
    """Parse a wannier90 ``*_hr.dat`` file.

    Returns (rvecs [Nr, 3] int, hr [Nr, Nw, Nw] complex, ndeg [Nr]).
    Format (the reference's hk_from_w90_hr reader, edn_PCO.f90:653-793):
    comment line; num_wann; nrpts; ceil(nrpts/15) degeneracy lines; then
    one row per (R, i, j): R1 R2 R3 i j Re Im.
    """
    with open(path) as fh:
        lines = fh.read().split("\n")
    num_wann = int(lines[1].split()[0])
    nrpts = int(lines[2].split()[0])
    ndeg: list = []
    row = 3
    while len(ndeg) < nrpts:
        ndeg.extend(int(x) for x in lines[row].split())
        row += 1
    rvecs = np.zeros((nrpts, 3), dtype=np.int64)
    hr = np.zeros((nrpts, num_wann, num_wann), dtype=np.complex128)
    ir = -1
    last_r = None
    for ln in lines[row:]:
        parts = ln.split()
        if len(parts) < 7:
            continue
        r = (int(parts[0]), int(parts[1]), int(parts[2]))
        if r != last_r:
            ir += 1
            last_r = r
            rvecs[ir] = r
        i, j = int(parts[3]) - 1, int(parts[4]) - 1
        hr[ir, i, j] = float(parts[5]) + 1j * float(parts[6])
    if ir + 1 != nrpts:
        raise ValueError(f"hr file: found {ir + 1} R-vectors, expected "
                         f"{nrpts}")
    return rvecs, hr, np.asarray(ndeg, dtype=np.float64)


def hk_from_w90_hr(path: str, nk: int = 8) -> np.ndarray:
    """Fourier-transform a wannier90 hr file onto an nk^3 Monkhorst grid:
    H(k) = sum_R e^{i k.R} H(R) / ndeg_R  (hk_from_w90_hr, edn_PCO.f90:653).
    """
    rvecs, hr, ndeg = read_w90_hr(path)
    fr = np.arange(nk) / nk
    kx, ky, kz = np.meshgrid(fr, fr, fr, indexing="ij")
    kfrac = 2.0 * np.pi * np.stack([kx.ravel(), ky.ravel(), kz.ravel()], 1)
    phase = np.exp(1j * (kfrac @ rvecs.T))            # [Nk, Nr]
    return np.einsum("kr,rij->kij", phase / ndeg[None, :], hr)


def run_dmft(cfg: EDConfig, hk: np.ndarray, wmixing: float = 0.5,
             bath0: Optional[np.ndarray] = None, spinsym: bool = False,
             verbose: bool = True, device="cuda") -> DMFTResult:
    """spinsym: fit spin-up only, then copy up->down (the reference
    drivers' paramagnetic-constraint pattern, edn_triang_pxpy.f90:135-139 —
    also suppresses the spontaneous polarization of degenerate T=0
    multiplets under tiny fit asymmetries). History entries are
    :func:`~.hm_bethe.loop_entry`'s."""
    nso = cfg.nspin * cfg.norb
    if hk.shape[1] != nso:
        raise ValueError(f"H(k) dimension {hk.shape[1]} != nspin*norb = "
                         f"{nso}")
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
        if spinsym and cfg.nspin == 2 and cfg.bath_type != "replica":
            fitted = chi2_fitgf(cfg, weiss, bath, hloc, ispin=0,
                                h_basis=h_basis)
            bath = spin_symmetrize_bath(cfg, fitted)
        else:
            bath = chi2_fitgf(cfg, weiss, bath, hloc, h_basis=h_basis)
        t_fit = time.perf_counter() - t_fit
        bath = mixer(bath)
        gtest = np.mean([weiss[0, 0, a, a] for a in range(cfg.norb)], axis=0)
        converged = conv(gtest)
        history.append(loop_entry(iloop, conv.error, res, bath_in, t_fit,
                                  t0))
        if verbose:
            log.info("from_hk loop %02d: err=%.3e dens=%s",
                     iloop, conv.error, np.round(res.observables.dens, 5))
        if converged and conv.error < cfg.dmft_error:
            break

    ekin = kinetic_energy_hk(hk, res.sigma_mats, wm, cfg.beta, xmu=cfg.xmu)
    return DMFTResult(
        converged=converged, iterations=len(history), error=conv.error,
        dens=res.observables.dens, docc=res.observables.docc, xmu=cfg.xmu,
        sigma_mats=res.sigma_mats, sigma_real=res.sigma_real,
        g_mats=res.g_mats, weiss=weiss, bath=bath, ekin=ekin,
        observables=res.observables, history=history)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    hk_path, rest = None, []
    for arg in argv:
        if arg.endswith(".npy"):
            hk_path = arg
        elif arg.lower().startswith("hk="):
            hk_path = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    if hk_path is None:
        raise SystemExit("usage: from_hk <hk.npy> [input] [NAME=value ...]")
    path, overrides, extra = parse_driver_argv(rest, float_keys=("wmixing",))
    cfg = read_input(path, **overrides)
    hk = load_hk(hk_path)
    result = run_dmft(cfg, hk, **extra)
    print(f"converged={result.converged} dens={result.dens}")
    return result


if __name__ == "__main__":
    main()
