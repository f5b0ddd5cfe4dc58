"""Weyl-semimetal slab — the edn_wsm_slab.f90 workload (port of
``dmft_lanc_ed_tpu/models/wsm_slab.py``).

Real-space DMFT over Ly open layers (y) of the 3D magnetic Weyl model,
periodic in (x, z). Reference model blocks (edn_wsm_slab.f90:74-81,381-427)
in the spin-major [up-o1, up-o2, dw-o1, dw-o2] basis:

    h0(kx,kz) = [Mh - e0 (cos kx + cos kz)] (s0 x oz)
              + lambda [sin kx (sz x ox) + sin kz (sx x ox)]
              + BIA (sy x oy) + bx (sx x oz) + bz (sz x oz)
    t_y       = -e0/2 (s0 x oz) - i lambda/2 (s0 x oy)

bz breaks time reversal (the Weyl-node splitting field); bx and BIA make
the local Hamiltonian spin-off-diagonal and are only supported at 0 (the
real normal-phase ED constraint, as in the reference).

The layer solves run on ``device``, the card by default (``device=cpu``
to run without one).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.wsm_slab [inputfile] \
        [NAME=value ...] [ly=N nk=N mh=X e0=X lam=X bz=X pbc=T] \
        [device=cpu]
"""
from __future__ import annotations

import logging
import sys

import numpy as np

from ..config import EDConfig, read_input
from .dos_driver import parse_driver_argv
from .layered import run_layered

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

_S0 = np.eye(2, dtype=np.complex128)
_SX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_SY = np.array([[0, -1j], [1j, 0]])
_SZ = np.diag([1.0 + 0j, -1.0])

EMAT = np.kron(_S0, _SZ)
SOX = np.kron(_SZ, _SX)
SOY = np.kron(_S0, _SY)
SOZ = np.kron(_SX, _SX)
BXM = np.kron(_SX, _SZ)
BZM = np.kron(_SZ, _SZ)
BIAM = np.kron(_SY, _SY)


def hk_wsm_slab(nk: int, ly: int, mh: float = 1.0, e0: float = 1.0,
                lam: float = 0.3, bz: float = 0.1, bx: float = 0.0,
                bia: float = 0.0, pbc: bool = False) -> np.ndarray:
    """[Nk^2, 4*Ly, 4*Ly] slab Hamiltonian (wsm_edge_model)."""
    k1 = 2.0 * np.pi * (np.arange(nk) / nk) - np.pi
    kxs, kzs = np.meshgrid(k1, k1, indexing="ij")
    kxs, kzs = kxs.ravel(), kzs.ravel()
    nlso = 4 * ly
    t_y = -0.5 * e0 * EMAT - 0.5j * lam * SOY
    hk = np.zeros((len(kxs), nlso, nlso), dtype=np.complex128)
    for i, (kx, kz) in enumerate(zip(kxs, kzs)):
        h0 = ((mh - e0 * (np.cos(kx) + np.cos(kz))) * EMAT
              + lam * (np.sin(kx) * SOX + np.sin(kz) * SOZ)
              + bia * BIAM + bx * BXM + bz * BZM)
        for l in range(ly):
            o = 4 * l
            hk[i, o:o + 4, o:o + 4] = h0
            if l + 1 < ly:
                hk[i, o:o + 4, o + 4:o + 8] = t_y
                hk[i, o + 4:o + 8, o:o + 4] = t_y.conj().T
        if pbc and ly > 2:
            o = 4 * (ly - 1)
            hk[i, o:o + 4, 0:4] = t_y
            hk[i, 0:4, o:o + 4] = t_y.conj().T
    return hk


def run_dmft(cfg: EDConfig, ly: int = 4, mh: float = 1.0, e0: float = 1.0,
             lam: float = 0.3, bz: float = 0.1, nk: int = 10,
             wmixing: float = 0.5, pbc: bool = False, verbose: bool = True,
             device="cuda"):
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("wsm_slab: norb=2, nspin=2")
    hk = hk_wsm_slab(nk, ly, mh=mh, e0=e0, lam=lam, bz=bz, pbc=pbc)
    return run_layered(cfg, hk, ly, wmixing=wmixing, name="wsm_slab",
                       verbose=verbose, device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("mh", "e0", "lam", "bz", "wmixing"),
        bool_keys=("pbc",))
    for k in ("ly", "nk"):
        if k in overrides:
            extra[k] = int(overrides.pop(k))
    cfg = read_input(path, norb=2, nspin=2, bath_type="replica", **overrides)
    res, history, converged = run_dmft(cfg, **extra)
    print(f"converged={converged} loops={len(history)}")
    print("per-layer dens:", np.round(res.dens, 4))
    return res


if __name__ == "__main__":
    main()
