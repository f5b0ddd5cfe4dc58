"""BHZ ribbon with open edges — the edn_bhz_2d_edge.f90 workload (port of
``dmft_lanc_ed_tpu/models/bhz_2d_edge.py``).

Real-space DMFT over Ly inequivalent layers, periodic in x. Uses the
reference driver's own (mh, e0, lambda) parametrization and Gamma matrices
(edn_bhz_2d_edge.f90:213-215,335-380) in the spin-major [up-o1, up-o2,
dw-o1, dw-o2] basis:

    h0(kx)   = (mh - e0 cos kx) Gamma5 + lambda sin kx Gamma1
    t_y      = -e0/2 Gamma5 + i lambda/2 Gamma2
    Gamma5 = s0 x oz,  Gamma1 = sz x ox,  Gamma2 = s0 x (-oy)

(:mod:`.bhz_slab` implements the same geometry in the bulk-BHZ (m0, t)
parametrization; this driver matches the edge reference dials.)

The layer solves run on ``device``, the card by default (``device=cpu``
to run without one).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.bhz_2d_edge [inputfile] \
        [NAME=value ...] [ly=N nk=N mh=X e0=X lam=X pbc=T] [device=cpu]
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

G5 = np.kron(_S0, _SZ)
G1 = np.kron(_SZ, _SX)
G2 = np.kron(_S0, -_SY)


def hk_bhz_edge(nk: int, ly: int, mh: float = 1.0, e0: float = 1.0,
                lam: float = 0.3, pbc: bool = False) -> np.ndarray:
    """[Nk, 4*Ly, 4*Ly] ribbon Hamiltonian (bhz_edge_model)."""
    ks = 2.0 * np.pi * (np.arange(nk) / nk) - np.pi
    nlso = 4 * ly
    t_y = -0.5 * e0 * G5 + 0.5j * lam * G2
    hk = np.zeros((nk, nlso, nlso), dtype=np.complex128)
    for i, kx in enumerate(ks):
        h0 = (mh - e0 * np.cos(kx)) * G5 + lam * np.sin(kx) * G1
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
             lam: float = 0.3, nk: int = 16, wmixing: float = 0.5,
             pbc: bool = False, verbose: bool = True,
             device="cuda"):
    if cfg.norb != 2 or cfg.nspin != 2:
        raise ValueError("bhz_edge: norb=2, nspin=2")
    hk = hk_bhz_edge(nk, ly, mh=mh, e0=e0, lam=lam, pbc=pbc)
    return run_layered(cfg, hk, ly, wmixing=wmixing, name="bhz_edge",
                       verbose=verbose, device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("mh", "e0", "lam", "wmixing"), bool_keys=("pbc",))
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
