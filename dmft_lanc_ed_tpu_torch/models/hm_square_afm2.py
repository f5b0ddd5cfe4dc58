"""Hubbard model on the square lattice with a 2-atom AFM basis (port of
``dmft_lanc_ed_tpu/models/hm_square_afm2.py``).

Driver for drivers/edn_hm_square_afm2.f90: two sublattices A/B in the
reduced (magnetic) BZ, coupled only by the inter-sublattice nearest-neighbor
hopping (hk_model, reference :257-271); each sublattice is an inequivalent
impurity seeded with an alternating symmetry-breaking field; the lattice GF
embeds both self-energies through the [2Nso, 2Nso] block inverse.

Options mirrored from the reference:
- ``spinsym``  paramagnetic run: sb_field zeroed, fit spin-up only (:80,174)

The site solves run on ``device``, the card by default (``device=cpu`` to
run without one).

Usage:
    python -m dmft_lanc_ed_tpu_torch.models.hm_square_afm2 [inputfile] \
        [NAME=value ...] [nk=N ts=X wmixing=X spinsym=T] [device=cpu]
"""
from __future__ import annotations

import logging
import sys

import numpy as np

from ..config import EDConfig, read_input
from ..dmft.hk import hk_afm2_square
from .dos_driver import parse_driver_argv
from .layered import run_layered

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def hk_afm2_lso(nk: int, ts: float = 0.25) -> np.ndarray:
    """[Nk, 4, 4] two-sublattice Hamiltonian in the [ilat, ispin] basis
    (norb=1): spin-diagonal embedding of the 2x2 sublattice hk."""
    hk2 = hk_afm2_square(nk, ts)             # [Nk, 2, 2] sublattice
    nk2 = hk2.shape[0]
    hk = np.zeros((nk2, 4, 4), dtype=np.complex128)
    for s in range(2):
        # basis index = ilat*2 + ispin
        hk[:, 0 + s, 0 + s] = hk2[:, 0, 0]
        hk[:, 2 + s, 2 + s] = hk2[:, 1, 1]
        hk[:, 0 + s, 2 + s] = hk2[:, 0, 1]
        hk[:, 2 + s, 0 + s] = hk2[:, 1, 0]
    return hk


def run_dmft(cfg: EDConfig, ts: float = 0.25, nk: int = 20,
             wmixing: float = 0.5, spinsym: bool = False,
             verbose: bool = True, device="cuda"):
    if cfg.norb != 1 or cfg.nspin != 2:
        raise ValueError("afm2 driver: norb=1, nspin=2")
    hk = hk_afm2_lso(nk, ts)
    return run_layered(cfg, hk, 2, wmixing=wmixing, afm_seed=True,
                       spinsym=spinsym, name="afm2", verbose=verbose,
                       device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S")
    argv = argv if argv is not None else sys.argv[1:]
    path, overrides, extra = parse_driver_argv(
        argv, float_keys=("ts", "wmixing"), bool_keys=("spinsym",))
    if "nk" in overrides:
        extra["nk"] = int(overrides.pop("nk"))
    cfg = read_input(path, norb=1, nspin=2, **overrides)
    res, history, converged = run_dmft(cfg, **extra)
    print(f"converged={converged} loops={len(history)}")
    print("dens:", np.round(res.dens.ravel(), 4),
          "mag:", np.round(res.mag.ravel(), 4))
    return res


if __name__ == "__main__":
    main()
