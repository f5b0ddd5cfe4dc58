"""Two-rank dryrun of the multi-process lattice path (port of
``dmft_lanc_ed_tpu/parallel/multihost_dryrun.py``).

Each rank joins the process group (:func:`.multihost.init_multihost`),
solves its round-robin share of a 3-site inequivalent-site problem on its
device and merges the per-site arrays and the per-site fits across the
ranks (``LatticeSolver.solve_multihost`` / ``fit_baths_multihost``, the
ed_solve_lattice_mpi protocol, ED_MAIN.f90:603-672). Rank 0 writes the
merged arrays to ``--out``; every rank must hold the same arrays, equal to
a one-process solve of the same problem (:func:`solve_merged`). The ranks
compute on ``device``: the card by default (``cuda:{rank % cards}``, gloo
where ranks share a card), ``cpu`` without one.

Run as:
    python -m dmft_lanc_ed_tpu_torch.parallel.multihost_dryrun \\
        --coord localhost:PORT --nproc 2 --pid I --out OUT.npz [--device cpu]
(one process per rank), or in one call with
``run_local_ranks(dryrun_rank, 2, args=(device,), device=device)``.
"""
from __future__ import annotations

import argparse

import numpy as np


def lattice_problem():
    """A small 3-site problem with per-site Uloc overrides (3 sites over 2
    ranks: an uneven split exercises the zero-fill merge)."""
    from ..config import EDConfig
    cfg = EDConfig(norb=1, nbath=2, uloc=(2.0,), lmats=16, lreal=8,
                   lanc_dim_threshold=64)
    nlat = 3
    hloc = np.zeros((nlat, 1, 1, 1, 1))
    hloc[1, 0, 0, 0, 0] = 0.15
    uloc_ii = np.array([[2.0], [1.5], [2.5]])
    return cfg, nlat, hloc, uloc_ii


def solve_merged(device="cuda"):
    """(LatticeArrays, fitted baths) of the problem, the sites merged over
    the ranks of the process group (one process: the plain bank)."""
    from ..lattice import LatticeSolver
    cfg, nlat, hloc, uloc_ii = lattice_problem()
    bank = LatticeSolver(cfg, nlat, hloc=hloc, uloc_ii=uloc_ii,
                         device=device)
    baths = bank.init_baths()
    arrays = bank.solve_multihost(baths)
    fitted = bank.fit_baths_multihost(arrays.g_mats, baths)
    return arrays, fitted


def dryrun_rank(rank: int, device="cuda") -> dict:
    """One rank's dryrun inside a joined process group: the merged arrays
    and the device this rank solved on."""
    from .multihost import rank_device
    dev = rank_device(device)
    arrays, fitted = solve_merged(dev)
    return dict(rank=rank, device=str(dev), sigma_mats=arrays.sigma_mats,
                g_mats=arrays.g_mats, dens=arrays.dens, docc=arrays.docc,
                egs=arrays.egs, fitted=fitted)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coord", required=True, help="HOST:PORT of rank 0")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import torch.distributed as dist
    from .multihost import init_multihost
    init_multihost(f"tcp://{a.coord}", a.nproc, a.pid, device=a.device)
    try:
        out = dryrun_rank(a.pid, a.device)
    finally:
        dist.destroy_process_group()
    keys = ("sigma_mats", "g_mats", "dens", "docc", "egs", "fitted") \
        if a.pid == 0 else ("dens", "egs", "fitted")
    np.savez(a.out, **{k: out[k] for k in keys})


if __name__ == "__main__":
    main()
