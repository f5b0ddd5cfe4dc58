"""One DMFT iteration of the plain reference: the sector scan, the
ground-state set, G(iw), Sigma(iw), the Bethe self-consistency's Weiss
field, the bath fit and the mixing, for a normal bath at T = 0.

The sector solves and the Green's function chains run in worker
processes (``spawn``, one BLAS thread each), which import this package
and NumPy/SciPy alone.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass
from multiprocessing import get_context
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import dmft
from .model import Model, SectorOp
from .solve import continued_fraction, excitation, lanczos_chain, \
    lowest_state

Sector = Tuple[int, int]
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@dataclass
class Problem:
    """What an iteration of the reference starts from: the cell's model
    without its bath, the bath handed in, the sectors to scan, and the
    loop's numerical settings."""
    model: Dict            # Model's fields but e and v
    bath: np.ndarray       # packed normal bath of one spin
    sectors: List[Sector]
    beta: float
    lmats: int
    lfit: int
    gf_steps: int
    gs_threshold: float
    wband: float
    n_energies: int
    wmixing: float
    cg_ftol: float
    cg_niter: int


def model_of(p: Problem, bath: Optional[np.ndarray] = None) -> Model:
    nb = dmft.unpack_normal(p.bath if bath is None else bath,
                            p.model["norb"], p.model["nbath"])
    return Model(e=nb["e"], v=nb["v"], **p.model)


def scan_sectors(ns: int, hints: Optional[Sequence[Sector]], shift: int = 1
                 ) -> List[Sector]:
    """Every (nup, ndw) of ns sites a spin, or those within `shift` of a
    hint in both numbers (dmft-lanc-ed's ed_sectors restriction)."""
    out = []
    for nup in range(ns + 1):
        for ndw in range(ns + 1):
            if hints is None or any(abs(nup - h[0]) <= shift and
                                    abs(ndw - h[1]) <= shift for h in hints):
                out.append((nup, ndw))
    return out


# -- worker tasks (module level: they are pickled by name) -----------------
def _sector_task(model: Model, sec: Sector, seed: int, dtype):
    t0 = time.perf_counter()
    op = SectorOp(model, sec[0], sec[1], dtype)
    e, v = lowest_state(op, seed)
    return sec, e, v, time.perf_counter() - t0


def _chain_task(model: Model, sec: Sector, vec: np.ndarray, a: int,
                particle: bool, steps: int, dtype):
    t0 = time.perf_counter()
    op, x = excitation(model, sec[0], sec[1], vec, a, particle, dtype)
    if op is None:
        return a, particle, 0.0, np.zeros(0), np.zeros(0), 0.0
    w, al, be = lanczos_chain(op, x.reshape(-1), steps)
    return a, particle, w, al, be, time.perf_counter() - t0


def _pool(workers: int) -> ProcessPoolExecutor:
    for k in _THREAD_VARS:
        os.environ[k] = "1"
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=get_context("spawn"))


@dataclass
class Solved:
    energies: Dict[Sector, float]
    ground: List[Sector]
    g: np.ndarray          # [norb, lmats]
    sigma: np.ndarray
    gloc: np.ndarray
    weiss: np.ndarray
    seconds: Dict[str, float]


def solve_iteration(p: Problem, seed: int, dtype=np.float64,
                    workers: int = 0) -> Solved:
    """The scan, the ground-state set and the Green's function of the
    bath p.bath, then Sigma, G_loc and the Weiss field, in `dtype`."""
    model = model_of(p)
    workers = workers or min(8, os.cpu_count() or 1)
    cdt = np.complex128 if np.dtype(dtype) == np.float64 else np.complex64
    rdt = np.dtype(dtype).type
    energies: Dict[Sector, float] = {}
    keep: Dict[Sector, Tuple[float, np.ndarray]] = {}
    emin = np.inf
    norb = model.norb
    chains_of: Dict[Sector, list] = {}
    task_s = {"sectors": 0.0, "chains": 0.0}
    t0 = time.perf_counter()
    with _pool(workers) as pool:
        # largest sectors first, so the pool ends together; the chains of
        # a sector start as soon as it may hold the ground state
        order = sorted(p.sectors, key=lambda s: -_dim(model.ns, s))
        futs = [pool.submit(_sector_task, model, s, seed + i, dtype)
                for i, s in enumerate(order)]
        for fut in as_completed(futs):
            sec, e, vec, dt = fut.result()
            energies[sec] = e
            task_s["sectors"] += dt
            if e < emin:
                emin = e
                for s in [s for s, ev in keep.items()
                          if ev[0] > emin + p.gs_threshold]:
                    del keep[s]
                    for f in chains_of.pop(s):
                        f.cancel()
            if e <= emin + p.gs_threshold:
                keep[sec] = (e, vec)
                chains_of[sec] = [
                    pool.submit(_chain_task, model, sec, vec, a, part,
                                p.gf_steps, dtype)
                    for a in range(norb) for part in (True, False)]
        ground = sorted(keep)
        chains = [(s, f.result()) for s in ground for f in chains_of[s]]
    task_s["chains"] = sum(c[-1] for _, c in chains)
    task_s["wall"] = time.perf_counter() - t0
    z = (1j * dmft.matsubara(p.beta, p.lmats)).astype(cdt)
    g = np.zeros((norb, p.lmats), cdt)
    wts = {s: np.exp(-p.beta * (keep[s][0] - emin)) for s in ground}
    zsum = sum(wts.values())
    for s, (a, particle, w, al, be, _) in chains:
        if w == 0.0:
            continue
        e = rdt(keep[s][0])
        if particle:
            part = continued_fraction(z + e, w, al, be)
        else:
            part = -continued_fraction(e - z, w, al, be)
        g[a] += (wts[s] / zsum * part).astype(cdt)
    energies_grid, weights = dmft.bethe_dos(p.wband, p.n_energies)
    energies_grid = energies_grid.astype(rdt)
    weights = weights.astype(rdt)
    sig = np.zeros_like(g)
    gl = np.zeros_like(g)
    wf = np.zeros_like(g)
    mu = rdt(model.xmu)
    for a in range(norb):
        h = rdt(model.hloc[a])
        sig[a] = dmft.sigma(z, mu, h, model.e[a].astype(rdt),
                            model.v[a].astype(rdt), g[a])
        gl[a] = dmft.gloc_bethe(z, mu, h, sig[a], energies_grid, weights)
        wf[a] = dmft.weiss(gl[a], sig[a])
    return Solved(energies=energies, ground=ground, g=g, sigma=sig, gloc=gl,
                  weiss=wf, seconds=task_s)


def fit_and_mix(p: Problem, target: np.ndarray, prev: Optional[np.ndarray],
                dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """(fitted bath, mixed bath) from the bath p.bath, each orbital fitted
    to target [norb, >= lfit] in `dtype`; prev is the mixer's last output
    (None on a run's first iteration)."""
    model = model_of(p)
    e_new = np.zeros_like(model.e)
    v_new = np.zeros_like(model.v)
    for a in range(model.norb):
        e_new[a], v_new[a], _ = dmft.fit_orbital(
            target[a], model.e[a], model.v[a], p.beta, p.lfit, model.xmu,
            model.hloc[a], p.cg_ftol, p.cg_niter, dtype)
    fitted = dmft.pack_normal(e_new, v_new)
    if np.dtype(dtype) != np.float64:
        fitted = fitted.astype(dtype)
        prev = None if prev is None else np.asarray(prev).astype(dtype)
        mixed = (fitted if prev is None else
                 (dtype(p.wmixing) * fitted + dtype(1.0 - p.wmixing) * prev))
        return fitted.astype(np.float64), np.asarray(mixed, np.float64)
    return fitted, dmft.mix(fitted, prev, p.wmixing)


def _dim(ns: int, s: Sector) -> int:
    from math import comb
    return comb(ns, s[0]) * comb(ns, s[1])
