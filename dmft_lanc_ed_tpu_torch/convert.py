"""Carry the JAX package's state across to the port's objects.

The functions take plain numpy arrays, or objects read attribute by
attribute through ``np.asarray`` (as the JAX package's objects give them),
and never import the JAX package, so tests can feed both packages the same
bath, the same sector Hamiltonian and the same solve result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .bath import Bath, unpack_bath
from .chi import ChiPoles, PairChiPoles
from .config import EDConfig
from .eigenspace import EigenState, StateList
from .gf import GFData, GFPoles
from .hamiltonian import SectorHamiltonian
from .observables import Observables
from .solver import SolveResult

_H_FIELDS = tuple(f.name for f in dataclasses.fields(SectorHamiltonian))


def bath_from_reference(packed: np.ndarray, cfg: EDConfig,
                        nsym: Optional[int] = None) -> Bath:
    """The JAX package's packed bath (``pack_bath`` layout, identical in
    both packages; any bath type, `nsym` checked against a replica
    bath's N_dec) -> the port's :class:`~.bath.Bath`."""
    return unpack_bath(cfg, np.asarray(packed, np.float64), nsym=nsym)


def hamiltonian_from_reference(fields: Dict[str, Optional[np.ndarray]]
                               ) -> SectorHamiltonian:
    """The JAX package's ``SectorHamiltonian`` fields, as a dict of numpy
    arrays (or None), -> the port's :class:`~.hamiltonian.SectorHamiltonian`
    with the same arrays (copied, dtypes kept)."""
    unknown = set(fields) - set(_H_FIELDS)
    if unknown:
        raise KeyError(f"unknown SectorHamiltonian fields: {sorted(unknown)}")
    return SectorHamiltonian(**{
        k: None if fields.get(k) is None else np.array(fields[k])
        for k in _H_FIELDS})


def _host(x):
    """A field as the JAX package holds it -> numpy (None and Python
    scalars kept as they are)."""
    if x is None or isinstance(x, (int, float, complex)):
        return x
    return np.array(x)


def result_from_reference(res) -> SolveResult:
    """The JAX package's ``SolveResult`` (read attribute by attribute) ->
    the port's :class:`~.solver.SolveResult` with the same arrays: the six
    GF / Sigma arrays, every ``Observables`` field, the state list (its
    states' sectors, energies and vectors, ``diag_log``, capacity and
    clean-cut flag), the GF poles, the susceptibilities and the phonon GF
    (channels that share one pole object keep sharing it) and the
    timings."""
    obs = Observables(**{f.name: _host(getattr(res.observables, f.name))
                         for f in dataclasses.fields(Observables)})
    sl = res.state_list
    states = StateList(max_size=sl.max_size, clean_cut=sl.clean_cut)
    states.states = [EigenState(tuple(tuple(int(n) for n in half)
                                      for half in st.qn),
                                float(st.e), np.array(st.vec, np.float64),
                                bool(st.twin)) for st in sl.states]
    states.diag_log = [(tuple(tuple(int(n) for n in half) for half in q),
                        np.array(e, np.float64), bool(k))
                       for q, e, k in sl.diag_log]
    gf = GFData(channels={tuple(int(i) for i in c): GFPoles(
        np.array(p.weights, np.float64), np.array(p.poles, np.float64))
        for c, p in res.gf.channels.items()})
    memo: Dict[int, object] = {}

    def poles(p):
        """A JAX ChiPoles / PairChiPoles -> the port's, once per object."""
        if p is None:
            return None
        if id(p) not in memo:
            if hasattr(p, "pth"):
                memo[id(p)] = ChiPoles(*(np.array(getattr(p, f), np.float64)
                                         for f in ("peso", "pth", "de",
                                                   "rev")),
                                       beta=float(p.beta))
            else:
                memo[id(p)] = PairChiPoles(
                    *(np.array(getattr(p, f), np.float64)
                      for f in ("peso", "ei", "ej")),
                    zeta=float(p.zeta), beta=float(p.beta))
        return memo[id(p)]

    def chiset(chis):
        if chis is None:
            return None
        return {tuple(int(i) for i in k): poles(v) for k, v in chis.items()}
    arrays = {k: np.array(getattr(res, k)) for k in (
        "sigma_mats", "sigma_real", "g_mats", "g_real", "g0_mats",
        "g0_real")}
    return SolveResult(observables=obs, state_list=states, gf=gf,
                       chi_spin=chiset(res.chi_spin),
                       chi_dens=chiset(res.chi_dens),
                       gf_phonon=poles(res.gf_phonon),
                       timings=dict(res.timings), **arrays)
