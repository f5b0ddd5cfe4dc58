"""Carry the JAX package's state across to the port's objects.

Both functions take plain numpy arrays (as the JAX package's objects give
them with ``np.asarray``) and never import the JAX package, so tests can
feed both packages the same bath and the same sector Hamiltonian.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .bath import Bath, unpack_bath
from .config import EDConfig
from .hamiltonian import SectorHamiltonian

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
