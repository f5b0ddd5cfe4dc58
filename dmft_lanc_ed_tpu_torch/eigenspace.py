"""Eigenstate store (port of ``dmft_lanc_ed_tpu/eigenspace.py``).

Replacement of ED_EIGENSPACE.f90: a plain Python list of
:class:`EigenState` holding host numpy vectors. Capacity-limited insertion
reproduces `es_add_state` (ED_EIGENSPACE.f90:200-280) for both the T=0
ground-state window and the finite-T top-k list. Vectors live on the host
because every consumer of a stored state is host code (the GF excitation
maps, the observables); the Krylov layers move them to the device.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .sectors import SectorQN


@dataclass
class EigenState:
    qn: SectorQN
    e: float
    vec: np.ndarray            # flat f64 sector vector, reference linear order
    twin: bool = False         # reconstructed twin (vector stored flipped)


@dataclass
class StateList:
    """Energy-ordered eigenstate collection (`state_list` analogue)."""
    states: List[EigenState] = field(default_factory=list)
    max_size: Optional[int] = None   # finite-T capacity (lanc_nstates_total)
    # per-sector diagonalization log [(qn, eigenvalues, lanc_solve)]
    diag_log: List = field(default_factory=list)
    # whether the retained states form a clean energy cut at emax
    clean_cut: bool = True

    @property
    def size(self) -> int:
        return len(self.states)

    @property
    def emin(self) -> float:
        return self.states[0].e if self.states else np.inf

    @property
    def emax(self) -> float:
        return self.states[-1].e if self.states else np.inf

    def add(self, state: EigenState) -> None:
        """Insert keeping energy order; trim to max_size (es_add_state)."""
        keys = [s.e for s in self.states]
        pos = bisect.bisect_right(keys, state.e)
        self.states.insert(pos, state)
        if self.max_size is not None and len(self.states) > self.max_size:
            self.states.pop()

    def gs_degeneracy(self, threshold: float) -> int:
        """Number of states within `threshold` of the minimum."""
        if not self.states:
            return 0
        e0 = self.emin
        return sum(1 for s in self.states if abs(s.e - e0) <= threshold)

    def boltzmann_weights(self, beta: float, finite_t: bool
                          ) -> Tuple[np.ndarray, float]:
        """Per-state weights exp(-beta(E-E0)) and the partition function Z.

        T=0 convention: every retained state weighs 1 and Z = #states
        (ED_DIAG.f90:491-499)."""
        if not self.states:
            return np.zeros(0), 1.0
        e0 = self.emin
        if finite_t:
            w = np.array([np.exp(-beta * (s.e - e0)) for s in self.states])
            return w, float(w.sum())
        w = np.ones(len(self.states))
        return w, float(len(self.states))

    def sectors_contributing(self) -> List[SectorQN]:
        seen, out = set(), []
        for s in self.states:
            if s.qn not in seen:
                seen.add(s.qn)
                out.append(s.qn)
        return out
