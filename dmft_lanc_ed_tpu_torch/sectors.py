"""Hilbert-space sector machinery.

Host numpy, copied from ``dmft_lanc_ed_tpu/sectors.py`` (reference sector
layer ED_SETUP.f90:296-980, ED_AUX_FUNX.f90). All enumeration and index-map
construction happens host-side with vectorized numpy bit tricks. Sectors are identified by their quantum
numbers directly (tuples of Nup/Ndw per ud-channel) rather than by a global
linear index — there is no mutable global sector registry.

Conventions (identical to the reference):
- A single-spin Fock state is an integer bitmask over ``ns_orb`` levels; level
  ``p`` (0-based) is bit ``p``. Level layout: impurity orbitals first
  (0..norb-1), bath after, per :func:`bath_stride`
  (ED_SETUP.f90:358-375, here 0-based).
- The sector basis for particle number n is *all* masks with popcount == n in
  increasing integer order (ED_SETUP.f90:745-780).
- Fermionic sign of c_p / c^+_p on mask m is (-1)^(popcount of bits below p)
  (ED_SETUP.f90:805-831).
- A full sector state index is ``i = iup + idw*DimUp (+ iph*DimUp*DimDw)`` —
  up-major, phonon blocks outermost (ED_HAMILTONIAN_SPARSE_HxV.f90).
  As an array the sector vector is shaped ``[DimPh, DimDw, DimUp]`` so
  that reshape(-1) reproduces exactly this linear order.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import comb
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import EDConfig

# Quantum numbers of a sector: (nups, ndws) with one entry per ud-channel.
# ed_total_ud=True -> single channel over all Ns levels.
SectorQN = Tuple[Tuple[int, ...], Tuple[int, ...]]


def qn(nup, ndw) -> SectorQN:
    """Normalize (nup, ndw) ints-or-tuples into a SectorQN."""
    if isinstance(nup, int):
        nup = (nup,)
    if isinstance(ndw, int):
        ndw = (ndw,)
    return (tuple(int(x) for x in nup), tuple(int(x) for x in ndw))


# --------------------------------------------------------------------------
# bit utilities (vectorized)
# --------------------------------------------------------------------------
def popcount(x: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda v: bin(int(v)).count("1"), otypes=[np.int64])(x)


def _popcount_u64(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount via SWAR on int64 (faster than np.vectorize)."""
    x = x.astype(np.uint64)
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    h01 = np.uint64(0x0101010101010101)
    x = x - ((x >> np.uint64(1)) & m1)
    x = (x & m2) + ((x >> np.uint64(2)) & m2)
    x = (x + (x >> np.uint64(4))) & m4
    return ((x * h01) >> np.uint64(56)).astype(np.int64)


def occupations(states: np.ndarray, nlevels: int) -> np.ndarray:
    """[len(states), nlevels] 0/1 occupation table (bdecomp, ED_SETUP.f90:938-949)."""
    bits = (states[:, None] >> np.arange(nlevels)[None, :]) & 1
    return bits.astype(np.int64)


def jw_sign(states: np.ndarray, pos: int) -> np.ndarray:
    """Jordan-Wigner sign (-1)^(#occupied below pos) for each state."""
    below = states & ((1 << pos) - 1)
    return 1 - 2 * (_popcount_u64(below) & 1)


def enumerate_states_np(nlevels: int, nparticles: int) -> np.ndarray:
    """All bitmasks over nlevels with popcount == nparticles, ascending
    (numpy fallback; O(2^nlevels) filter)."""
    allstates = np.arange(1 << nlevels, dtype=np.int64)
    return allstates[_popcount_u64(allstates) == nparticles]


def enumerate_states(nlevels: int, nparticles: int) -> np.ndarray:
    """Sector basis masks, native Gosper enumeration (O(C(n,k)), native/
    edcore.cpp) when the library loads, numpy filter otherwise."""
    if nlevels >= 12:      # native wins above the ctypes call overhead
        from . import native
        out = native.enumerate_states(nlevels, nparticles)
        if out is not None:
            return out
    return enumerate_states_np(nlevels, nparticles)


# --------------------------------------------------------------------------
# bath geometry (ED_SETUP.f90:358-375, 0-based)
# --------------------------------------------------------------------------
def bath_stride(cfg: EDConfig, iorb: int, k: int) -> int:
    """Level index of bath site k (0-based) attached to orbital iorb."""
    if cfg.bath_type == "hybrid":
        return cfg.norb + k
    if cfg.bath_type == "replica":
        return iorb + (k + 1) * cfg.norb
    return cfg.norb + iorb * cfg.nbath + k  # normal


# --------------------------------------------------------------------------
# sector descriptor
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Sector:
    """Static description + basis maps of one (Nup,Ndw) symmetry sector."""

    qn: SectorQN
    ns_orb: int                       # levels per ud-channel
    dim_ph: int
    states_up: Tuple[np.ndarray, ...]  # per ud-channel, sorted masks
    states_dw: Tuple[np.ndarray, ...]

    @property
    def nup(self) -> Tuple[int, ...]:
        return self.qn[0]

    @property
    def ndw(self) -> Tuple[int, ...]:
        return self.qn[1]

    @property
    def dim_ups(self) -> Tuple[int, ...]:
        return tuple(len(s) for s in self.states_up)

    @property
    def dim_dws(self) -> Tuple[int, ...]:
        return tuple(len(s) for s in self.states_dw)

    @property
    def dim_up(self) -> int:
        return int(np.prod(self.dim_ups))

    @property
    def dim_dw(self) -> int:
        return int(np.prod(self.dim_dws))

    @property
    def dim_el(self) -> int:
        return self.dim_up * self.dim_dw

    @property
    def dim(self) -> int:
        return self.dim_el * self.dim_ph

    def __hash__(self):
        return hash((self.qn, self.ns_orb, self.dim_ph))

    def __eq__(self, other):
        return (self.qn, self.ns_orb, self.dim_ph) == (other.qn, other.ns_orb, other.dim_ph)


class SectorTable:
    """Enumerates sectors and caches their bases (replaces getDim/getSector

    lookup tables of ED_VARS_GLOBAL + build_sector of ED_SETUP.f90:745-780).
    """

    def __init__(self, cfg: EDConfig):
        self.cfg = cfg
        self.ns = cfg.ns
        self.ns_ud = cfg.ns_ud
        self.ns_orb = cfg.ns_orb
        self.dim_ph = cfg.dim_ph
        self._basis_cache: Dict[SectorQN, Sector] = {}

    # -- enumeration -------------------------------------------------------
    def all_qns(self) -> List[SectorQN]:
        """All sector quantum numbers, reference scan order.

        The reference enumerates isector=1..Nsectors by the base-(Ns_Orb+1)
        codec over [Nups, Ndws] (ED_SETUP.f90:446-520) with the *first* listed
        QN varying fastest.
        """
        qns: List[SectorQN] = []
        all_digits = np.indices([self.ns_orb + 1] * (2 * self.ns_ud))
        flat = all_digits.reshape(2 * self.ns_ud, -1)
        # Fortran order: first digit fastest
        order = np.lexsort(flat[::-1])
        for col in order:
            vals = flat[:, col].tolist()
            qns.append((tuple(vals[: self.ns_ud]), tuple(vals[self.ns_ud:])))
        return qns

    def sector(self, sqn: SectorQN) -> Sector:
        sqn = (tuple(sqn[0]), tuple(sqn[1]))
        if sqn not in self._basis_cache:
            if self.ns_ud == 1:
                ups = tuple(enumerate_states(self.ns_orb, n) for n in sqn[0])
                dws = tuple(enumerate_states(self.ns_orb, n) for n in sqn[1])
            else:
                # orbital-resolved (ed_total_ud=F): composite masks over the
                # full Ns levels with fixed per-channel particle counts.
                # Working with sorted composite masks lets every downstream
                # component (hop_entries, op_map, observables) apply
                # unchanged (the reference instead nests per-channel index
                # tuples, *_orbs code paths).
                ups = (self._composite_states(sqn[0]),)
                dws = (self._composite_states(sqn[1]),)
            self._basis_cache[sqn] = Sector(
                qn=sqn, ns_orb=self.ns if self.ns_ud > 1 else self.ns_orb,
                dim_ph=self.dim_ph,
                states_up=ups, states_dw=dws)
        return self._basis_cache[sqn]

    def _channel_levels(self, iud: int) -> List[int]:
        """Global level indices of ud-channel iud (breorder geometry)."""
        levels = [iud]
        for k in range(self.cfg.nbath):
            levels.append(bath_stride(self.cfg, iud, k))
        return levels

    def _composite_states(self, counts: Sequence[int]) -> np.ndarray:
        """Sorted full-Ns masks with per-channel popcounts == counts."""
        per_channel = []
        for iud, n in enumerate(counts):
            lvls = np.array(self._channel_levels(iud))
            local = enumerate_states(self.ns_orb, n)
            masks = np.zeros(len(local), dtype=np.int64)
            for j, lv in enumerate(lvls):
                masks |= (((local >> j) & 1) << int(lv))
            per_channel.append(masks)
        combo = per_channel[0]
        for masks in per_channel[1:]:
            combo = (combo[:, None] | masks[None, :]).reshape(-1)
        return np.sort(combo)

    def dim(self, sqn: SectorQN) -> int:
        nups, ndws = sqn
        d = self.dim_ph
        for n in nups:
            d *= comb(self.ns_orb, n)
        for n in ndws:
            d *= comb(self.ns_orb, n)
        return d

    # -- sector ladders (getCsector/getCDGsector, ED_SETUP.f90:377-418) ----
    def c_sector(self, sqn: SectorQN, iud: int, spin: int) -> Optional[SectorQN]:
        """QN after removing one particle of `spin` (0=up,1=dw) in channel iud."""
        nups, ndws = list(sqn[0]), list(sqn[1])
        tgt = nups if spin == 0 else ndws
        if tgt[iud] - 1 < 0:
            return None
        tgt[iud] -= 1
        return (tuple(nups), tuple(ndws))

    def cdg_sector(self, sqn: SectorQN, iud: int, spin: int) -> Optional[SectorQN]:
        """QN after adding one particle of `spin` (0=up,1=dw) in channel iud."""
        nups, ndws = list(sqn[0]), list(sqn[1])
        tgt = nups if spin == 0 else ndws
        if tgt[iud] + 1 > self.ns_orb:
            return None
        tgt[iud] += 1
        return (tuple(nups), tuple(ndws))

    def twin(self, sqn: SectorQN) -> SectorQN:
        """Spin-flipped sector (get_twin_sector, ED_SETUP.f90:905-913)."""
        return (sqn[1], sqn[0])

    # -- helpers -----------------------------------------------------------
    def total_filling(self, sqn: SectorQN) -> int:
        return sum(sqn[0]) + sum(sqn[1])


# --------------------------------------------------------------------------
# single-particle operator maps between sector bases
# --------------------------------------------------------------------------
def op_map(states_src: np.ndarray, states_dst: np.ndarray, pos: int,
           create: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Map of c^+_pos (create) or c_pos on a single-spin basis.

    Returns (idx, sign): for source state j, ``idx[j]`` is the index of the
    image state in ``states_dst`` (or -1 if annihilated), ``sign[j]`` the JW
    sign. Behavior matches c/cdg of ED_SETUP.f90:805-831 followed by
    binary_search on the target map.
    """
    bit = np.int64(1) << pos
    occ = (states_src & bit) != 0
    ok = ~occ if create else occ
    target = np.where(ok, states_src ^ bit, 0)
    idx = np.searchsorted(states_dst, target)
    idx = np.clip(idx, 0, max(len(states_dst) - 1, 0))
    found = ok & (states_dst[idx] == target) if len(states_dst) else np.zeros_like(ok)
    sign = jw_sign(states_src, pos) * found
    return np.where(found, idx, -1).astype(np.int64), sign.astype(np.int64)


def hop_entries(states: np.ndarray, pos_create: int, pos_destroy: int,
                amp: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Matrix entries of amp * c^+_{pos_create} c_{pos_destroy} on one basis.

    Returns (rows, cols, vals) with H[row, col] semantics: the operator acts on
    column (source) state ``j`` producing row state ``i`` — the same
    c-then-cdg composition and sign convention as the stored H builders
    (ED_HAMILTONIAN/stored/H_up.f90, H_dw.f90).
    """
    m = states
    if pos_create != pos_destroy and len(m) >= 512:
        # native C hop kernel (native/edcore.cpp ed_hop_entries): ~4x the
        # numpy throughput on large sector bases, same entry semantics
        # (equivalence-tested in tests/test_native.py)
        from . import native
        out = native.hop_entries_batch(
            m, np.array([pos_create], np.int32),
            np.array([pos_destroy], np.int32),
            np.array([amp], np.float64))
        if out is not None:
            return out
    if pos_create == pos_destroy:
        occ = ((m >> pos_destroy) & 1) == 1
        j = np.nonzero(occ)[0]
        return j, j, np.full(len(j), amp, dtype=np.float64)
    occ_d = ((m >> pos_destroy) & 1) == 1
    emp_c = ((m >> pos_create) & 1) == 0
    ok = occ_d & emp_c
    src = np.nonzero(ok)[0]
    m0 = m[src]
    sgn1 = jw_sign(m0, pos_destroy)
    m1 = m0 ^ (np.int64(1) << pos_destroy)
    sgn2 = jw_sign(m1, pos_create)
    m2 = m1 ^ (np.int64(1) << pos_create)
    rows = np.searchsorted(states, m2)
    vals = amp * (sgn1 * sgn2).astype(np.float64)
    return rows, src, vals


# --------------------------------------------------------------------------
# twin-sector reordering (ED_SETUP.f90:852-915)
# --------------------------------------------------------------------------
def twin_sector_order(sec: Sector) -> np.ndarray:
    """Permutation ordering sector states by their spin-flipped global id.

    ``order[i]`` = rank of the electronic state obtained by swapping up/dw
    occupations, among all sector states — used to reconstruct twin-sector
    eigenvectors (twin_sector_order + flip_state).
    """
    assert len(sec.states_up) == 1, "twin reorder implemented for total_ud"
    up = sec.states_up[0]
    dw = sec.states_dw[0]
    dim_up, dim_dw = len(up), len(dw)
    ns = sec.ns_orb
    iup = np.tile(np.arange(dim_up), dim_dw)
    idw = np.repeat(np.arange(dim_dw), dim_up)
    # flipped state: |{dw}>|{up}> -> global number dw + up*2^ns (flip_state)
    flipped = dw[idw] + (up[iup] << ns)
    order_el = np.argsort(flipped, kind="stable")
    if sec.dim_ph == 1:
        return order_el
    blocks = [order_el + p * dim_up * dim_dw for p in range(sec.dim_ph)]
    return np.concatenate(blocks)
