"""Sector Hamiltonian assembly.

TPU-native re-design of the stored-H layer (ED_HAMILTONIAN_SPARSE_HxV.f90 +
ED_HAMILTONIAN/stored/*.f90). The reference builds 5-7 CSR factors per sector;
here the same tensor-product structure

    H = 1_ph (x) [ D  +  1_dw (x) H_up  +  H_dw (x) 1_up  +  H_nd ]
        + H_ph (x) 1_el  +  X_ph (x) E_eph

becomes static-shape host arrays (copied from
``dmft_lanc_ed_tpu/hamiltonian.py``; the backends in :mod:`.ops` move them
to the device):

- ``diag``        [DimDw, DimUp]  electron diagonal (local + interaction +
                  Hartree + bath levels; stored/H_local.f90)
- ``up_cols/vals``[DimUp, Kup]    ELL form of the up-spin hop factor
                  (stored/H_up.f90: impHloc offdiag + hybridization +
                  replica intra-bath hopping)
- ``dw_cols/vals``[DimDw, Kdw]    same for down spin (stored/H_dw.f90)
- ``nd_*``        spin-exchange/pair-hopping as a sum of tensor products of
                  single-spin partial permutations (stored/H_non_local.f90) —
                  each factor is a gather map, NOT a full DimUp*DimDw matrix
- ``ph_diag``     [DimPh]         w0*n   (stored/H_ph.f90)
- ``eph_el``      [DimDw, DimUp]  sum_a g_a (n_a - 1)  (stored/H_e_ph.f90)
- ``eph_x``       [DimPh, DimPh]  displacement matrix b+b^+

The assembly is host-side vectorized numpy (one pass per physical term, no
per-state Python loops); the result is a frozen dataclass of numpy arrays
that the backends in :mod:`.ops` repack (dense factors, band-sparse slabs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .bath import Bath, bath_levels
from .config import EDConfig
from .sectors import Sector, bath_stride, hop_entries, occupations


@dataclass(frozen=True)
class SectorHamiltonian:
    """ELL tensor-product factor tables for one sector (host numpy)."""
    diag: np.ndarray                      # [DimDw, DimUp]
    up_cols: np.ndarray                   # [DimUp, Kup] int32
    up_vals: np.ndarray                   # [DimUp, Kup]
    dw_cols: np.ndarray                   # [DimDw, Kdw] int32
    dw_vals: np.ndarray                   # [DimDw, Kdw]
    # non-local tensor-product terms: stacked gather maps [T, Dim*]
    nd_up_src: Optional[np.ndarray] = None    # [T, DimUp] int32 (or None)
    nd_up_val: Optional[np.ndarray] = None    # [T, DimUp]
    nd_dw_src: Optional[np.ndarray] = None    # [T, DimDw] int32
    nd_dw_val: Optional[np.ndarray] = None    # [T, DimDw]
    # phonons
    ph_diag: Optional[np.ndarray] = None      # [DimPh]
    eph_el: Optional[np.ndarray] = None       # [DimDw, DimUp]
    eph_x: Optional[np.ndarray] = None        # [DimPh, DimPh]

    @property
    def dim_up(self) -> int:
        return self.diag.shape[1]

    @property
    def dim_dw(self) -> int:
        return self.diag.shape[0]

    @property
    def dim_ph(self) -> int:
        return 1 if self.ph_diag is None else self.ph_diag.shape[0]

    @property
    def dim(self) -> int:
        return self.dim_up * self.dim_dw * self.dim_ph

    @property
    def nnz(self) -> int:
        """Number of stored nonzeros applied per matvec (for nnz/s metrics)."""
        n = self.diag.size * self.dim_ph
        n += int((np.asarray(self.up_vals) != 0).sum()) * self.dim_dw * self.dim_ph
        n += int((np.asarray(self.dw_vals) != 0).sum()) * self.dim_up * self.dim_ph
        if self.nd_up_val is not None:
            nd = (np.asarray(self.nd_up_val) != 0).sum(axis=1) * \
                 (np.asarray(self.nd_dw_val) != 0).sum(axis=1)
            n += int(nd.sum()) * self.dim_ph
        if self.ph_diag is not None:
            n += self.diag.size * self.dim_ph      # ph diag broadcast
            n += self.diag.size * 2 * self.dim_ph  # eph tridiagonal couplings
        return int(n)


# --------------------------------------------------------------------------
# ELL assembly
# --------------------------------------------------------------------------
def _coo_accumulate(rows, cols, vals):
    """Sum duplicate (row, col) entries."""
    if len(rows) == 0:
        return rows, cols, vals
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    new = np.ones(len(rows), dtype=bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    idx = np.cumsum(new) - 1
    out_vals = np.zeros(idx[-1] + 1)
    np.add.at(out_vals, idx, vals)
    return rows[new], cols[new], out_vals


def coo_to_ell(rows, cols, vals, n: int, k: Optional[int] = None,
               pad_to: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """COO -> padded ELL [n, K]. Padded entries point at column 0 with value 0."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    rows, cols, vals = _coo_accumulate(rows, cols, vals)
    counts = np.bincount(rows, minlength=n)
    kmax = int(counts.max()) if len(counts) else 0
    K = max(k or 0, kmax, pad_to)
    ell_cols = np.zeros((n, K), dtype=np.int32)
    ell_vals = np.zeros((n, K), dtype=np.float64)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    # slot index within each row
    slot = np.arange(len(r), dtype=np.int64)
    row_start = np.zeros(n + 1, dtype=np.int64)
    row_start[1:] = np.cumsum(counts)
    slot = slot - row_start[r]
    ell_cols[r, slot] = c
    ell_vals[r, slot] = v
    return ell_cols, ell_vals


def _gather_map(states: np.ndarray, rows, cols, vals) -> Tuple[np.ndarray, np.ndarray]:
    """Partial permutation (single-particle hop) -> row-gather (src, val)."""
    n = len(states)
    src = np.zeros(n, dtype=np.int32)
    val = np.zeros(n, dtype=np.float64)
    src[rows] = cols
    val[rows] = vals
    return src, val


# --------------------------------------------------------------------------
# single-spin hop factor (stored/H_up.f90 & H_dw.f90 behavior)
# --------------------------------------------------------------------------
def _spin_hop_terms(cfg: EDConfig, spin: int, hloc: np.ndarray,
                    diag_hybr: np.ndarray, hbath: Optional[np.ndarray]
                    ) -> List[Tuple[int, int, float]]:
    """The one-spin hop terms (pos_create, pos_destroy, amp), zero
    amplitudes included, in the order :func:`_spin_hop_coo` adds them."""
    terms: List[Tuple[int, int, float]] = []
    norb, nb = cfg.norb, cfg.nbath
    s = spin if cfg.nspin == 2 else 0
    # impurity off-diagonal hloc
    for a in range(norb):
        for b in range(norb):
            if a != b:
                terms.append((a, b, float(hloc[s, s, a, b])))
    # replica intra-bath hopping
    if cfg.bath_type == "replica" and hbath is not None:
        for k in range(nb):
            for a in range(norb):
                for b in range(norb):
                    ia, ib = bath_stride(cfg, a, k), bath_stride(cfg, b, k)
                    if ia != ib:
                        terms.append((ia, ib, float(hbath[s, s, a, b, k])))
    # hybridization imp <-> bath (both directions)
    for a in range(norb):
        for k in range(nb):
            ia = bath_stride(cfg, a, k)
            v = float(diag_hybr[s, a, k])
            terms.append((ia, a, v))   # c_imp -> c^+_bath
            terms.append((a, ia, v))   # c_bath -> c^+_imp
    return terms


def _spin_hop_coo(cfg: EDConfig, states: np.ndarray, spin: int,
                  hloc: np.ndarray, diag_hybr: np.ndarray,
                  hbath: Optional[np.ndarray]):
    """COO entries of the one-spin hop matrix over `states`."""
    rows_l: List[np.ndarray] = []
    cols_l: List[np.ndarray] = []
    vals_l: List[np.ndarray] = []
    for pos_c, pos_d, amp in _spin_hop_terms(cfg, spin, hloc, diag_hybr,
                                             hbath):
        if amp == 0.0:
            continue
        r, c, v = hop_entries(states, pos_c, pos_d, amp)
        if len(r):
            rows_l.append(r)
            cols_l.append(c)
            vals_l.append(v)
    if rows_l:
        return (np.concatenate(rows_l), np.concatenate(cols_l),
                np.concatenate(vals_l))
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))


# --------------------------------------------------------------------------
# electron diagonal (stored/H_local.f90 behavior)
# --------------------------------------------------------------------------
def _electron_diag_factors(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                           bath_diag: np.ndarray):
    """Factored electron diagonal:

        diag[idw, iup] = e_up[iup] + e_dw[idw] + (a_dw @ b_up.T)[idw, iup]

    with a_dw = n_dw_imp @ W.T  [DimDw, norb],  b_up = n_up_imp  [DimUp, norb]
    (W the opposite-spin interaction bilinear, U_loc on the diagonal and Ust
    off it) and the Hartree constant folded into e_up. The stored backend
    composes the full [DimDw, DimUp] array; the matrix-free direct backend
    keeps the factors — O(Dim_dw + Dim_up) memory instead of O(Dim), the
    analogue of the reference's direct path recomputing diagonal terms per
    state (ED_HAMILTONIAN_DIRECT_HxV.f90 / direct/HxV_local.f90)."""
    norb = cfg.norb
    ns = cfg.ns
    up = sec.states_up[0]
    dw = sec.states_dw[0]
    n_up = occupations(up, ns).astype(np.float64)   # [DimUp, Ns]
    n_dw = occupations(dw, ns).astype(np.float64)   # [DimDw, Ns]
    nu = n_up[:, :norb]   # impurity occupations
    nd = n_dw[:, :norb]
    sdw = cfg.nspin - 1
    uloc = np.array(cfg.uloc[:norb])
    ust, jh = cfg.ust, cfg.jh

    # per-spin separable pieces
    e_up = nu @ (np.diagonal(hloc[0, 0]) - cfg.xmu)
    e_dw = nd @ (np.diagonal(hloc[sdw, sdw]) - cfg.xmu)
    # bath level energies
    norb_e = bath_diag.shape[1]
    for a in range(norb_e):
        for k in range(cfg.nbath):
            p = bath_stride(cfg, a, k)
            e_up = e_up + bath_diag[0, a, k] * n_up[:, p]
            e_dw = e_dw + bath_diag[sdw, a, k] * n_dw[:, p]
    # same-spin inter-orbital (Ust-Jh) sum_{a<b} n_a n_b
    if norb > 1:
        pair_u = 0.5 * ((nu.sum(1)) ** 2 - (nu ** 2).sum(1))
        pair_d = 0.5 * ((nd.sum(1)) ** 2 - (nd ** 2).sum(1))
        e_up = e_up + (ust - jh) * pair_u
        e_dw = e_dw + (ust - jh) * pair_d
    # Hartree shift (hfmode)
    const = 0.0
    if cfg.hfmode:
        e_up = e_up - 0.5 * (nu @ uloc)
        e_dw = e_dw - 0.5 * (nd @ uloc)
        const += 0.25 * uloc.sum()
        if norb > 1:
            # per pair (a<b): -(Ust + Ust-Jh)/2 * (n_a + n_b) + (Ust + Ust-Jh)/4
            npairs = norb * (norb - 1) // 2
            w = 0.5 * (2.0 * ust - jh) * (norb - 1)
            e_up = e_up - w * nu.sum(1)
            e_dw = e_dw - w * nd.sum(1)
            const += 0.25 * (2.0 * ust - jh) * npairs
    # opposite-spin bilinear: sum_ab W[a,b] nup_a ndw_b
    w_mat = np.diag(uloc) + ust * (np.ones((norb, norb)) - np.eye(norb))
    return e_up + const, e_dw, nd @ w_mat.T, nu


def _electron_diag(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                   bath_diag: np.ndarray) -> np.ndarray:
    e_up, e_dw, a_dw, b_up = _electron_diag_factors(cfg, sec, hloc, bath_diag)
    return e_up[None, :] + e_dw[:, None] + a_dw @ b_up.T


# --------------------------------------------------------------------------
# full builder
# --------------------------------------------------------------------------
def build_sector_hamiltonian(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                             bath: Bath,
                             h_basis: Optional[np.ndarray] = None,
                             dtype=None) -> SectorHamiltonian:
    """Assemble all factors of one sector Hamiltonian (ed_buildh_main).

    Works for both ed_total_ud modes: in the orbital-resolved mode the
    sector carries sorted composite masks, and since the per-channel QNs
    forbid inter-channel hops (checked in config), the same ELL assembly
    applies unchanged (replacing the reference's *_orbs code paths).
    """
    if not cfg.ed_total_ud:
        if cfg.norb > 1 and (cfg.jx != 0.0 or cfg.jp != 0.0):
            raise ValueError("ed_total_ud=F incompatible with Jx/Jp "
                             "(ED_SETUP ed_checks_global)")
        off = np.asarray(hloc) - np.asarray(
            [[np.diag(np.diagonal(hloc[s1, s2]))
              for s2 in range(cfg.nspin)] for s1 in range(cfg.nspin)])
        if np.abs(off).max() > 1e-12:
            raise ValueError("ed_total_ud=F requires orbital-diagonal Hloc")
    dtype = dtype or np.dtype(cfg.ed_dtype)
    bath_diag, diag_hybr, hbath = bath_levels(cfg, bath, h_basis)
    hloc = np.asarray(hloc, dtype=np.float64)
    up = sec.states_up[0]
    dw = sec.states_dw[0]
    dim_up, dim_dw = len(up), len(dw)
    sdw = cfg.nspin - 1

    diag = _electron_diag(cfg, sec, hloc, bath_diag)

    r, c, v = _spin_hop_coo(cfg, up, 0, hloc, diag_hybr, hbath)
    up_cols, up_vals = coo_to_ell(r, c, v, dim_up)
    r, c, v = _spin_hop_coo(cfg, dw, 1, hloc, diag_hybr, hbath)
    dw_cols, dw_vals = coo_to_ell(r, c, v, dim_dw)

    # non-local spin-exchange / pair-hopping (stored/H_non_local.f90):
    #   Jx: sum_{a!=b}  Jx (c^+_a c_b)_up (x) (c^+_b c_a)_dw
    #   Jp: sum_{a!=b}  Jp (c^+_a c_b)_up (x) (c^+_a c_b)_dw
    nd_terms = []
    jhflag = cfg.norb > 1 and (cfg.jx != 0.0 or cfg.jp != 0.0)
    if jhflag:
        for a in range(cfg.norb):
            for b in range(cfg.norb):
                if a == b:
                    continue
                if cfg.jx != 0.0:
                    ru, cu, vu = hop_entries(up, a, b, cfg.jx)
                    rd, cd, vd = hop_entries(dw, b, a, 1.0)
                    nd_terms.append((_gather_map(up, ru, cu, vu),
                                     _gather_map(dw, rd, cd, vd)))
                if cfg.jp != 0.0:
                    ru, cu, vu = hop_entries(up, a, b, cfg.jp)
                    rd, cd, vd = hop_entries(dw, a, b, 1.0)
                    nd_terms.append((_gather_map(up, ru, cu, vu),
                                     _gather_map(dw, rd, cd, vd)))
    if nd_terms:
        nd_up_src = np.stack([t[0][0] for t in nd_terms])
        nd_up_val = np.stack([t[0][1] for t in nd_terms]).astype(dtype)
        nd_dw_src = np.stack([t[1][0] for t in nd_terms])
        nd_dw_val = np.stack([t[1][1] for t in nd_terms]).astype(dtype)
    else:
        nd_up_src = nd_up_val = nd_dw_src = nd_dw_val = None

    # phonons (stored/H_ph.f90, H_e_ph.f90)
    ph_diag = eph_el = eph_x = None
    if cfg.dim_ph > 1:
        nph = np.arange(cfg.dim_ph, dtype=np.float64)
        ph_diag = np.asarray(cfg.w0_ph * nph, dtype=dtype)
        g = np.array(cfg.g_ph[:cfg.norb])
        n_up = occupations(up, cfg.ns).astype(np.float64)[:, :cfg.norb]
        n_dw = occupations(dw, cfg.ns).astype(np.float64)[:, :cfg.norb]
        eph_el_np = (n_up @ g)[None, :] + (n_dw @ g)[:, None] - g.sum()
        eph_el = np.asarray(eph_el_np, dtype=dtype)
        x = np.zeros((cfg.dim_ph, cfg.dim_ph))
        for p in range(cfg.dim_ph - 1):
            x[p, p + 1] = np.sqrt(p + 1.0)   # b
            x[p + 1, p] = np.sqrt(p + 1.0)   # b^+
        eph_x = np.asarray(x, dtype=dtype)

    return SectorHamiltonian(
        diag=np.asarray(diag, dtype=dtype),
        up_cols=np.asarray(up_cols), up_vals=np.asarray(up_vals, dtype=dtype),
        dw_cols=np.asarray(dw_cols), dw_vals=np.asarray(dw_vals, dtype=dtype),
        nd_up_src=nd_up_src, nd_up_val=nd_up_val,
        nd_dw_src=nd_dw_src, nd_dw_val=nd_dw_val,
        ph_diag=ph_diag, eph_el=eph_el, eph_x=eph_x,
    )


# --------------------------------------------------------------------------
# dense oracle (build_Hv_sector(isector, Hmat) analogue, for tests/small dims)
# --------------------------------------------------------------------------
def dense_hamiltonian(h: SectorHamiltonian) -> np.ndarray:
    """Reconstruct the dense sector H by kron — the continuous-validation

    oracle the reference gets from its dense dump path
    (ED_HAMILTONIAN_SPARSE_HxV.f90:132-195)."""
    du, dd, dp = h.dim_up, h.dim_dw, h.dim_ph
    diag = np.asarray(h.diag, dtype=np.float64)
    hup = np.zeros((du, du))
    cols = np.asarray(h.up_cols)
    vals = np.asarray(h.up_vals, dtype=np.float64)
    for kk in range(cols.shape[1]):
        np.add.at(hup, (np.arange(du), cols[:, kk]), vals[:, kk])
    hdw = np.zeros((dd, dd))
    cols = np.asarray(h.dw_cols)
    vals = np.asarray(h.dw_vals, dtype=np.float64)
    for kk in range(cols.shape[1]):
        np.add.at(hdw, (np.arange(dd), cols[:, kk]), vals[:, kk])

    dim_el = du * dd
    h_el = np.diag(diag.reshape(-1))          # linear index i = iup + idw*du
    h_el += np.kron(np.eye(dd), hup)
    h_el += np.kron(hdw, np.eye(du))
    if h.nd_up_src is not None:
        t_cnt = h.nd_up_src.shape[0]
        for t in range(t_cnt):
            a = np.zeros((du, du))
            src = np.asarray(h.nd_up_src[t])
            val = np.asarray(h.nd_up_val[t], dtype=np.float64)
            a[np.arange(du), src] = val
            b = np.zeros((dd, dd))
            src = np.asarray(h.nd_dw_src[t])
            val = np.asarray(h.nd_dw_val[t], dtype=np.float64)
            b[np.arange(dd), src] = val
            h_el += np.kron(b, a)
    if dp == 1:
        return h_el
    full = np.kron(np.eye(dp), h_el)
    full += np.kron(np.diag(np.asarray(h.ph_diag, dtype=np.float64)), np.eye(dim_el))
    x = np.asarray(h.eph_x, dtype=np.float64)
    e = np.diag(np.asarray(h.eph_el, dtype=np.float64).reshape(-1))
    full += np.kron(x, e)
    return full
