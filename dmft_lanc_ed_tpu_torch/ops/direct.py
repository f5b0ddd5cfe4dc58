"""Matrix-free (direct) sector matvec (port of
``dmft_lanc_ed_tpu/ops/direct.py``).

The reference's ED_SPARSE_H=F path (ED_HAMILTONIAN_DIRECT_HxV.f90 +
direct/*.f90): no hop tables are stored; each matvec recomputes every
single-particle hop's connectivity from bit operations on the sector's
state masks, trading operations (popcount, binary search) for memory. It
is also the second independent implementation of the operator, held
against the stored ELL backend (:mod:`.matvec`) in the tests.

Per hop term (pos_create c, pos_destroy d, amplitude), over one spin's
sorted masks, in the output-row form:

  applicable rows   bit_c set, bit_d clear (the state after the hop)
  source mask       = row mask XOR (bit_c | bit_d)
  source row        = ``torch.searchsorted`` over the sorted basis
  JW sign           = parity of the occupied levels below each position

The masks, positions and the popcount are int64 torch ops on the op's
device (a 32-bit SWAR popcount in int64 arithmetic, so masks of up to 32
levels; torch's shifts on uint32 are limited). The connectivity of all a
spin's terms is computed at once, [T, Dim] index and weight tables made
anew each apply; the accumulation is one row gather per term. The
electron diagonal stays factored (O(DimDw + DimUp) memory,
:func:`diag_mul`); Jx/Jp terms are products of two recomputed gather maps;
phonon occupancies come from the masks' low norb bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..bath import Bath, bath_levels
from ..config import EDConfig
from ..hamiltonian import _electron_diag_factors
from ..sectors import Sector, bath_stride

MASK_BITS = 32          # levels the int64 SWAR popcount covers


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of masks below 2^32, int64 arithmetic (no overflow)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _jw_sign(states: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(-1)^(#occupied below pos), pos broadcasting against states."""
    below = states & ((torch.ones_like(pos) << pos) - 1)
    return 1 - 2 * (_popcount32(below) & 1)


@dataclass(frozen=True)
class DirectSectorOp:
    """Matrix-free sector operator: state masks and term lists only.

    The electron diagonal is stored factored, never as a [dd, du] array:
    diag[i, j] = diag_dw[i] + diag_up[j] + (diag_a @ diag_b.T)[i, j]."""
    states_up: torch.Tensor       # [du] int64 sorted masks
    states_dw: torch.Tensor       # [dd] int64
    diag_up: torch.Tensor         # [du] separable up piece (+ Hartree const)
    diag_dw: torch.Tensor         # [dd]
    diag_a: torch.Tensor          # [dd, R] bilinear factor
    diag_b: torch.Tensor          # [du, R]
    up_c: torch.Tensor            # [Tu] int64 creation positions
    up_d: torch.Tensor            # [Tu] destruction positions
    up_a: torch.Tensor            # [Tu] amplitudes
    dw_c: torch.Tensor
    dw_d: torch.Tensor
    dw_a: torch.Tensor
    # Jx/Jp: term t = nd_a[t] (c+_{uc} c_{ud})_up (x) (c+_{dc} c_{dd})_dw
    nd_up_c: Optional[torch.Tensor] = None
    nd_up_d: Optional[torch.Tensor] = None
    nd_dw_c: Optional[torch.Tensor] = None
    nd_dw_d: Optional[torch.Tensor] = None
    nd_a: Optional[torch.Tensor] = None
    # phonons: occupancies recomputed from the masks
    ph_w0: Optional[float] = None
    ph_g: Optional[torch.Tensor] = None     # [norb] e-ph couplings
    ph_n: Optional[torch.Tensor] = None     # [DimPh] = arange(DimPh)

    @property
    def dim_up(self) -> int:
        return self.states_up.shape[0]

    @property
    def dim_dw(self) -> int:
        return self.states_dw.shape[0]

    @property
    def dim_ph(self) -> int:
        return 1 if self.ph_n is None else self.ph_n.shape[0]

    @property
    def vshape(self) -> tuple:
        if self.ph_n is None:
            return (self.dim_dw, self.dim_up)
        return (self.dim_ph, self.dim_dw, self.dim_up)

    @property
    def dim(self) -> int:
        return self.dim_ph * self.dim_dw * self.dim_up

    @property
    def nnz(self) -> int:
        """Entries applied per matvec (every row once per term, masked
        rows included): the stored backend's nonzero count's analogue."""
        terms = 1 + self.up_c.shape[0] + self.dw_c.shape[0]
        if self.nd_a is not None:
            terms += self.nd_a.shape[0]
        if self.ph_n is not None:
            terms += 2          # phonon ladder + e-ph factorized term
        return self.dim * terms

    @property
    def device(self) -> torch.device:
        return self.states_up.device


def _collect_terms(cfg: EDConfig, spin: int, hloc, diag_hybr, hbath
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pos_c, pos_d, amp) of every single-particle hop of one spin."""
    s = spin if cfg.nspin == 2 else 0
    cc, dd_, aa = [], [], []

    def add(c, d, a):
        if a != 0.0:
            cc.append(c)
            dd_.append(d)
            aa.append(a)

    for a in range(cfg.norb):
        for b in range(cfg.norb):
            if a != b:
                add(a, b, float(hloc[s, s, a, b]))
    if cfg.bath_type == "replica" and hbath is not None:
        for k in range(cfg.nbath):
            for a in range(cfg.norb):
                for b in range(cfg.norb):
                    ia, ib = bath_stride(cfg, a, k), bath_stride(cfg, b, k)
                    if ia != ib:
                        add(ia, ib, float(hbath[s, s, a, b, k]))
    for a in range(cfg.norb):
        for k in range(cfg.nbath):
            ia = bath_stride(cfg, a, k)
            v = float(diag_hybr[s, a, k])
            add(ia, a, v)
            add(a, ia, v)
    if not cc:
        cc, dd_, aa = [0], [0], [0.0]
    return (np.array(cc, np.int64), np.array(dd_, np.int64),
            np.array(aa, np.float64))


def build_direct_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                    device, h_basis: Optional[np.ndarray] = None
                    ) -> DirectSectorOp:
    """Assemble the matrix-free operator (directMatVec preparation). Both
    QN schemes: an orbital-resolved sector (ed_total_ud=F) carries sorted
    composite masks over all levels (sectors.py), so the same connectivity
    and signs apply; the hops that survive its constraint are exactly the
    channel-preserving ones."""
    if cfg.ns > MASK_BITS:
        raise ValueError(f"direct backend: {cfg.ns} levels exceed the "
                         f"{MASK_BITS}-bit masks")
    bath_diag, diag_hybr, hbath = bath_levels(cfg, bath, h_basis)
    hloc = np.asarray(hloc, dtype=np.float64)
    e_up, e_dw, a_dw, b_up = _electron_diag_factors(cfg, sec, hloc, bath_diag)
    uc, ud, ua = _collect_terms(cfg, 0, hloc, diag_hybr, hbath)
    dc, dd_, da = _collect_terms(cfg, 1, hloc, diag_hybr, hbath)

    def put(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    idx = torch.int64

    # Jx/Jp term list (the stored builder's terms, positional only)
    nuc, nud, ndc, ndd, nda = [], [], [], [], []
    if cfg.norb > 1:
        for a in range(cfg.norb):
            for b in range(cfg.norb):
                if a == b:
                    continue
                if cfg.jx != 0.0:       # Jx (c+_a c_b)_up (c+_b c_a)_dw
                    nuc.append(a); nud.append(b)
                    ndc.append(b); ndd.append(a)
                    nda.append(cfg.jx)
                if cfg.jp != 0.0:       # Jp (c+_a c_b)_up (c+_a c_b)_dw
                    nuc.append(a); nud.append(b)
                    ndc.append(a); ndd.append(b)
                    nda.append(cfg.jp)
    kw = {}
    if nuc:
        kw.update(nd_up_c=put(nuc, idx), nd_up_d=put(nud, idx),
                  nd_dw_c=put(ndc, idx), nd_dw_d=put(ndd, idx),
                  nd_a=put(nda))
    if cfg.dim_ph > 1:
        kw.update(ph_w0=float(cfg.w0_ph), ph_g=put(cfg.g_ph[:cfg.norb]),
                  ph_n=torch.arange(cfg.dim_ph, dtype=torch.float64,
                                    device=device))
    return DirectSectorOp(
        states_up=put(sec.states_up[0], idx),
        states_dw=put(sec.states_dw[0], idx),
        diag_up=put(e_up), diag_dw=put(e_dw), diag_a=put(a_dw),
        diag_b=put(b_up),
        up_c=put(uc, idx), up_d=put(ud, idx), up_a=put(ua),
        dw_c=put(dc, idx), dw_d=put(dd_, idx), dw_a=put(da), **kw)


def _row_gather_maps(states: torch.Tensor, c: torch.Tensor, d: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output-row gather maps of the hops c^+_c c_d over one spin's basis,
    for T terms at once: row i of term t receives w[t, i] * x[src[t, i]]
    (w = 0 where the hop does not apply). Signs follow the stored
    builder's c-then-cdg composition evaluated on the source state."""
    c = c[:, None]
    d = d[:, None]
    one = torch.ones_like(c)
    bit_c, bit_d = one << c, one << d
    ok = ((states & bit_c) != 0) & ((states & bit_d) == 0) & (c != d)
    src_state = states ^ (bit_c | bit_d)
    src = torch.searchsorted(states, src_state).clamp_(max=len(states) - 1)
    src = torch.where(ok, src, 0)
    sg = _jw_sign(src_state, d) * _jw_sign(src_state ^ bit_d, c)
    return src, torch.where(ok, sg, 0)


def _apply_factor(states, pos_c, pos_d, amps, v, dim: int):
    """sum_t amp_t sign_t(i) v[..., src_t(i), ...] along axis `dim`."""
    src, w = _row_gather_maps(states, pos_c, pos_d)
    w = amps[:, None] * w.to(amps.dtype)
    shape = [1] * v.ndim
    shape[dim] = -1
    y = torch.zeros_like(v)
    for t in range(src.shape[0]):
        y = y + w[t].reshape(shape) * v.index_select(dim, src[t])
    return y


def diag_mul(op: DirectSectorOp, v: torch.Tensor) -> torch.Tensor:
    """diag . v from the factored diagonal, without a stored [dd, du]
    array: the separable broadcast plus R (= norb) rank-1 passes."""
    y = (op.diag_dw[:, None] + op.diag_up[None, :]) * v
    for r in range(op.diag_a.shape[1]):
        y = y + op.diag_a[:, r, None] * (op.diag_b[:, r] * v)
    return y


def direct_diag(op: DirectSectorOp) -> torch.Tensor:
    """Materialized [dd, du] electron diagonal (the Davidson
    preconditioner and oracles; never stored on the op)."""
    return (op.diag_dw[:, None] + op.diag_up[None, :]
            + op.diag_a @ op.diag_b.T)


def apply_direct(op: DirectSectorOp, v: torch.Tensor) -> torch.Tensor:
    """y = H v with the connectivity recomputed; v [..., (DimPh,) DimDw,
    DimUp]."""
    y = diag_mul(op, v)
    y = y + _apply_factor(op.states_dw, op.dw_c, op.dw_d, op.dw_a, v, -2)
    y = y + _apply_factor(op.states_up, op.up_c, op.up_d, op.up_a, v, -1)
    if op.nd_a is not None:
        src_u, w_u = _row_gather_maps(op.states_up, op.nd_up_c, op.nd_up_d)
        src_d, w_d = _row_gather_maps(op.states_dw, op.nd_dw_c, op.nd_dw_d)
        for t in range(op.nd_a.shape[0]):
            tmp = v.index_select(-1, src_u[t]) * w_u[t].to(v.dtype)
            y = y + op.nd_a[t] * (tmp.index_select(-2, src_d[t])
                                  * w_d[t].to(v.dtype)[:, None])
    if op.ph_n is not None:
        y = add_phonon_terms(op, v, y)
    return y


def add_phonon_terms(op: DirectSectorOp, v: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """y plus the phonon diagonal w0 n_ph . v and the e-ph term over the
    op's dw rows (``states_dw``), v [..., DimPh, rows, DimUp]."""
    y = y + (op.ph_w0 * op.ph_n)[:, None, None] * v
    # e-ph: y[p] += (X ev)[p], ev = [sum_a g_a (n_a - 1)] v, the
    # impurity occupancies from the masks' low norb bits
    norb = op.ph_g.shape[0]
    bits = torch.arange(norb, device=op.device)
    g = op.ph_g
    gu = ((op.states_up[:, None] >> bits) & 1).to(g.dtype) @ g
    gd = ((op.states_dw[:, None] >> bits) & 1).to(g.dtype) @ g
    ev = (gu[None, :] + gd[:, None] - g.sum()) * v
    coef = torch.sqrt(op.ph_n[1:])[:, None, None]   # sqrt(1..P-1)
    lo = coef * ev[..., 1:, :, :]                   # b
    hi = coef * ev[..., :-1, :, :]                  # b^+
    return y + torch.cat([lo, torch.zeros_like(lo[..., :1, :, :])], -3) \
        + torch.cat([torch.zeros_like(hi[..., :1, :, :]), hi], -3)


def matvec_direct_flat(op: DirectSectorOp, v_flat: torch.Tensor
                       ) -> torch.Tensor:
    v = v_flat.reshape(v_flat.shape[:-1] + op.vshape)
    return apply_direct(op, v).reshape(v_flat.shape)
