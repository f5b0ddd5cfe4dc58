"""Stored ELL row-gather matvec (port of ``dmft_lanc_ed_tpu/ops/matvec.py``).

The stored backend of the reference's SpMV engine (spMatVec_main,
ED_HAMILTONIAN_SPARSE_HxV.f90:391-485): the sector Hamiltonian's ELL
factor tables (:class:`~..hamiltonian.SectorHamiltonian`) applied one ELL
slot at a time as whole row gathers,

    y += vals[:, k] * v[..., cols[:, k], :]        (dw factor)
    y += up_vals[:, k] * v[..., :, up_cols[:, k]]  (up factor)

with the Jx/Jp terms as products of two gather maps and the phonon terms
as the dense phonon axis. The JAX package writes this in jnp (a
``fori_loop`` over the K slots); here each slot is one ``index_select``
on the op's device, K (~2 nbath) a Python loop. Vectors are
``[..., DimDw, DimUp]`` or ``[..., DimPh, DimDw, DimUp]`` (flat:
``[..., dim]``, the reference's linear order), a leading batch dimension
replacing the JAX ``vmap``. This is ``ed_backend="ell"`` and what
``ed_backend="auto"`` resolves to on the CPU; the apply is f64-exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..bath import Bath
from ..config import EDConfig
from ..hamiltonian import SectorHamiltonian, build_sector_hamiltonian
from ..sectors import Sector


@dataclass(frozen=True)
class EllSectorOp:
    """A SectorHamiltonian's tables on a torch device (indices int64)."""
    diag: torch.Tensor                    # [DimDw, DimUp]
    up_cols: torch.Tensor                 # [DimUp, Kup]
    up_vals: torch.Tensor
    dw_cols: torch.Tensor                 # [DimDw, Kdw]
    dw_vals: torch.Tensor
    nnz_count: int = 0
    nd_up_src: Optional[torch.Tensor] = None    # [T, DimUp]
    nd_up_val: Optional[torch.Tensor] = None
    nd_dw_src: Optional[torch.Tensor] = None    # [T, DimDw]
    nd_dw_val: Optional[torch.Tensor] = None
    ph_diag: Optional[torch.Tensor] = None      # [DimPh]
    eph_el: Optional[torch.Tensor] = None       # [DimDw, DimUp]
    eph_x: Optional[torch.Tensor] = None        # [DimPh, DimPh]

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
    def vshape(self) -> tuple:
        if self.ph_diag is None:
            return (self.dim_dw, self.dim_up)
        return (self.dim_ph, self.dim_dw, self.dim_up)

    @property
    def dim(self) -> int:
        return self.dim_up * self.dim_dw * self.dim_ph

    @property
    def nnz(self) -> int:
        return self.nnz_count

    @property
    def device(self) -> torch.device:
        return self.diag.device


def ell_op(h: SectorHamiltonian, device) -> EllSectorOp:
    """The host tables of `h` moved to `device`."""
    def put(a, dtype=torch.float64):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=device)
    idx = torch.int64
    return EllSectorOp(
        diag=put(h.diag), up_cols=put(h.up_cols, idx), up_vals=put(h.up_vals),
        dw_cols=put(h.dw_cols, idx), dw_vals=put(h.dw_vals),
        nnz_count=h.nnz,
        nd_up_src=put(h.nd_up_src, idx), nd_up_val=put(h.nd_up_val),
        nd_dw_src=put(h.nd_dw_src, idx), nd_dw_val=put(h.nd_dw_val),
        ph_diag=put(h.ph_diag), eph_el=put(h.eph_el), eph_x=put(h.eph_x))


def build_ell_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                 device, h_basis: Optional[np.ndarray] = None
                 ) -> EllSectorOp:
    h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis,
                                 dtype=np.float64)
    return ell_op(h, device)


def add_dw_hops(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """y plus the dw factor's row gathers, one per ELL slot: row i of axis
    -2 receives vals[i, k] v[..., cols[i, k], :]."""
    for k in range(cols.shape[1]):
        y = y + vals[:, k, None] * v.index_select(-2, cols[:, k])
    return y


def add_up_hops(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """y plus the up factor's column gathers, one per ELL slot."""
    for k in range(cols.shape[1]):
        y = y + vals[:, k] * v.index_select(-1, cols[:, k])
    return y


def apply_h(op: EllSectorOp, v: torch.Tensor) -> torch.Tensor:
    """y = H v for one sector; v [..., (DimPh,) DimDw, DimUp] on the op's
    device (a host SectorHamiltonian goes through :func:`ell_op` once)."""
    ph = op.ph_diag is not None

    def el(t):          # an electron factor meets every phonon block
        return t.unsqueeze(-3) if ph else t
    y = add_dw_hops(el(op.diag) * v, op.dw_cols, op.dw_vals, v)
    y = add_up_hops(y, op.up_cols, op.up_vals, v)
    if op.nd_up_src is not None:
        # sum_t B_t (x) A_t, each factor a gather map
        for t in range(op.nd_up_src.shape[0]):
            tmp = v.index_select(-1, op.nd_up_src[t]) * op.nd_up_val[t]
            y = y + tmp.index_select(-2, op.nd_dw_src[t]) \
                * op.nd_dw_val[t][:, None]
    if ph:
        y = y + op.ph_diag[:, None, None] * v
        # e-ph: y[p] += X[p, q] (eph_el . v)[q]
        ev = (op.eph_el * v).flatten(-2)
        y = y + (op.eph_x @ ev).reshape(y.shape)
    return y


def matvec_flat(op: EllSectorOp, v_flat: torch.Tensor) -> torch.Tensor:
    """Flat interface ([..., dim], the reference's linear index order)."""
    v = v_flat.reshape(v_flat.shape[:-1] + op.vshape)
    return apply_h(op, v).reshape(v_flat.shape)


def make_matvec(op: EllSectorOp):
    """Closure ``mv(v_flat) -> H v_flat`` over one sector's ELL operator
    (the JAX package's jitted closure; here each call runs the gathers on
    the op's device)."""
    def mv(v_flat: torch.Tensor) -> torch.Tensor:
        return matvec_flat(op, v_flat)
    return mv
