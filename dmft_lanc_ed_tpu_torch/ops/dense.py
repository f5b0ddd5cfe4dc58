"""Dense tensor-product matvec (port of ``dmft_lanc_ed_tpu/ops/dense.py``).

The sector Hamiltonian

    H = 1_dw (x) H_up + H_dw (x) 1_up + D  (+ phonon, e-ph, Jx/Jp terms)

acts on the vector V[DimDw, DimUp] (V[DimPh, DimDw, DimUp] with phonons)
as dense matrix products

    Y = D . V  +  V @ H_up  +  H_dw @ V  +  sum_t B_t @ V @ A_t^T
        + w0 n_ph . V  +  X_ph (contracted on the phonon axis) (E_eph . V)

which are plain ``torch.matmul`` calls, as the JAX package left them to
XLA: the Jx/Jp terms are the stacked tensor products ``nd_a`` [T, DimUp,
DimUp] and ``nd_b`` [T, DimDw, DimDw], the phonon terms the phonon-number
diagonal ``ph_diag`` [DimPh], the electron factor of the e-ph coupling
``eph_el`` [DimDw, DimUp] and the displacement ``eph_x`` [DimPh, DimPh].
This is the GF's small-target operator (gf.py), the batched buckets'
operator, and the only operator of phonon and Jx/Jp sectors (the band
kernel refuses them, ``ops/blocksparse.py``). Two precisions:

- f64 (:func:`matvec_dense_flat`): exact;
- mixed (:func:`matvec_dense_mixed_flat`): true-f32 products (TF32 is off,
  see the package ``__init__``) with the diagonal and the phonon-number
  term in f64, ~1e-7 relative.

The JAX package's third, ``fast`` (:func:`matvec_dense_fast`), runs the
same f32 factors at the TPU's 3-pass bf16 precision, an approximation of
true-f32 products; here it is the mixed apply under its name.

Every apply takes ``[..., dim]`` (flat) or ``[..., (DimPh,) DimDw,
DimUp]`` vectors: a leading batch dimension replaces the JAX ``vmap``. A
stacked op (``ops/batched.stack_ops``: every field [B, ...]) applies to
[B, (DimPh,) DimDw, DimUp] vectors element by element through the same
broadcasting matmuls; the batched path builds its ops on the host
(``device="cpu"``) and moves the stack to the card in one copy per
field.
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
from ..utils.observability import trace


@dataclass(frozen=True)
class DenseSectorOp:
    """Dense tensor-product factors of one sector Hamiltonian."""
    diag: torch.Tensor          # [DimDw, DimUp] f64
    hup: torch.Tensor           # [DimUp, DimUp] f64 (symmetric)
    hdw: torch.Tensor           # [DimDw, DimDw] f64
    hup32: torch.Tensor         # f32 copies for the mixed path
    hdw32: torch.Tensor
    nnz_count: int = 0
    # Jx/Jp: sum_t B_t (x) A_t, stacked
    nd_a: Optional[torch.Tensor] = None     # [T, DimUp, DimUp] f64
    nd_b: Optional[torch.Tensor] = None     # [T, DimDw, DimDw] f64
    nd_a32: Optional[torch.Tensor] = None
    nd_b32: Optional[torch.Tensor] = None
    # phonons
    ph_diag: Optional[torch.Tensor] = None  # [DimPh] f64
    eph_el: Optional[torch.Tensor] = None   # [DimDw, DimUp] f64
    eph_x: Optional[torch.Tensor] = None    # [DimPh, DimPh] f64

    @property
    def dim_up(self) -> int:
        return self.diag.shape[-1]

    @property
    def dim_dw(self) -> int:
        return self.diag.shape[-2]

    @property
    def dim_ph(self) -> int:
        return 1 if self.ph_diag is None else self.ph_diag.shape[-1]

    @property
    def vshape(self) -> tuple:
        """The natural shape of one vector."""
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


def electron_only(h: SectorHamiltonian, what: str) -> None:
    """Raise for the sector terms an operator does not apply (the band
    kernel's: phonons and Jx/Jp stay on the dense operator)."""
    if h.ph_diag is not None or h.nd_up_src is not None:
        raise NotImplementedError(
            f"{what}: phonon and Jx/Jp sector terms run on the dense "
            "backend only")


def _densify_ell(cols: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    h = np.zeros((n, n))
    for k in range(cols.shape[1]):
        np.add.at(h, (np.arange(n), cols[:, k]), vals[:, k])
    return h


def densify(h: SectorHamiltonian, device) -> DenseSectorOp:
    """SectorHamiltonian (ELL factors) -> dense factors on `device`."""
    du, dd = h.dim_up, h.dim_dw
    hup = _densify_ell(np.asarray(h.up_cols),
                       np.asarray(h.up_vals, np.float64), du)
    hdw = _densify_ell(np.asarray(h.dw_cols),
                       np.asarray(h.dw_vals, np.float64), dd)

    nbytes = [0]

    def put(a, dtype=torch.float64):
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        nbytes[0] += t.nbytes
        return t
    with trace.span("ed.upload") as up:
        kw = {}
        if h.nd_up_src is not None:
            t_cnt = h.nd_up_src.shape[0]
            nd_a = np.zeros((t_cnt, du, du))
            nd_b = np.zeros((t_cnt, dd, dd))
            for t in range(t_cnt):
                nd_a[t, np.arange(du), np.asarray(h.nd_up_src[t])] = \
                    np.asarray(h.nd_up_val[t], np.float64)
                nd_b[t, np.arange(dd), np.asarray(h.nd_dw_src[t])] = \
                    np.asarray(h.nd_dw_val[t], np.float64)
            kw.update(nd_a=put(nd_a), nd_b=put(nd_b),
                      nd_a32=put(nd_a, torch.float32),
                      nd_b32=put(nd_b, torch.float32))
        if h.ph_diag is not None:
            kw.update(ph_diag=put(h.ph_diag), eph_el=put(h.eph_el),
                      eph_x=put(h.eph_x))
        op = DenseSectorOp(
            diag=put(h.diag), hup=put(hup), hdw=put(hdw),
            hup32=put(hup, torch.float32), hdw32=put(hdw, torch.float32),
            nnz_count=h.nnz, **kw)
        if torch.device(device).type == "cuda":
            up["bytes"] = nbytes[0]
            trace.count("h2d_bytes", nbytes[0])
    return op


def build_dense_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                   device, h_basis: Optional[np.ndarray] = None
                   ) -> DenseSectorOp:
    h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis,
                                 dtype=np.float64)
    return densify(h, device)


def _apply_dense(op: DenseSectorOp, v: torch.Tensor, hup, hdw, nd_a,
                 nd_b) -> torch.Tensor:
    """Shared body: the products in hup's dtype, the diagonal and the
    phonon-number term in the vector's own dtype. With phonons each
    electron factor gains a unit axis before the dw axis, so one op (or a
    stacked op's element) meets every phonon block."""
    ph = op.ph_diag is not None

    def el(t, extra=0):
        return t.unsqueeze(-3 - extra) if ph else t
    vc = v.to(hup.dtype)
    y = vc @ el(hup) + el(hdw) @ vc
    if nd_a is not None:
        # sum_t B_t @ V @ A_t^T over the stacked terms (axis -3 of va)
        va = vc.unsqueeze(-3) @ el(nd_a, 1).transpose(-1, -2)
        y = y + (el(nd_b, 1) @ va).sum(-3)
    if ph:
        ev = (el(op.eph_el).to(hup.dtype) * vc).flatten(-2)
        y = y + (op.eph_x.to(hup.dtype) @ ev).reshape(y.shape)
    out = el(op.diag) * v + y.to(v.dtype)
    if ph:
        out = out + op.ph_diag[..., None, None].to(v.dtype) * v
    return out


def matvec_dense(op: DenseSectorOp, v: torch.Tensor) -> torch.Tensor:
    """f64-exact dense matvec on [..., (DimPh,) DimDw, DimUp] vectors."""
    return _apply_dense(op, v, op.hup, op.hdw, op.nd_a, op.nd_b)


def matvec_dense_mixed(op: DenseSectorOp, v: torch.Tensor) -> torch.Tensor:
    """Mixed precision: true-f32 products, f64 diagonal."""
    return _apply_dense(op, v, op.hup32, op.hdw32, op.nd_a32, op.nd_b32)


def _nd(op, v_flat: torch.Tensor) -> torch.Tensor:
    return v_flat.reshape(v_flat.shape[:-1] + op.vshape)


def matvec_dense_flat(op: DenseSectorOp, v_flat: torch.Tensor
                      ) -> torch.Tensor:
    return matvec_dense(op, _nd(op, v_flat)).reshape(v_flat.shape)


def matvec_dense_mixed_flat(op: DenseSectorOp, v_flat: torch.Tensor
                            ) -> torch.Tensor:
    return matvec_dense_mixed(op, _nd(op, v_flat)).reshape(v_flat.shape)


# "fast": the TPU's 3-pass bf16 products stand for true-f32 ones, which the
# mixed apply computes (factory.resolve_precision runs "fast" as "mixed")
matvec_dense_fast = matvec_dense_mixed
matvec_dense_fast_flat = matvec_dense_mixed_flat
