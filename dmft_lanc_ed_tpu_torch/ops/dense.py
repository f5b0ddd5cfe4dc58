"""Dense tensor-product matvec, electron terms (port of
``dmft_lanc_ed_tpu/ops/dense.py``).

The sector Hamiltonian H = 1_dw (x) H_up + H_dw (x) 1_up + D acts on the
vector V[DimDw, DimUp] as two dense matrix products

    Y = D . V  +  V @ H_up  +  H_dw @ V          (H_up, H_dw symmetric)

which are plain ``torch.matmul`` calls, as the JAX package left them to
XLA. This is the GF's small-target operator (gf.py). Two precisions:

- f64 (:func:`matvec_dense_flat`): exact;
- mixed (:func:`matvec_dense_mixed_flat`): true-f32 products (TF32 is off,
  see the package ``__init__``) with the diagonal in f64, ~1e-7 relative.

Every apply takes ``[..., dim]`` (flat) or ``[..., DimDw, DimUp]``
vectors: a leading batch dimension replaces the JAX ``vmap``. A stacked
op (``ops/batched.stack_ops``: every field [B, ...]) applies to
[B, DimDw, DimUp] vectors element by element through the same
broadcasting matmuls; the batched path builds its ops on the host
(``device="cpu"``) and moves the stack to the card in one copy per
field. Phonon and Jx/Jp terms are not ported (ROADMAP A6) and raise.
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
class DenseSectorOp:
    """Dense tensor-product factors of one sector Hamiltonian."""
    diag: torch.Tensor          # [DimDw, DimUp] f64
    hup: torch.Tensor           # [DimUp, DimUp] f64 (symmetric)
    hdw: torch.Tensor           # [DimDw, DimDw] f64
    hup32: torch.Tensor         # f32 copies for the mixed path
    hdw32: torch.Tensor
    nnz_count: int = 0

    @property
    def dim_up(self) -> int:
        return self.diag.shape[1]

    @property
    def dim_dw(self) -> int:
        return self.diag.shape[0]

    @property
    def dim(self) -> int:
        return self.dim_up * self.dim_dw

    @property
    def nnz(self) -> int:
        return self.nnz_count

    @property
    def device(self) -> torch.device:
        return self.diag.device


def electron_only(h: SectorHamiltonian, what: str) -> None:
    """Raise for the sector terms the port's operators do not apply yet."""
    if h.ph_diag is not None or h.nd_up_src is not None:
        raise NotImplementedError(
            f"{what}: phonon and Jx/Jp sector terms are not ported yet "
            "(ROADMAP A6)")


def _densify_ell(cols: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    h = np.zeros((n, n))
    for k in range(cols.shape[1]):
        np.add.at(h, (np.arange(n), cols[:, k]), vals[:, k])
    return h


def densify(h: SectorHamiltonian, device) -> DenseSectorOp:
    """SectorHamiltonian (ELL factors) -> dense factors on `device`."""
    electron_only(h, "dense backend")
    hup = _densify_ell(np.asarray(h.up_cols),
                       np.asarray(h.up_vals, np.float64), h.dim_up)
    hdw = _densify_ell(np.asarray(h.dw_cols),
                       np.asarray(h.dw_vals, np.float64), h.dim_dw)

    def put(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return DenseSectorOp(
        diag=put(np.asarray(h.diag, np.float64)), hup=put(hup), hdw=put(hdw),
        hup32=put(hup, torch.float32), hdw32=put(hdw, torch.float32),
        nnz_count=h.nnz)


def build_dense_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                   device, h_basis: Optional[np.ndarray] = None
                   ) -> DenseSectorOp:
    h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis,
                                 dtype=np.float64)
    return densify(h, device)


def matvec_dense(op: DenseSectorOp, v: torch.Tensor) -> torch.Tensor:
    """f64-exact dense matvec on [..., DimDw, DimUp] vectors."""
    return op.diag * v + v @ op.hup + op.hdw @ v


def matvec_dense_mixed(op: DenseSectorOp, v: torch.Tensor) -> torch.Tensor:
    """Mixed precision: true-f32 products, f64 diagonal."""
    v32 = v.float()
    y32 = v32 @ op.hup32 + op.hdw32 @ v32
    return op.diag * v + y32.to(v.dtype)


def _nd(op, v_flat: torch.Tensor) -> torch.Tensor:
    return v_flat.reshape(v_flat.shape[:-1] + (op.dim_dw, op.dim_up))


def matvec_dense_flat(op: DenseSectorOp, v_flat: torch.Tensor
                      ) -> torch.Tensor:
    return matvec_dense(op, _nd(op, v_flat)).reshape(v_flat.shape)


def matvec_dense_mixed_flat(op: DenseSectorOp, v_flat: torch.Tensor
                            ) -> torch.Tensor:
    return matvec_dense_mixed(op, _nd(op, v_flat)).reshape(v_flat.shape)
