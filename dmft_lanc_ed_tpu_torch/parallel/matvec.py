"""Sharded ELL sector matvec and Lanczos (port of
``dmft_lanc_ed_tpu/parallel/matvec.py``).

The reference's intra-sector parallelism as its MPI "Dw-split" spells it
out: the vector ``V[DimDw, DimUp]`` is split by dw rows over the ranks,
and the stored ELL factor tables (:mod:`..ops.matvec`) are applied as

- diagonal and up hops: local (the up index is whole on every rank);
- dw hops: :meth:`~.mesh.DwMesh.rows_to_cols` transposes to the
  up-column layout ``[DimDw, DimUp / n]``, the dw ELL factor is applied
  locally, and :meth:`~.mesh.DwMesh.cols_to_rows` transposes back — the
  reference's transpose, local SpMV, transpose back
  (vector_transpose_MPI, ED_HAMILTONIAN_COMMON.f90:53-118,
  ED_HAMILTONIAN_SPARSE_HxV.f90:568-694);
- Jx/Jp terms: the whole vector all-gathered, then this rank's rows (the
  reference's allgather_vector_MPI fallback, :674-692);
- Lanczos dot products and norms: a local sum, then the mesh's
  ``allreduce`` (P-ARPACK's internal reductions).

This is the low-level engine and equality oracle, as in the JAX package:
the solver's sharded path is :mod:`.production`. The communicator shrink
(DimDw < ranks) becomes zero padding of DimDw and DimUp to multiples of
the rank count: padded rows and columns are exact zeros, invariant under
the matvec and invisible to the sums.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..hamiltonian import SectorHamiltonian
from ..ops.lanczos import lanczos_tridiag_batched
from ..ops.matvec import EllSectorOp, add_dw_hops, add_up_hops, ell_op
from .mesh import DwMesh, pad_to_multiple


def pad_sector_hamiltonian(h: SectorHamiltonian, n: int) -> SectorHamiltonian:
    """Zero-pad DimDw and DimUp to multiples of n (host tables)."""
    dd, du = h.dim_dw, h.dim_up
    pd, pu = pad_to_multiple(dd, n) - dd, pad_to_multiple(du, n) - du
    if pd == 0 and pu == 0:
        return h

    def pad(a, rows, cols=0):
        return np.pad(np.asarray(a), ((0, rows), (0, cols)))
    kw = {}
    if h.nd_up_src is not None:
        kw.update(nd_up_src=pad(h.nd_up_src, 0, pu),
                  nd_up_val=pad(h.nd_up_val, 0, pu),
                  nd_dw_src=pad(h.nd_dw_src, 0, pd),
                  nd_dw_val=pad(h.nd_dw_val, 0, pd))
    if h.ph_diag is not None:
        kw.update(ph_diag=h.ph_diag, eph_el=pad(h.eph_el, pd, pu),
                  eph_x=h.eph_x)
    return SectorHamiltonian(
        diag=pad(h.diag, pd, pu),
        up_cols=pad(h.up_cols, pu), up_vals=pad(h.up_vals, pu),
        dw_cols=pad(h.dw_cols, pd), dw_vals=pad(h.dw_vals, pd), **kw)


def shard_hamiltonian(h: SectorHamiltonian, mesh: DwMesh) -> EllSectorOp:
    """Pad, and place on this rank's device: its dw rows of the diagonal
    (and of the e-ph electron factor), every other table whole."""
    hp = pad_sector_hamiltonian(h, mesh.size)
    rows = hp.dim_dw // mesh.size
    r = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    kw = dict(diag=np.asarray(hp.diag)[r])
    if hp.eph_el is not None:
        kw["eph_el"] = np.asarray(hp.eph_el)[r]
    return ell_op(dataclasses.replace(hp, **kw), mesh.device)


def sharded_matvec(h_sharded: EllSectorOp, mesh: DwMesh
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dw-sharded matvec of one padded sector: this rank's rows
    [L, DimUp_p] -> its rows of H v. Phonon terms are not applied (phonon
    sectors run on the replicated path, as in the JAX package)."""
    h = h_sharded
    rows = h.dim_dw
    r = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    nd = None
    if h.nd_up_src is not None:
        nd = (h.nd_up_src, h.nd_up_val, h.nd_dw_src[:, r].contiguous(),
              h.nd_dw_val[:, r].contiguous())

    def mv(v: torch.Tensor) -> torch.Tensor:
        y = add_up_hops(h.diag * v, h.up_cols, h.up_vals, v)
        # dw hops between the two transposes: [L, DimUp] -> [DimDw, up_l]
        w = mesh.rows_to_cols(v)
        yw = add_dw_hops(torch.zeros_like(w), h.dw_cols, h.dw_vals, w)
        y = y + mesh.cols_to_rows(yw, v.shape[-1])
        if nd is not None:
            vfull = mesh.allgather_rows(v)
            up_src, up_val, dw_src, dw_val = nd
            for t in range(up_src.shape[0]):
                tmp = vfull.index_select(-1, up_src[t]) * up_val[t]
                y = y + tmp.index_select(-2, dw_src[t]) * dw_val[t][:, None]
        return y
    return mv


class ShardedLanczos:
    """Lanczos tridiagonalization driving the sharded ELL matvec; its
    dot products and norms summed over the ranks, so every rank holds
    the same (alphas, betas)."""

    def __init__(self, h: SectorHamiltonian, mesh: DwMesh):
        if h.ph_diag is not None:
            raise NotImplementedError(
                "phonon sectors use the replicated matvec path for now")
        self.mesh = mesh
        self.h = shard_hamiltonian(h, mesh)
        self.mv = sharded_matvec(self.h, mesh)
        self.shape: Tuple[int, int] = (self.h.dim_dw * mesh.size,
                                       self.h.dim_up)

    @property
    def local_shape(self) -> Tuple[int, int]:
        return (self.h.dim_dw, self.h.dim_up)

    def pad_vec(self, v, dim_dw: int, dim_up: int) -> torch.Tensor:
        """A whole logical vector -> this rank's rows of the padded one."""
        v2 = np.asarray(v, np.float64).reshape(dim_dw, dim_up)
        ddp, dup = self.shape
        v2 = np.pad(v2, ((0, ddp - dim_dw), (0, dup - dim_up)))
        rows = self.local_shape[0]
        r0 = self.mesh.rank * rows
        return torch.as_tensor(v2[r0:r0 + rows], device=self.mesh.device)

    def tridiag(self, v0: torch.Tensor, m: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(alphas, betas) [m] host f64 of the m-step chain from this
        rank's rows `v0` of a normalized start, like
        ops.lanczos.lanczos_tridiag."""
        shape = self.local_shape

        def apply(_, x):
            return self.mv(x.reshape(shape)).reshape(x.shape)
        a, b = lanczos_tridiag_batched(self, v0.reshape(1, -1), m, apply,
                                       reduce=self.mesh.allreduce)
        return a[0], b[0]
