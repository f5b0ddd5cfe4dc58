"""Production dw-sharded sector solve, the dense half (port of
``dmft_lanc_ed_tpu/parallel/production.py``).

In the reference every large sector is diagonalized through the
distributed matvec (P-ARPACK over spMatVec_mpi_main, ED_DIAG.f90:151-171)
and the GF tridiagonalization runs on scattered vectors
(ED_GF_NORMAL.f90:224-238). The JAX package places the dense tensor-product
factors on a 1-D mesh and lets its partitioner turn ``H_dw @ V`` into a
collective. Here each rank holds the dw rows [d L, (d+1) L) of the padded
vector and of the factors, and the apply is plain torch on the card:

- ``diag o v_loc + v_loc @ H_up`` is local (the up index is whole on every
  rank);
- ``H_dw[local rows, :] @ allgather_rows(v)`` is the dw term, the
  collective the partitioner emitted (vector_transpose_MPI,
  ED_HAMILTONIAN_COMMON.f90:53-118);
- the Lanczos inner products and norms are the mesh's ``allreduce``.

The communicator shrink (DimDw < ranks, ED_HAMILTONIAN.f90:66-94) becomes
zero padding of the dw axis to a multiple of the rank count: pad rows are
exact zeros, invariant under the apply, and their diagonal sits +PAD_SHIFT
above the physics.

The same operator, built from a band-sparse op's natural-order factors,
is the second stage of the sharded band-sparse solve
(:mod:`.bs_sharded`): a Lanczos top-off from the B5 stage's vector and
the f64 polish, through :func:`sharded_dense_ground_state`.

Not ported: the sharded direct (matrix-free) backend, ROADMAP A5; the
sharding of phonon and Jx/Jp sectors, which raise where the sharded
operator is built (ROADMAP A10).
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EDConfig
from ..ops.dense import DenseSectorOp, build_dense_op
from ..ops.factory import resolve_backend, resolve_precision
from ..ops.lanczos import lanczos_ground_state
from .mesh import DwMesh, make_mesh, pad_to_multiple
from .multihost import process_info

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

PAD_SHIFT = 1.0e3   # diagonal shift of padded rows (see pad_dense_op)

# since the last reset: applies of the sharded dense operator (diag, GF,
# and the band-sparse sectors' top-off), and GF chains run over it
apply_counts = {"dense_sharded": 0, "gf_chains": 0}


def reset_apply_counts() -> None:
    for k in apply_counts:
        apply_counts[k] = 0


def solver_mesh(cfg: EDConfig, device) -> Optional[DwMesh]:
    """The dw mesh requested by cfg.mesh_shape on `device` (None if
    unsharded, or if fewer ranks are running than it asks for).

    More ranks running than it asks for raises: the JAX package takes a
    sub-mesh of its devices, but here every running rank runs the whole
    solve, and a rank outside the mesh would have no shard to hold."""
    if not cfg.mesh_shape:
        return None
    n = int(math.prod(cfg.mesh_shape))
    if n <= 1:
        return None
    running = process_info()[1]
    if running < n:
        log.warning("mesh_shape=%s requests %d ranks but only %d are "
                    "running — running unsharded", cfg.mesh_shape, n,
                    running)
        return None
    if running > n:
        raise ValueError(f"mesh_shape={cfg.mesh_shape} requests {n} ranks "
                         f"but {running} are running: launch {n} ranks")
    return make_mesh(n, device)


@dataclass
class ShardedSectorOp:
    """This rank's rows of a dw-sharded (padded) dense sector operator."""
    op: DenseSectorOp          # diag [L, du], hdw/hdw32 [L, ddp]; hup whole
    apply_nd: Callable         # production apply on [..., L, du]
    exact_nd: Callable         # f64 apply (polish)
    mesh: DwMesh
    vshape: Tuple[int, int]    # padded natural vector shape (ddp, du)
    dim_dw: int                # logical (unpadded) dw dimension
    dim: int                   # logical flat dimension

    @property
    def local_shape(self) -> Tuple[int, int]:
        return (self.vshape[0] // self.mesh.size, self.vshape[1])

    @property
    def nnz(self) -> int:
        """The whole sector's nonzeros a matvec applies (counters)."""
        return self.op.nnz_count

    @property
    def device(self) -> torch.device:
        return self.op.device

    def apply_flat(self, v: torch.Tensor) -> torch.Tensor:
        """The production apply on flat [..., L * du] rows."""
        return self.apply_nd(self, v.reshape(v.shape[:-1] + self.local_shape)
                             ).reshape(v.shape)

    def pad_flat_batch(self, vs: np.ndarray) -> torch.Tensor:
        """[B, dim] flat logical vectors -> this rank's rows of the padded
        vectors, [B, L, du] f64 on the device."""
        b = vs.shape[0]
        rows = self.local_shape[0]
        r0 = self.mesh.rank * rows
        v = np.asarray(vs, np.float64).reshape(b, self.dim_dw, self.vshape[1])
        v = np.pad(v, ((0, 0), (0, self.vshape[0] - self.dim_dw), (0, 0)))
        return torch.as_tensor(v[:, r0:r0 + rows], device=self.device)

    def pad_flat(self, v_flat: np.ndarray) -> torch.Tensor:
        """Flat logical vector -> this rank's rows [L, du] of the padded
        vector."""
        return self.pad_flat_batch(np.asarray(v_flat)[None])[0]

    def unpad_gather(self, v_loc) -> np.ndarray:
        """This rank's rows of k vectors ([k, L * du] or [k, L, du]) ->
        the whole logical vectors [k, dim], host f64, on every rank."""
        v = torch.as_tensor(v_loc, device=self.device)
        v = v.reshape((v.shape[0],) + self.local_shape)
        full = self.mesh.allgather_rows(v)[:, :self.dim_dw]
        return full.reshape(v.shape[0], -1).double().cpu().numpy()


def matvec_dense_sharded(sop: ShardedSectorOp, v: torch.Tensor
                         ) -> torch.Tensor:
    """f64 apply on this rank's rows [..., L, du]."""
    op = sop.op
    apply_counts["dense_sharded"] += 1
    return op.diag * v + v @ op.hup + op.hdw @ sop.mesh.allgather_rows(v)


def matvec_dense_sharded_mixed(sop: ShardedSectorOp, v: torch.Tensor
                               ) -> torch.Tensor:
    """Mixed precision (true-f32 products, f64 diagonal) on this rank's
    rows; the all-gather moves the f32 copy."""
    op = sop.op
    apply_counts["dense_sharded"] += 1
    v32 = v.float()
    y32 = v32 @ op.hup32 + op.hdw32 @ sop.mesh.allgather_rows(v32)
    return op.diag * v + y32.to(v.dtype)


_ND_APPLY = {"f64": matvec_dense_sharded,
             "mixed": matvec_dense_sharded_mixed}


def pad_dense_op(op: DenseSectorOp, n: int) -> DenseSectorOp:
    """Zero-pad the dw axis to a multiple of the rank count (the
    communicator-shrink replacement). The pad rows form an exactly
    decoupled invariant subspace (their hdw rows and columns are zero);
    their diagonal is +PAD_SHIFT, so the pad spectrum sits far above every
    physical eigenvalue even if roundoff or a random restart leaks weight
    there."""
    dd = op.dim_dw
    pd = pad_to_multiple(dd, n) - dd
    if pd == 0:
        return op
    return DenseSectorOp(
        diag=F.pad(op.diag, (0, 0, 0, pd), value=PAD_SHIFT),
        hup=op.hup, hup32=op.hup32,
        hdw=F.pad(op.hdw, (0, pd, 0, pd)),
        hdw32=F.pad(op.hdw32, (0, pd, 0, pd)), nnz_count=op.nnz_count)


def shard_dense_op(op: DenseSectorOp, mesh: DwMesh, cfg: EDConfig
                   ) -> ShardedSectorOp:
    """Pad, and keep this rank's dw rows of the factors on its device."""
    dim_dw, dim = op.dim_dw, op.dim
    op = pad_dense_op(op, mesh.size)
    rows = op.dim_dw // mesh.size
    r = slice(mesh.rank * rows, (mesh.rank + 1) * rows)

    def put(t):
        return t.to(mesh.device).contiguous()
    local = DenseSectorOp(diag=put(op.diag[r]), hup=put(op.hup),
                          hup32=put(op.hup32), hdw=put(op.hdw[r]),
                          hdw32=put(op.hdw32[r]), nnz_count=op.nnz_count)
    return ShardedSectorOp(
        op=local, apply_nd=_ND_APPLY[resolve_precision(cfg, mesh.device)],
        exact_nd=matvec_dense_sharded, mesh=mesh,
        vshape=(op.dim_dw, op.dim_up), dim_dw=dim_dw, dim=dim)


def shard_sector_op(cfg: EDConfig, sec, hloc, bath, h_basis,
                    mesh: DwMesh) -> ShardedSectorOp:
    """The sharded operator of a sector (dense; built on the host, each
    rank keeping its rows)."""
    if resolve_backend(cfg, mesh.device) == "direct":
        raise NotImplementedError(
            "the sharded direct backend (pad_direct_op, shard_direct_op, "
            "apply_direct_sharded) is not ported yet (ROADMAP A10)")
    op = build_dense_op(cfg, sec, hloc, bath, "cpu", h_basis=h_basis)
    if op.ph_diag is not None or op.nd_a is not None:
        raise NotImplementedError(
            "dw-sharded phonon and Jx/Jp sectors are not ported yet "
            "(ROADMAP A10); solve them without mesh_shape")
    return shard_dense_op(op, mesh, cfg)


def sharded_dense_ground_state(sop: ShardedSectorOp, neigen: int,
                               ncv: int, tol: float, v0: torch.Tensor
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs over the sharded dense operator from this
    rank's rows `v0` [L, du] of the start vector (pad rows exactly 0):
    Lanczos in f64 with the production apply, the f64 polish where that
    apply is mixed, every sum over the ranks. Returns (values [k], whole
    logical vectors [k, dim] host f64), the same on every rank."""
    evals, evecs_loc = lanczos_ground_state(
        sop, sop.apply_nd, int(np.prod(sop.vshape)), neigen, ncv=ncv,
        tol=tol, dtype=torch.float64, v0=v0, vshape=sop.local_shape,
        polish_apply=(None if sop.exact_nd is sop.apply_nd
                      else sop.exact_nd),
        reduce=sop.mesh.allreduce, shard=(sop.mesh.rank, sop.mesh.size))
    return evals, sop.unpad_gather(evecs_loc)


def should_shard(cfg: EDConfig, mesh: Optional[DwMesh], dim_dw: int,
                 dim: int) -> bool:
    """Shard when a mesh is configured and the sector is large enough for
    the collectives to pay (small sectors stay on one rank, the analogue
    of the reference's communicator shrink for tiny DimDw)."""
    if mesh is None:
        return False
    return dim_dw >= max(cfg.ed_shard_min_dimdw, mesh.size)
