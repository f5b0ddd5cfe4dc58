"""Production dw-sharded sector solve (port of
``dmft_lanc_ed_tpu/parallel/production.py``).

In the reference every large sector is diagonalized through the
distributed matvec (P-ARPACK over spMatVec_mpi_main, ED_DIAG.f90:151-171)
and the GF tridiagonalization runs on scattered vectors
(ED_GF_NORMAL.f90:224-238). The JAX package places the sector operator on
a 1-D mesh and lets its partitioner turn ``H_dw @ V`` into a collective.
Here each rank holds the dw rows [d L, (d+1) L) of the padded vector
(``[..., L, du]``, or ``[..., DimPh, L, du]`` with phonons: the phonon
axis is whole on every rank) and of the operator, and the apply is plain
torch on the rank's device. Two operators:

- the **dense** one (:func:`shard_dense_op`): ``diag o v_loc + v_loc @
  H_up`` is local (the up index is whole on every rank); ``H_dw[local
  rows, :] @ allgather_rows(v)`` is the dw term, the collective the
  partitioner emitted (vector_transpose_MPI, ED_HAMILTONIAN_COMMON.f90:
  53-118); the Jx/Jp terms ``B_t[local rows, :] @ V @ A_t^T`` reuse that
  all-gather, and the phonon and e-ph terms act on the unsharded phonon
  axis;
- the **direct** (matrix-free) one (:func:`shard_direct_op`, the
  reference's direct_mpi/HxV_dw.f90 sandwich): the diagonal and the up
  hops are local in the row layout; the dw hops, and the dw factors of the
  Jx/Jp terms, are local in the up-column layout, between the two
  transposes of :meth:`~.mesh.DwMesh.rows_to_cols` /
  :meth:`~.mesh.DwMesh.cols_to_rows`. Its payload is the state masks and
  term lists, O(dim_dw + dim_up), where the dense one holds dim_dw^2
  factors.

The Lanczos inner products and norms are the mesh's ``allreduce``.

The communicator shrink (DimDw < ranks, ED_HAMILTONIAN.f90:66-94) becomes
padding of the dw axis to a multiple of the rank count: pad rows are
exact zeros of the vector, decoupled from every real row by the operator
(zero factor rows and columns; for the direct op all-ones masks that no
hop accepts), and their diagonal sits +PAD_SHIFT above the physics.

The dense operator, built from a band-sparse op's natural-order factors,
is also the second stage of the sharded band-sparse solve
(:mod:`.bs_sharded`): a Lanczos top-off from the B5 stage's vector and the
f64 polish, through :func:`sharded_ground_state`.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EDConfig
from ..ops.dense import DenseSectorOp, build_dense_op
from ..ops.direct import (MASK_BITS, DirectSectorOp, _apply_factor,
                          _row_gather_maps, add_phonon_terms,
                          build_direct_op, diag_mul)
from ..ops.factory import (direct_supported, resolve_backend,
                           resolve_precision)
from ..ops.lanczos import lanczos_ground_state
from .mesh import DwMesh, make_mesh, pad_to_multiple
from .multihost import process_info

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

PAD_SHIFT = 1.0e3   # diagonal shift of padded rows (see pad_dense_op)

# since the last reset: applies of the sharded dense operator (diag, GF,
# and the band-sparse sectors' top-off) and of the sharded direct one,
# and GF chains run over either
apply_counts = {"dense_sharded": 0, "direct_sharded": 0, "gf_chains": 0}


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
    """This rank's rows of a dw-sharded (padded) sector operator."""
    op: object                 # DenseSectorOp (diag [L, du], hdw [L, ddp],
    #                            ...; hup whole) or ShardedDirectOp
    apply_nd: Callable         # production apply on [..., (P,) L, du]
    exact_nd: Callable         # f64 apply (polish)
    mesh: DwMesh
    vshape: Tuple[int, ...]    # padded natural vector shape ((P,) ddp, du)
    dim_dw: int                # logical (unpadded) dw dimension
    dim: int                   # logical flat dimension

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's block: the row axis (-2) split over the ranks."""
        return self.vshape[:-2] + (self.vshape[-2] // self.mesh.size,
                                   self.vshape[-1])

    @property
    def nnz(self) -> int:
        """The whole sector's nonzeros a matvec applies (counters)."""
        return self.op.nnz_count

    @property
    def device(self) -> torch.device:
        return self.op.device

    def apply_flat(self, v: torch.Tensor) -> torch.Tensor:
        """The production apply on flat [..., prod(local_shape)] blocks."""
        return self.apply_nd(self, v.reshape(v.shape[:-1] + self.local_shape)
                             ).reshape(v.shape)

    def pad_flat_batch(self, vs: np.ndarray) -> torch.Tensor:
        """[B, dim] flat logical vectors -> this rank's rows of the padded
        vectors, [B, *local_shape] f64 on the device."""
        b = vs.shape[0]
        rows = self.local_shape[-2]
        r0 = self.mesh.rank * rows
        v = np.asarray(vs, np.float64).reshape(
            (b,) + self.vshape[:-2] + (self.dim_dw, self.vshape[-1]))
        pad = [(0, 0)] * v.ndim
        pad[-2] = (0, self.vshape[-2] - self.dim_dw)
        v = np.pad(v, pad)
        return torch.as_tensor(v[..., r0:r0 + rows, :], device=self.device)

    def pad_flat(self, v_flat: np.ndarray) -> torch.Tensor:
        """Flat logical vector -> this rank's rows of the padded vector."""
        return self.pad_flat_batch(np.asarray(v_flat)[None])[0]

    def unpad_flat(self, v_nd) -> np.ndarray:
        """Padded whole vector (every rank's rows, natural shape) -> flat
        logical vector, host f64."""
        v = torch.as_tensor(v_nd).reshape(self.vshape)[..., :self.dim_dw, :]
        return v.reshape(-1).double().cpu().numpy()

    def unpad_gather(self, v_loc) -> np.ndarray:
        """This rank's rows of k vectors ([k, prod(local_shape)] or [k,
        *local_shape]) -> the whole logical vectors [k, dim], host f64, on
        every rank."""
        v = torch.as_tensor(v_loc, device=self.device)
        v = v.reshape((v.shape[0],) + self.local_shape)
        full = self.mesh.allgather_rows(v)
        return np.stack([self.unpad_flat(f) for f in full])


# --------------------------------------------------------------------------
# sharded dense backend
# --------------------------------------------------------------------------
def _apply_dense_sharded(sop: ShardedSectorOp, v: torch.Tensor, hup, hdw,
                         nd_a, nd_b) -> torch.Tensor:
    """ops/dense._apply_dense on this rank's rows: the products in hup's
    dtype over one all-gather of the vector (the dw and the Jx/Jp terms),
    the diagonal and the phonon-number term in the vector's dtype."""
    op = sop.op
    ph = op.ph_diag is not None

    def el(t, extra=0):
        return t.unsqueeze(-3 - extra) if ph else t
    vc = v.to(hup.dtype)
    vg = sop.mesh.allgather_rows(vc)                  # [..., (P,) ddp, du]
    y = vc @ el(hup) + el(hdw) @ vg
    if nd_a is not None:
        # sum_t B_t[rows, :] @ V @ A_t^T over the stacked terms
        bv = el(nd_b, 1) @ vg.unsqueeze(-3)           # [..., T, L, du]
        y = y + (bv @ el(nd_a, 1).transpose(-1, -2)).sum(-3)
    if ph:
        ev = (el(op.eph_el).to(hup.dtype) * vc).flatten(-2)
        y = y + (op.eph_x.to(hup.dtype) @ ev).reshape(y.shape)
    out = el(op.diag) * v + y.to(v.dtype)
    if ph:
        out = out + op.ph_diag[..., None, None].to(v.dtype) * v
    return out


def matvec_dense_sharded(sop: ShardedSectorOp, v: torch.Tensor
                         ) -> torch.Tensor:
    """f64 apply on this rank's rows [..., (P,) L, du]."""
    op = sop.op
    apply_counts["dense_sharded"] += 1
    return _apply_dense_sharded(sop, v, op.hup, op.hdw, op.nd_a, op.nd_b)


def matvec_dense_sharded_mixed(sop: ShardedSectorOp, v: torch.Tensor
                               ) -> torch.Tensor:
    """Mixed precision (true-f32 products, f64 diagonal and phonon
    number) on this rank's rows; the all-gather moves the f32 copy."""
    op = sop.op
    apply_counts["dense_sharded"] += 1
    return _apply_dense_sharded(sop, v, op.hup32, op.hdw32, op.nd_a32,
                                op.nd_b32)


_ND_APPLY = {"f64": matvec_dense_sharded,
             "mixed": matvec_dense_sharded_mixed}


def pad_dense_op(op: DenseSectorOp, n: int) -> DenseSectorOp:
    """Zero-pad the dw axis to a multiple of the rank count (the
    communicator-shrink replacement): hdw and the Jx/Jp factors nd_b on
    both dw axes, the e-ph electron factor on its dw rows. The pad rows
    form an exactly decoupled invariant subspace (their factor rows and
    columns are zero); their diagonal is +PAD_SHIFT, so the pad spectrum
    sits far above every physical eigenvalue even if roundoff or a random
    restart leaks weight there."""
    dd = op.dim_dw
    pd = pad_to_multiple(dd, n) - dd
    if pd == 0:
        return op
    kw = {}
    if op.nd_a is not None:
        kw.update(nd_a=op.nd_a, nd_a32=op.nd_a32,
                  nd_b=F.pad(op.nd_b, (0, pd, 0, pd)),
                  nd_b32=F.pad(op.nd_b32, (0, pd, 0, pd)))
    if op.ph_diag is not None:
        kw.update(ph_diag=op.ph_diag, eph_x=op.eph_x,
                  eph_el=F.pad(op.eph_el, (0, 0, 0, pd)))
    return DenseSectorOp(
        diag=F.pad(op.diag, (0, 0, 0, pd), value=PAD_SHIFT),
        hup=op.hup, hup32=op.hup32,
        hdw=F.pad(op.hdw, (0, pd, 0, pd)),
        hdw32=F.pad(op.hdw32, (0, pd, 0, pd)), nnz_count=op.nnz_count, **kw)


def shard_dense_op(op: DenseSectorOp, mesh: DwMesh, cfg: EDConfig
                   ) -> ShardedSectorOp:
    """Pad, and keep this rank's dw rows of the factors on its device (the
    JAX package's P(ax, None) and, for nd_b, P(None, ax, None))."""
    dim_dw, dim = op.dim_dw, op.dim
    op = pad_dense_op(op, mesh.size)
    rows = op.dim_dw // mesh.size
    r = slice(mesh.rank * rows, (mesh.rank + 1) * rows)

    def put(t):
        return t.to(mesh.device).contiguous()
    kw = {}
    if op.nd_a is not None:
        kw.update(nd_a=put(op.nd_a), nd_a32=put(op.nd_a32),
                  nd_b=put(op.nd_b[:, r]), nd_b32=put(op.nd_b32[:, r]))
    if op.ph_diag is not None:
        kw.update(ph_diag=put(op.ph_diag), eph_x=put(op.eph_x),
                  eph_el=put(op.eph_el[r]))
    local = DenseSectorOp(diag=put(op.diag[r]), hup=put(op.hup),
                          hup32=put(op.hup32), hdw=put(op.hdw[r]),
                          hdw32=put(op.hdw32[r]), nnz_count=op.nnz_count,
                          **kw)
    return ShardedSectorOp(
        op=local, apply_nd=_ND_APPLY[resolve_precision(cfg, mesh.device)],
        exact_nd=matvec_dense_sharded, mesh=mesh, vshape=op.vshape,
        dim_dw=dim_dw, dim=dim)


# --------------------------------------------------------------------------
# sharded matrix-free (direct) backend
# --------------------------------------------------------------------------
# Pad dw masks: all of the masks' 32 levels occupied, so no hop's
# J-condition (bit_d empty) accepts a pad row, and the mask sorts at or
# above every real one for torch.searchsorted (the JAX package's int32
# masks pad with 0x7FFFFFFF; the port's int64 masks reach bit 31).
PAD_MASK = (1 << MASK_BITS) - 1


@dataclass(frozen=True)
class ShardedDirectOp:
    """This rank's part of a padded DirectSectorOp: ``local`` holds its dw
    rows of the masks and of the factored diagonal (the row layout's
    terms), ``states_dw`` every padded dw mask (the column layout's dw
    hops)."""
    local: DirectSectorOp
    states_dw: torch.Tensor
    nnz_count: int             # the logical sector's (counters)

    @property
    def device(self) -> torch.device:
        return self.states_dw.device

    @property
    def nbytes(self) -> int:
        """Bytes of the tensors this rank holds."""
        ts = [getattr(self.local, f.name)
              for f in dataclasses.fields(self.local)] + [self.states_dw]
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))


def pad_direct_op(op: DirectSectorOp, n: int) -> DirectSectorOp:
    """Pad the dw axis of a DirectSectorOp to a multiple of n: PAD_MASK
    masks, diag_dw shifted by PAD_SHIFT, zero bilinear factor rows."""
    dd = op.dim_dw
    pd = pad_to_multiple(dd, n) - dd
    if pd == 0:
        return op
    return dataclasses.replace(
        op, states_dw=torch.cat([op.states_dw, op.states_dw.new_full(
            (pd,), PAD_MASK)]),
        diag_dw=F.pad(op.diag_dw, (0, pd), value=PAD_SHIFT),
        diag_a=F.pad(op.diag_a, (0, 0, 0, pd)))


def apply_direct_sharded(sop: ShardedSectorOp, v: torch.Tensor
                         ) -> torch.Tensor:
    """y = H v on this rank's rows [..., (P,) L, du]: the diagonal and the
    up hops in the row layout; the dw hops and the Jx/Jp terms' dw factors
    in the column layout, their blocks (v and each term's up-gathered v)
    moved in one all-to-all each way; the phonon terms on the whole
    phonon axis."""
    so = sop.op
    op, mesh = so.local, sop.mesh
    apply_counts["direct_sharded"] += 1
    y = diag_mul(op, v)
    y = y + _apply_factor(op.states_up, op.up_c, op.up_d, op.up_a, v, -1)
    blocks = [v]
    if op.nd_a is not None:
        src_u, w_u = _row_gather_maps(op.states_up, op.nd_up_c, op.nd_up_d)
        blocks += [v.index_select(-1, src_u[t]) * w_u[t].to(v.dtype)
                   for t in range(op.nd_a.shape[0])]
    w = mesh.rows_to_cols(torch.stack(blocks))        # [1 + T, ..., ddp, c]
    yc = _apply_factor(so.states_dw, op.dw_c, op.dw_d, op.dw_a, w[0], -2)
    if op.nd_a is not None:
        src_d, w_d = _row_gather_maps(so.states_dw, op.nd_dw_c, op.nd_dw_d)
        for t in range(op.nd_a.shape[0]):
            yc = yc + op.nd_a[t] * (w[1 + t].index_select(-2, src_d[t])
                                    * w_d[t].to(v.dtype)[:, None])
    y = y + mesh.cols_to_rows(yc, v.shape[-1])
    if op.ph_n is not None:
        y = add_phonon_terms(op, v, y)
    return y


def shard_direct_op(op: DirectSectorOp, mesh: DwMesh, cfg: EDConfig
                    ) -> ShardedSectorOp:
    """Pad, and keep this rank's dw rows of the masks and of the factored
    diagonal on its device, the term lists and every mask whole."""
    dim_dw, dim, nnz = op.dim_dw, op.dim, op.nnz
    op = pad_direct_op(op, mesh.size)
    rows = op.dim_dw // mesh.size
    r = slice(mesh.rank * rows, (mesh.rank + 1) * rows)

    def put(t):
        return t.to(mesh.device).contiguous() \
            if isinstance(t, torch.Tensor) else t
    moved = dataclasses.replace(op, **{
        f.name: put(getattr(op, f.name)) for f in dataclasses.fields(op)})
    local = dataclasses.replace(moved, states_dw=moved.states_dw[r],
                                diag_dw=moved.diag_dw[r],
                                diag_a=moved.diag_a[r])
    return ShardedSectorOp(
        op=ShardedDirectOp(local=local, states_dw=moved.states_dw,
                           nnz_count=nnz),
        apply_nd=apply_direct_sharded, exact_nd=apply_direct_sharded,
        mesh=mesh, vshape=op.vshape, dim_dw=dim_dw, dim=dim)


def sharded_backend(cfg: EDConfig, device) -> str:
    """The sharded operator :func:`shard_sector_op` builds: "direct" under
    ``ed_backend="direct"`` or ``ed_sparse_h=F`` (where the masks fit),
    else "dense"."""
    if resolve_backend(cfg, device) != "direct":
        return "dense"
    if direct_supported(cfg):
        return "direct"
    log.warning("ed_backend=direct: %d levels exceed the direct backend's "
                "%d-bit masks; sharded dense backend", cfg.ns, MASK_BITS)
    return "dense"


def shard_sector_op(cfg: EDConfig, sec, hloc, bath, h_basis,
                    mesh: DwMesh) -> ShardedSectorOp:
    """The sharded operator of a sector, dense or direct
    (:func:`sharded_backend`), built on the host, each rank keeping its
    rows."""
    if sharded_backend(cfg, mesh.device) == "direct":
        return shard_direct_op(build_direct_op(
            cfg, sec, hloc, bath, "cpu", h_basis=h_basis), mesh, cfg)
    return shard_dense_op(build_dense_op(
        cfg, sec, hloc, bath, "cpu", h_basis=h_basis), mesh, cfg)


def sharded_ground_state(sop: ShardedSectorOp, neigen: int,
                               ncv: int, tol: float, v0: torch.Tensor
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs over a sharded operator (dense or
    direct) from this rank's rows `v0` [*local_shape] of the start vector
    (pad rows exactly 0): Lanczos in f64 with the production apply, the
    f64 polish where that apply is mixed, every sum over the ranks.
    Returns (values [k], whole logical vectors [k, dim] host f64), the
    same on every rank."""
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
