"""Dw-sharded band-sparse matvec, kernel B5, and its two-stage ground state
(port of ``dmft_lanc_ed_tpu/parallel/bs_sharded.py``).

Past one device the reference distributes its hot SpMV by a row split with
vector_transpose_MPI halo motion (spMatVec_mpi_main,
ED_HAMILTONIAN_COMMON.f90:53-118). The band-sparse form exploits the RCM
band instead of a full transpose:

- the permuted padded vector [ddp, dup] is dw-row-sharded: rank d holds
  rows [d L, (d+1) L), L = ddp / n;
- the up contraction is local (it contracts lanes, and every rank holds
  all lanes), and so is the separable diagonal;
- the dw contraction needs only the band of rows around each local panel:
  two halo strips of d_dw * 128 rows from the neighbouring ranks
  (:meth:`~.mesh.DwMesh.halo`), not an all-gather;
- the Lanczos inner products and norms are sums over the ranks.

Applicability: each rank must hold the window reach, ``ntd / n >= d_dw +
1`` (:func:`bs_shard_applicable`). Elsewhere the production dispatch takes
the sharded dense operator (:mod:`.production`).

B5, hand-written CUDA in ``csrc/bs_matvec.cu`` (``bs_matvec`` given a
window table), replaces ``bs_sharded.py:_local_kernel``: one rank's rows of
the whole-window kernel B1b, the window start of each local panel read from
a host table (:func:`local_window_tiles`) instead of the clamp, relative to
the halo'd rows, with B1's six-pass split-bf16 products on the tensor
cores (1/n of B1b's operations per rank). A call is two launches, the
split of the halo'd rows and the product. Beside it, its plain PyTorch
version :func:`_local_call_plain`, the same six passes through the dense
padded f32 factors' split, cut from the op at its first call (a shard that
only launches B5 never holds them); :func:`_local_call` runs the plain
version only for a tensor on the CPU, launches the kernel for a CUDA
tensor or raises, and counts launches in :data:`launch_counts`.

The two-stage ground state, the single-card solve's split
(``diag._blocksparse_ground_state``) over the ranks: an f32 thick restart
over B5 with the rank sums as its ``reduce``; then, from its vector, a
Lanczos top-off over the sharded dense operator of the natural-order
factors (:func:`.production.sharded_ground_state`: mixed products
and the f64 Rayleigh-Ritz polish on the card, f64 on the CPU). The JAX
package polishes on the host instead, which contracts the residual only
~1.4x per call from an f32 vector.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.bf16x3 import dot6_plain, split3_bf16
from ..ops.blocksparse import (BS_DEVICE_BUDGET, BlockSparseSectorOp,
                               BsPaddedOp, _aca, _band, _factor_dense,
                               _pad128, _panel_ss, _pop, _rcm_perm,
                               _runs_table, from_padded, split3_rows,
                               ticket, to_padded)
from ..ops.dense import DenseSectorOp
from ..ops.lanczos import lanczos_ground_state
from .mesh import DwMesh, pad_to_multiple
from .production import shard_dense_op, sharded_ground_state

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

# B5 launches since the last reset
launch_counts = {"sharded_matvec": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def bs_shard_applicable(op, n: int) -> bool:
    """Row split must be a tile multiple and cover the window reach."""
    ntd = op.padded_shape[0] // 128
    return ntd % n == 0 and ntd // n >= _pop(op).d_dw + 1


def _window_tiles(op) -> np.ndarray:
    """Global per-panel window start, in tiles (the op's window clamp)."""
    pop = _pop(op)
    ddp = pop.padded_shape[0]
    i = np.arange(ddp // 128)
    return np.clip(i - pop.d_dw, 0, (ddp - pop.w_dw) // 128).astype(np.int32)


def local_window_tiles(op, n: int) -> np.ndarray:
    """[n, ntl] per-rank window starts of the local panels, in tiles of the
    rank's halo'd rows, whose first row is global row (d ntl - d_dw) 128
    (bs_sharded.py:174-180)."""
    d_dw = _pop(op).d_dw
    t_glob = _window_tiles(op)
    ntl = len(t_glob) // n
    return np.stack([t_glob[d * ntl:(d + 1) * ntl] - (d * ntl - d_dw)
                     for d in range(n)]).astype(np.int32)


@dataclass(frozen=True)
class BsShard:
    """One rank's part of the band-sparse operator, on its device."""
    dw: Tuple                 # 3 x [ntl, 128, W_dw] bf16, the (hi, mid, lo)
                              # of the rank's dw slabs
    up: Tuple                 # 3 x [ntu, W_up, 128] bf16, of all up slabs
    diag_a: torch.Tensor      # [local, R] f32, the rank's rows
    diag_b: torch.Tensor      # [R, dup] f32
    t_tiles: torch.Tensor     # [ntl] int32 window starts (local_window_tiles)
    runs: Tuple               # whole-window run tables (dw local, up)
    src: BsPaddedOp           # the op it was cut from (the plain version's)
    rank: int = 0
    n: int = 1
    w_dw: int = 0
    d_dw: int = 0
    w_up: int = 0
    d_up: int = 0
    # the plain version's factors, made at its first call (_plain_factors)
    plain: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def local(self) -> int:
        return self.diag_a.shape[0]

    @property
    def halo(self) -> int:
        return 128 * self.d_dw

    @property
    def ext(self) -> int:
        return self.local + 2 * self.halo

    @property
    def dup(self) -> int:
        return self.diag_b.shape[1]

    @property
    def device(self) -> torch.device:
        return self.diag_a.device


def shard_bs_op(op, n: int, rank: int, device) -> BsShard:
    """Rank `rank` of n's part of the band-sparse op, on `device`."""
    if not bs_shard_applicable(op, n):
        pop = _pop(op)
        raise ValueError(
            f"band-sparse shard constraint violated: ntd="
            f"{pop.padded_shape[0] // 128}, n={n}, d_dw={pop.d_dw} "
            "(need ntd % n == 0 and ntd/n >= d_dw + 1)")
    pop = _pop(op)
    ddp, dup = pop.padded_shape
    ntl = ddp // 128 // n
    local, halo = 128 * ntl, 128 * pop.d_dw
    r0 = rank * local
    t_loc = local_window_tiles(op, n)[rank]
    if t_loc.min() < 0 or 128 * t_loc.max() + pop.w_dw > local + 2 * halo:
        raise ValueError("band-sparse shard: a dw window leaves the halo'd "
                         "rows")

    def put(t):
        return t.to(device).contiguous()

    def parts(t):
        return tuple(put(p) for p in split3_bf16(t))
    full_dw = (((0, pop.w_dw // 128),),) * ntl
    full_up = (((0, pop.w_up // 128),),) * (dup // 128)
    return BsShard(
        dw=parts(pop.dw_f32[rank * ntl:(rank + 1) * ntl]),
        up=parts(pop.up_f32),
        diag_a=put(pop.diag_a[r0:r0 + local]), diag_b=put(pop.diag_b),
        t_tiles=torch.as_tensor(t_loc, device=device),
        runs=(*_runs_table(full_dw, device), *_runs_table(full_up, device)),
        src=pop, rank=rank, n=n, w_dw=pop.w_dw, d_dw=pop.d_dw,
        w_up=pop.w_up, d_up=pop.d_up)


def shard_rows(v_full: torch.Tensor, sh: BsShard
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v_loc, v_ext) of rank sh.rank from a whole padded vector [ddp, dup]
    by slicing: its rows, and its rows with the halo strips (zeros past the
    ends) — what the halo exchange assembles."""
    r0 = sh.rank * sh.local
    lo = r0 - sh.halo
    c0, c1 = max(lo, 0), min(r0 + sh.local + sh.halo, v_full.shape[0])
    ext = torch.zeros((sh.ext,) + tuple(v_full.shape[1:]),
                      dtype=v_full.dtype, device=v_full.device)
    ext[c0 - lo:c1 - lo] = v_full[c0:c1]
    return v_full[r0:r0 + sh.local].contiguous(), ext


def _plain_factors(sh: BsShard) -> Dict:
    """The plain version's dense factors on the shard's device, cut from
    the op at the first call and kept: the rank's rows of H_dw,p against
    its halo'd rows (zero past the ends) [local, ext] and H_up,p [dup, dup]
    in f32 (``hdw_ext``, ``hup``), and the (hi, mid, lo) of each held as
    f32 (``hdw3``, ``hup3``)."""
    if not sh.plain:
        pop = sh.src
        ddp = pop.padded_shape[0]
        r0 = sh.rank * sh.local
        lo = r0 - sh.halo
        c0, c1 = max(lo, 0), min(r0 + sh.local + sh.halo, ddp)
        hdw_ext = torch.zeros((sh.local, sh.ext), dtype=torch.float32,
                              device=sh.device)
        hdw_ext[:, c0 - lo:c1 - lo] = pop.hdw_p32[r0:r0 + sh.local, c0:c1]
        hup = pop.hup_p32.to(sh.device)
        sh.plain.update(
            hdw_ext=hdw_ext, hup=hup,
            hdw3=tuple(p.float() for p in split3_bf16(hdw_ext)),
            hup3=tuple(p.float() for p in split3_bf16(hup)))
    return sh.plain


def _local_call_plain(sh: BsShard, v_loc: torch.Tensor, v_ext: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B5: (y_loc, per-local-panel sums of squares [ntl]
    f32) = ((A_loc B) o v_loc + H_dw,p[rows] v_ext + v_loc H_up,p) with
    the kernel's six-pass products of the three-part splits of the vectors
    and of the dense padded f32 factors."""
    f = _plain_factors(sh)
    y = ((sh.diag_a @ sh.diag_b) * v_loc
         + dot6_plain(f["hdw3"], split3_bf16(v_ext))
         + dot6_plain(split3_bf16(v_loc), f["hup3"]))
    return y, _panel_ss(y)


def _local_call(sh: BsShard, v_loc: torch.Tensor, v_ext: torch.Tensor,
                tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 on one rank: (y_loc [local, dup] f32, per-local-panel sums of
    squares [ntl] f32) from the rank's rows v_loc [local, dup] and its
    halo'd rows v_ext [local + 2 halo, dup], f32. `tile`: the output
    tile's width on the card (32 or 128; 0 for the launcher's choice)."""
    if v_loc.device.type == "cpu":
        return _local_call_plain(sh, v_loc, v_ext)
    if not v_loc.is_cuda:
        raise ValueError(f"sharded matvec: unsupported device {v_loc.device}")
    from .. import _kernels
    lib = _kernels.lib()
    v_loc, v_ext = v_loc.contiguous(), v_ext.contiguous()
    f32 = (v_loc, v_ext, sh.diag_a, sh.diag_b)
    slabs = sh.dw + sh.up
    if any(t.device != v_loc.device
           for t in f32 + slabs + (sh.t_tiles,)):
        raise ValueError("sharded matvec: operator and vectors on different "
                         "devices")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in f32):
        raise ValueError("sharded matvec: needs contiguous f32 tensors")
    if (tuple(v_loc.shape) != (sh.local, sh.dup)
            or tuple(v_ext.shape) != (sh.ext, sh.dup)):
        raise ValueError(f"sharded matvec: vectors {tuple(v_loc.shape)}, "
                         f"{tuple(v_ext.shape)} vs shard "
                         f"{(sh.local, sh.dup)}, {(sh.ext, sh.dup)}")
    dev = v_loc.device
    parts = split3_rows(v_ext)
    y = torch.empty_like(v_loc)
    ss = torch.empty(sh.local // 128, dtype=torch.float32, device=dev)
    partials = torch.empty(lib.bs_matvec_nblk(sh.local, sh.dup),
                           dtype=torch.float64, device=dev)
    err = lib.bs_matvec(
        *(t.data_ptr() for t in slabs), sh.diag_a.data_ptr(),
        sh.diag_b.data_ptr(), v_loc.data_ptr(), parts.data_ptr(),
        sh.t_tiles.data_ptr(), y.data_ptr(), None, 1.0, partials.data_ptr(),
        ticket(dev).data_ptr(), ss.data_ptr(),
        *(t.data_ptr() for t in sh.runs), sh.local, sh.ext, sh.dup,
        sh.diag_a.shape[1], sh.w_dw, sh.d_dw, sh.w_up, sh.d_up, tile,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_matvec (sharded)")
    launch_counts["sharded_matvec"] += 1
    return y, ss


@dataclass(frozen=True)
class ShardedBsOp:
    """The rank's shard and its mesh: the operator handed to the Lanczos
    solver (its vectors are the rank's rows [local, dup])."""
    shard: BsShard
    mesh: DwMesh
    nnz: int = 0          # the whole sector's nonzeros a matvec applies

    @property
    def device(self) -> torch.device:
        return self.shard.device

    def local_apply(self, v_loc: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Halo exchange + B5: (y_loc, local panel sums of squares)."""
        top, bottom = self.mesh.halo(v_loc, self.shard.halo)
        return _local_call(self.shard, v_loc,
                           torch.cat([top, v_loc, bottom]))


def _sharded_bs_apply(op: ShardedBsOp, v: torch.Tensor) -> torch.Tensor:
    return op.local_apply(v)[0]


def make_sharded_bs_matvec(op: BlockSparseSectorOp, mesh: DwMesh):
    """Build `(apply, sop)`: apply(v_loc [local, dup] f32, this rank's rows
    of the permuted padded vector) -> (y_loc, total sum of squares over
    the ranks), the semantics of the single-device
    ``_matvec_padded(op, v, 1.0)`` on the stitched vector; `sop` is the
    rank's :class:`ShardedBsOp`."""
    sop = ShardedBsOp(shard_bs_op(op, mesh.size, mesh.rank, mesh.device),
                      mesh, op.nnz)

    def apply(v_loc: torch.Tensor):
        y, ss = sop.local_apply(v_loc)
        return y, mesh.allreduce(ss.double().sum())

    return apply, sop


def _shard_bytes(ntl: int, dup: int, w_dw: int, w_up: int, d_dw: int,
                 dd: int, du: int, n: int) -> int:
    """Device bytes of one rank: its B5 shard and the vectors of one apply,
    and the top-off's rows of the natural-order dense operator (dd x du
    sector, dw padded to a multiple of n)."""
    local, halo = 128 * ntl, 128 * d_dw
    rows = pad_to_multiple(dd, n) // n
    return (6 * local * w_dw + 6 * dup * w_up          # dw, up slabs' parts
            + 4 * (local + dup) * 32                   # diagonal factors
            + 4 * (3 * local + 2 * halo) * dup         # v_loc, v_ext, y
            + 6 * (local + 2 * halo) * dup             # v_ext's parts
            + 12 * (rows * pad_to_multiple(dd, n) + du * du)  # f64 + f32
            + 8 * rows * du)                           # natural diagonal


def blocksparse_shardable(h, n: int) -> Optional[str]:
    """None if the sharded band-sparse path applies to this sector
    Hamiltonian on n ranks; else a human-readable reason (the logged
    dispatch policy). The JAX package's per-device VMEM gate becomes a
    per-rank gate on the card's memory, as ``blocksparse_applicable``
    gates the single-device op."""
    if h.ph_diag is not None:
        return "phonon sector"
    if h.nd_up_src is not None:
        return "non-local Jx/Jp terms"
    if _aca(np.asarray(h.diag, np.float64)) is None:
        return "diagonal not ACA-separable"
    ddp, dup = _pad128(h.dim_dw), _pad128(h.dim_up)
    ntd = ddp // 128
    hup = _factor_dense(h.up_cols, h.up_vals, h.dim_up)
    hdw = _factor_dense(h.dw_cols, h.dw_vals, h.dim_dw)
    pu, pd = _rcm_perm(hup), _rcm_perm(hdw)
    w_up = min((2 * ((_band(hup[pu][:, pu]) + 127) // 128) + 1) * 128, dup)
    band_d = (_band(hdw[pd][:, pd]) + 127) // 128
    w_dw = min((2 * band_d + 1) * 128, ddp)
    if ntd % n != 0 or ntd // n < band_d + 1:
        return (f"band constraint (ntd={ntd}, n={n}, d_dw={band_d}: "
                "need ntd % n == 0 and ntd/n >= d_dw+1)")
    per_rank = _shard_bytes(ntd // n, dup, w_dw, w_up, band_d, h.dim_dw,
                            h.dim_up, n)
    if per_rank > BS_DEVICE_BUDGET:
        return f"per-rank device memory ({per_rank / 2**30:.1f} GiB)"
    return None


def bs_sharded_ground_state(cfg, op: BlockSparseSectorOp, mesh: DwMesh,
                            neigen: int, ncv: int, tol: float = 5e-5
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Sharded two-stage ground state: an f32 thick-restart Lanczos over B5
    (stage 1 to `tol`; its projections and norms summed over the ranks,
    as P-ARPACK's internal reductions), then the top-off and f64 polish
    over the sharded natural-order operator from stage 1's vector (stage
    2). `op` may live on the host; each rank moves only its shards to its
    device. Returns (evals [k], natural flat evecs [k, dim]), the same on
    every rank."""
    _, sop = make_sharded_bs_matvec(op, mesh)
    local, dup = sop.shard.local, sop.shard.dup
    r0 = mesh.rank * local
    v0n = np.random.default_rng(17).standard_normal((op.dim_dw, op.dim_up))
    v0 = to_padded(op, v0n / np.linalg.norm(v0n))[r0:r0 + local]
    _, evecs_loc = lanczos_ground_state(
        sop, _sharded_bs_apply, int(np.prod(op.padded_shape)), neigen,
        ncv=ncv, tol=tol, dtype=torch.float32, v0=v0.to(mesh.device),
        vshape=(local, dup), reduce=mesh.allreduce,
        shard=(mesh.rank, mesh.size))
    # stage 1's lowest vector, gathered and returned to the natural order,
    # seeds stage 2 (the single-card solve seeds its top-off the same way)
    full = mesh.allgather_rows(torch.as_tensor(
        evecs_loc[:1], device=mesh.device).reshape(1, local, dup))
    seed = from_padded(op, full.to(op.device), torch.float64)
    # this rank's rows of the dense operator of the op's natural factors
    nat = shard_dense_op(DenseSectorOp(
        diag=op.diag, hup=op.hup, hdw=op.hdw, hup32=op.hup32,
        hdw32=op.hdw32, nnz_count=op.nnz_count), mesh, cfg)
    # the top-off's residual floor is its apply's (diag._lanc_tol): f64
    # products, or mixed ones polished after
    floor = 1e-14 if nat.apply_nd is nat.exact_nd else 3e-6
    return sharded_ground_state(
        nat, neigen, ncv, max(cfg.lanc_tolerance, floor),
        nat.pad_flat(seed.reshape(-1).cpu().numpy()))
