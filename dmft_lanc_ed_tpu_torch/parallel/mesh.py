"""The 1-D "dw" group (port of ``dmft_lanc_ed_tpu/parallel/mesh.py``).

The reference's communicator handling (ED_VARS_GLOBAL ed_set_MpiComm, the
communicator shrink of ED_HAMILTONIAN.f90:66-94) is, in the JAX package, a
1-D ``jax.sharding.Mesh`` over the "dw" axis plus zero padding of the
sector arrays to a multiple of the mesh size. In the port the mesh is the
group of running ranks, and :class:`DwMesh` is the only place collectives
are written:

- :meth:`DwMesh.allreduce` — a sum over the ranks in rank order (all-gather,
  then one fixed-order sum), so every rank holds the same bits;
- :meth:`DwMesh.allgather_rows` — the full vector from the row shards;
- :meth:`DwMesh.halo` — the two strips of the band-sparse halo exchange;
- :meth:`DwMesh.rows_to_cols` / :meth:`DwMesh.cols_to_rows` — the
  reference's vector_transpose_MPI (ED_HAMILTONIAN_COMMON.f90:53-118): a
  dw-row block ``[..., L, du]`` becomes this rank's up columns of every
  row, ``[..., ddp, c_rank]``, and back, one all-to-all each way. The up
  axis splits unevenly where the ranks do not divide it
  (:meth:`DwMesh.col_split`); the JAX package's ``shard_map`` pads it
  instead.

Every collective moves its tensors on the transport's own device and
returns them on the caller's: host memory under gloo (its point-to-point
operations take host tensors; ranks sharing one card stage through it),
the rank's card under NCCL (which takes CUDA tensors only; a host
tensor, as in ``multihost.allreduce_sites``, is staged through the card).
"""
from __future__ import annotations

import logging
import math
from typing import Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


class DwMesh:
    """The running ranks as one dw-row-sharded group, computing on
    `device`."""

    def __init__(self, n: int, device):
        self.size = n
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.transport = dist.get_backend()
        # the device the transport moves tensors on
        self.wire = (torch.device("cpu") if self.transport == "gloo" else
                     torch.device("cuda", torch.cuda.current_device()))

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.wire).contiguous()

    def _gather(self, t: torch.Tensor) -> list:
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return parts

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks, added in rank order."""
        parts = self._gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out.to(t.device)

    def allgather_rows(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The ranks' row blocks of `t`, concatenated along `dim` in rank
        order."""
        return torch.cat(self._gather(t), dim=dim).to(t.device)

    def col_split(self, du: int) -> list:
        """The up columns each rank holds in the column layout: du split
        as evenly as it goes, the first du % size ranks one more."""
        q, r = divmod(du, self.size)
        return [q + (i < r) for i in range(self.size)]

    def rows_to_cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row block [..., L, du] -> this rank's up columns of
        the whole padded vector, [..., size * L, c] (rows in rank order)."""
        lead, rows, du = t.shape[:-2], t.shape[-2], t.shape[-1]
        split = self.col_split(du)
        # the blocks are packed and unpacked on the caller's device; only
        # the packed buffers cross to the transport's
        send = self._wire(torch.cat([p.reshape(-1)
                                     for p in torch.split(t, split, -1)]))
        per = math.prod(lead) * rows
        mine = split[self.rank]
        recv = torch.empty(per * mine * self.size, dtype=t.dtype,
                           device=self.wire)
        dist.all_to_all_single(recv, send, [per * mine] * self.size,
                               [per * c for c in split])
        out = recv.to(t.device).reshape((self.size,) + lead + (rows, mine))
        return out.movedim(0, -3).reshape(lead + (self.size * rows, mine))

    def cols_to_rows(self, t: torch.Tensor, du: int) -> torch.Tensor:
        """The inverse of :meth:`rows_to_cols`: this rank's up columns
        [..., size * L, c] -> its row block [..., L, du]."""
        lead, mine = t.shape[:-2], t.shape[-1]
        rows = t.shape[-2] // self.size
        split = self.col_split(du)
        send = self._wire(t.reshape(lead + (self.size, rows, mine))
                          .movedim(-3, 0).reshape(-1))
        per = math.prod(lead) * rows
        recv = torch.empty(per * du, dtype=t.dtype, device=self.wire)
        dist.all_to_all_single(recv, send, [per * c for c in split],
                               [per * mine] * self.size)
        parts = torch.split(recv.to(t.device), [per * c for c in split])
        return torch.cat([p.reshape(lead + (rows, c))
                          for p, c in zip(parts, split)], -1)

    def halo(self, v_loc: torch.Tensor, rows: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top, bottom) strips of `rows` rows for this rank's row block
        `v_loc`: top is the last rows of rank d-1, bottom the first rows of
        rank d+1, zeros past the two ends (the JAX package's two ppermutes,
        bs_sharded.py:186-194)."""
        top = torch.zeros((rows,) + tuple(v_loc.shape[1:]), dtype=v_loc.dtype,
                          device=self.wire)
        bottom = torch.zeros_like(top)
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, self._wire(v_loc[:rows]),
                               self.rank - 1),
                    dist.P2POp(dist.irecv, top, self.rank - 1)]
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, self._wire(v_loc[-rows:]),
                               self.rank + 1),
                    dist.P2POp(dist.irecv, bottom, self.rank + 1)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return top.to(v_loc.device), bottom.to(v_loc.device)


def make_mesh(n: int, device) -> DwMesh:
    """The 1-D dw group of the n running ranks (all of the process group),
    computing on `device`."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.init_multihost first")
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh: {n} ranks asked for, "
                         f"{dist.get_world_size()} running")
    mesh = DwMesh(n, device)
    log.info("dw mesh: %d ranks, transport %s%s", n, mesh.transport,
             "" if mesh.wire == mesh.device else
             f" (staged through {mesh.wire.type} memory)")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m
