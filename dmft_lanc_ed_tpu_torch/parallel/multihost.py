"""The process group: multi-rank and inter-site parallelism (port of
``dmft_lanc_ed_tpu/parallel/multihost.py``).

The reference distributes lattice sites over MPI ranks round-robin
(``ed_solve_lattice_mpi``, ED_MAIN.f90:603-672), zero-fills the sites a rank
did not solve and merges with MPI_AllReduce(SUM) (also the fit merge,
ED_FIT_CHI2.f90:215-240). The JAX package rides its multi-controller
runtime; the port rides ``torch.distributed``:

- :func:`init_multihost` joins the process group in place of
  ``jax.distributed.initialize``. The transport follows the launch: NCCL
  with one card per rank; gloo on the CPU, and where ranks share one card
  (NCCL refuses two ranks on one device), the shards' compute staying on
  the card. Under ``torchrun`` it takes everything from the environment;
  a local launch passes ``tcp://localhost:<port>``, the world size and the
  rank;
- :func:`rank_device` is the rank's device: ``cuda:{local_rank % cards}``;
- :func:`my_sites` / :func:`allreduce_sites` are the round robin and the
  zero-fill + sum merge;
- :func:`run_local_ranks` spawns n ranks on this machine, runs a function
  on each and returns what each returned; a rank's exception is raised in
  the caller, and a rank still running at the deadline is killed.

Intra-site (dw) sharding composes underneath, through :mod:`.production`.
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import socket
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("dmft_lanc_ed_tpu_torch")


def rank_device(device="cuda", local_rank: Optional[int] = None
                ) -> torch.device:
    """This rank's device: the CPU when asked for, else the card
    ``cuda:{local_rank % device_count}`` (``local_rank`` from the
    environment's LOCAL_RANK, else the global rank). Raises without one."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is "
                           "available to this rank; pass device=\"cpu\" to "
                           "run on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_info()[0]))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None, device="cuda",
                   timeout_s: float = 1800.0) -> int:
    """Join the process group; returns this rank.

    ``init_method=None`` reads everything from the environment (``env://``,
    as ``torchrun`` sets it). ``device`` is where the ranks compute: NCCL
    when it is a card and this machine has a card for every local rank,
    else gloo."""
    dev = torch.device(device)
    env = init_method is None
    world = int(os.environ["WORLD_SIZE"]) if env else int(world_size)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= local else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank_device(dev, int(os.environ.get(
            "LOCAL_RANK", rank if rank is not None else 0))))
    dist.init_process_group(
        backend, init_method="env://" if env else init_method,
        world_size=-1 if env else world,
        rank=-1 if env else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("multihost: rank %d/%d, transport %s, device %s",
             dist.get_rank(), dist.get_world_size(), backend, dev.type)
    return dist.get_rank()


def process_info() -> tuple:
    """(rank, world size) — (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_sites(nlat: int) -> range:
    """Round-robin site assignment of this rank (ED_MAIN.f90:603)."""
    pid, nproc = process_info()
    return range(pid, nlat, nproc)


def allreduce_sites(local: Dict[int, np.ndarray], nlat: int,
                    template_shape: Sequence[int],
                    dtype=np.float64) -> np.ndarray:
    """Merge per-site arrays across ranks (zero-fill + sum all-reduce).

    ``local`` maps site index -> this rank's result (shape
    ``template_shape``). Returns the dense [nlat, *template_shape] array,
    identical on every rank; every site is nonzero on one rank only, so the
    sum is exact. One rank: plain assembly."""
    full = np.zeros((nlat,) + tuple(template_shape), dtype)
    for i, arr in local.items():
        full[i] = np.asarray(arr, dtype)
    _, nproc = process_info()
    if nproc == 1:
        return full
    from .mesh import make_mesh
    return make_mesh(nproc, "cpu").allreduce(torch.from_numpy(full)).numpy()


def free_port() -> int:
    """A free TCP port on localhost (bind to port 0 and read it back)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, init_method: str, device,
               args: tuple, out_dir: str) -> None:
    init_multihost(init_method, n, rank, device)
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def run_local_ranks(fn: Callable, n: int, args: tuple = (), device="cuda",
                    timeout: float = 600.0) -> List:
    """Run ``fn(rank, *args)`` on n spawned local ranks in one process
    group (``tcp://localhost`` on a free port, transport by `device` as in
    :func:`init_multihost`); returns the ranks' results in rank order.

    ``fn`` must be importable (a module-level function). A rank that
    raises makes this raise (the others are terminated); ranks still
    running after `timeout` seconds are killed and TimeoutError raised."""
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, init_method, device, tuple(args),
                              out_dir),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{n} local ranks still running after "
                                   f"{timeout:.0f} s")
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
