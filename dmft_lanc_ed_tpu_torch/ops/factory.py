"""Sector-operator factory (port of ``dmft_lanc_ed_tpu/ops/factory.py``).

``make_sector_op`` returns an (op, apply_fn) pair chosen by
cfg.ed_backend / cfg.ed_sparse_h / cfg.ed_precision and the device:

- "pallas" : the band-sparse operator (ops/blocksparse.py) whose Krylov
             chains run the hand-written CUDA kernels (ops/bs_chain.py);
             logged fallback to "dense" where it does not apply
- "dense"  : dense tensor-product factors, torch matmuls
- "ell"    : the stored ELL factor tables, row gathers (ops/matvec.py)
- "direct" : matrix-free, the connectivity recomputed from the state masks
             each apply (ops/direct.py); logged fallback to "ell" where
             the masks exceed its 32 bits
- "auto"   : resolves by device, as the JAX package resolves by platform:
             "pallas" on CUDA, "ell" on the CPU; ed_sparse_h=F dials
             "direct" (ED_INPUT_VARS.f90:151)
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..bath import Bath
from ..config import EDConfig
from ..hamiltonian import build_sector_hamiltonian
from ..sectors import Sector
from .dense import (DenseSectorOp, build_dense_op, matvec_dense_flat,
                    matvec_dense_mixed_flat)
from .direct import MASK_BITS, build_direct_op, matvec_direct_flat
from .matvec import build_ell_op, matvec_flat

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

_DENSE_APPLY = {"f64": matvec_dense_flat,
                "mixed": matvec_dense_mixed_flat}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The entry points take the card
    by default; without one this raises instead of running on the CPU,
    which a caller asks for with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is "
                           "available; pass device=\"cpu\" to run on the "
                           "CPU")
    return dev


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def resolve_backend(cfg: EDConfig, device) -> str:
    """ed_backend="auto": "pallas" on CUDA, "ell" on the CPU (the JAX
    package's per-platform choice); ed_sparse_h=F dials "direct"."""
    backend = cfg.ed_backend
    if backend == "auto":
        if not cfg.ed_sparse_h:
            return "direct"
        return "pallas" if _on_cuda(device) else "ell"
    return backend


def resolve_precision(cfg: EDConfig, device) -> str:
    """ed_precision="auto": mixed (true-f32 products + f64 polish) on CUDA,
    exact f64 on the CPU. "fast" (the TPU's 3-pass bf16) runs as mixed."""
    prec = cfg.ed_precision
    if prec == "auto":
        return "mixed" if _on_cuda(device) else "f64"
    return "mixed" if prec == "fast" else prec


def apply_is_exact(op_apply: Callable) -> bool:
    """Whether the production apply is f64-exact (no polish needed)."""
    from .blocksparse import matvec_bs_flat
    return op_apply not in (matvec_dense_mixed_flat, matvec_bs_flat)


def exact_apply(op) -> Optional[Callable]:
    """f64-exact flat apply for the given op (the polish path)."""
    if isinstance(op, DenseSectorOp):
        return matvec_dense_flat
    from .blocksparse import BlockSparseSectorOp, matvec_bs_exact_flat
    if isinstance(op, BlockSparseSectorOp):
        return matvec_bs_exact_flat
    return None


def direct_supported(cfg: EDConfig) -> bool:
    """Whether the direct backend covers the sector masks: both QN schemes
    are (orbital-resolved sectors carry composite masks over all levels,
    sectors.py), up to the 32 levels of its int64 SWAR popcount."""
    return cfg.ns <= MASK_BITS


def make_sector_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray, bath: Bath,
                   device, h_basis: Optional[np.ndarray] = None
                   ) -> Tuple[object, Callable]:
    backend = resolve_backend(cfg, device)
    if backend == "pallas":
        from .blocksparse import (blocksparse_applicable, build_blocksparse_op,
                                  matvec_bs_flat)
        h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis)
        if blocksparse_applicable(h):
            return build_blocksparse_op(h, device), matvec_bs_flat
        log.warning("ed_backend=pallas: sector %s not supported by the "
                    "band-sparse backend (phonons/Jx-Jp/device budget); "
                    "falling back to dense", (sec.nup, sec.ndw))
        backend = "dense"
    if backend == "dense":
        op = build_dense_op(cfg, sec, hloc, bath, device, h_basis=h_basis)
        return op, _DENSE_APPLY[resolve_precision(cfg, device)]
    if backend == "direct":
        if direct_supported(cfg):
            log.info("sector %s: direct (matrix-free) backend",
                     (sec.nup, sec.ndw))
            return (build_direct_op(cfg, sec, hloc, bath, device,
                                    h_basis=h_basis), matvec_direct_flat)
        log.warning("ed_backend=direct: %d levels exceed the direct "
                    "backend's %d-bit masks; falling back to stored ELL",
                    cfg.ns, MASK_BITS)
        backend = "ell"
    if backend == "ell":
        return (build_ell_op(cfg, sec, hloc, bath, device, h_basis=h_basis),
                matvec_flat)
    raise ValueError(f"unknown ed_backend {cfg.ed_backend!r}")
