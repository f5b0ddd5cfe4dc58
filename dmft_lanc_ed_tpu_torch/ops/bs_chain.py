"""Band-sparse Krylov chains: the B2/B3/B4 kernels, their plain versions,
and the glue of the two-stage ground state and the GF chains (port of
``dmft_lanc_ed_tpu/ops/bs_chain.py``).

Three kernels, hand-written CUDA in ``csrc/bs_chain.cu`` (see the note at
its top for the design and what bounds it), sharing one panel apply of
H_p u on the RCM-permuted padded grid:

- B2 :func:`tridiag_call` — K plain Lanczos steps (no reorthogonalization,
  lazy normalization) emitting (alpha, beta); replaces
  ``bs_chain.py:_tridiag_kernel``.
- B3 :func:`cheb_call` — K scaled-Chebyshev filter steps T_K((H - c)/e) v,
  normalized every step; replaces ``bs_chain.py:_cheb_kernel``.
- B4 :func:`gf_tridiag_call` — the B2 step over a batch of excitation
  chains (the chain index is a grid dimension, every chain has its own
  scalar state, all chains advance in one launch per pass); replaces
  ``bs_chain.py:_gf_tridiag_kernel`` and the fixed zero-filled
  ``GF_CHAIN_BATCH`` chunks of ``_gf_batch_call``.

The kernels run FP32 FMA products over the f32 slabs with f32 accumulation
and f64 cross-block sums, so B2/B3 meet B4's ~1e-7 contract, stricter than
the split-bf16 ~1.5e-5 the TPU's B2/B3 carried.

Beside each kernel sits its plain PyTorch version
(:func:`tridiag_chain_plain`, :func:`cheb_chain_plain`,
:func:`gf_tridiag_batch_plain`): the same recurrence in f32, through the
padded f32 factors ``hdw_p32`` / ``hup_p32`` and the diagonal
``diag_a @ diag_b`` rather than the slabs, so a window-clamping fault of a
kernel shows as a mismatch. A wrapper runs the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in :data:`launch_counts` (one per
chain launch — a chain is K steps of a few CUDA kernels on one stream).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .blocksparse import (BsPaddedOp, BlockSparseSectorOp, _check_cuda_inputs,
                          _geometry, _hv_plain, _pop, from_padded, to_padded)

# Chebyshev filter degrees are rounded up to these, as the reference's
# kernel does (its chain length is a static kernel parameter), so a given
# m_cheb filters with the same polynomial in both packages.
_K_BUCKETS = (16, 32, 64, 96, 128, 192, 256)

# Device-memory gate of one chain (the JAX package gated on the TPU's
# ~16 MB VMEM). Here the two f32 planes, the f32 slabs and the diagonal
# factors live in device memory; a chain fits when they take at most this.
CHAIN_DEVICE_BUDGET = 2 << 30

# kernel launches per wrapper since the last reset (see module docstring)
launch_counts = {"tridiag": 0, "cheb": 0, "gf_tridiag": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if k <= b:
            return b
    raise ValueError(f"chain length {k} exceeds the largest chain bucket "
                     f"{_K_BUCKETS[-1]}")


def _chain_bytes(pop: BsPaddedOp, nchains: int = 1) -> int:
    ddp, dup = pop.padded_shape
    return (nchains * 2 * 4 * ddp * dup
            + 4 * (pop.dw_f32.numel() + pop.up_f32.numel())
            + 4 * (pop.diag_a.numel() + pop.diag_b.numel()))


def chain_applicable(op) -> bool:
    """True when one chain's two f32 vector planes, the f32 slabs and the
    diagonal factors fit :data:`CHAIN_DEVICE_BUDGET` of device memory."""
    return _chain_bytes(_pop(op)) <= CHAIN_DEVICE_BUDGET


def gf_chain_applicable(op, m: int) -> bool:
    """Gate of the GF chain path: the per-chain footprint of
    :func:`chain_applicable`, and a chain length within the reference's
    largest bucket (so both packages route the same sectors)."""
    return m <= _K_BUCKETS[-1] and chain_applicable(op)


# --------------------------------------------------------------------------
# plain versions (PyTorch, same recurrences, dense padded f32 factors)
# --------------------------------------------------------------------------
def _bcast(s: torch.Tensor) -> torch.Tensor:
    return s.float()[:, None, None]


def tridiag_chain_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2/B4: kk Lanczos steps of nb chains from the
    normalized padded f32 starts v32p [nb, ddp, dup]; returns raw
    (alphas, betas) [nb, kk] f64 (betas[:, k] couples step k -> k+1)."""
    pop = _pop(pop)
    planes = [v32p.float().clone(),
              torch.zeros_like(v32p, dtype=torch.float32)]
    nb = v32p.shape[0]
    f64 = dict(dtype=torch.float64, device=v32p.device)
    s_cur = torch.ones(nb, **f64)
    coup = torch.zeros(nb, **f64)
    alphas, betas = [], []
    for k in range(kk):
        u, q = planes[k % 2], planes[1 - k % 2]
        y = _bcast(s_cur) * _hv_plain(pop, u) - _bcast(coup) * q
        alpha = s_cur * (u.double() * y.double()).sum((1, 2))
        w = y - _bcast(alpha * s_cur) * u
        beta = torch.sqrt((w.double() ** 2).sum((1, 2)))
        planes[1 - k % 2] = w
        coup = beta * s_cur
        s_cur = torch.where(beta > 1e-30, 1.0 / beta, 0.0)
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas, 1), torch.stack(betas, 1)


def cheb_chain_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int, c: float,
                     inv_e: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3: kk scaled-Chebyshev steps from v32p [ddp, dup];
    returns (the last unnormalized vector f32, its norm f64)."""
    pop = _pop(pop)
    planes = [v32p.float().clone()[None],
              torch.zeros((1,) + tuple(v32p.shape), dtype=torch.float32,
                          device=v32p.device)]
    f64 = dict(dtype=torch.float64, device=v32p.device)
    s_cur = torch.ones(1, **f64)
    s_prv = torch.zeros(1, **f64)
    nrm = torch.zeros(1, **f64)
    for k in range(kk):
        u, q = planes[k % 2], planes[1 - k % 2]
        fac = (inv_e if k == 0 else 2.0 * inv_e) * s_cur
        r = (_bcast(fac) * (_hv_plain(pop, u) - c * u)
             - _bcast(s_cur * s_prv) * q)
        nrm = torch.sqrt((r.double() ** 2).sum((1, 2)))
        planes[1 - k % 2] = r
        s_prv = s_cur
        s_cur = torch.where(nrm > 1e-30, 1.0 / nrm, 0.0)
    return planes[kk % 2][0], nrm[0]


def gf_tridiag_batch_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4 (the B2 recurrence over a batch)."""
    return tridiag_chain_plain(pop, v32p, kk)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def _run_tridiag(pop: BsPaddedOp, v32p: torch.Tensor, kk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tridiag chain kernel on nb = v32p.shape[0] chains."""
    from .. import _kernels
    lib = _kernels.lib()
    _check_cuda_inputs(pop, v32p)
    nb = v32p.shape[0]
    ddp, dup = pop.padded_shape
    dev = v32p.device
    planes = torch.zeros((nb, 2, ddp, dup), dtype=torch.float32, device=dev)
    planes[:, 0] = v32p
    state = torch.zeros((nb, 4), dtype=torch.float64, device=dev)
    state[:, 0] = 1.0
    partials = torch.empty((nb, lib.bs_chain_nblk(ddp, dup)),
                           dtype=torch.float64, device=dev)
    alphas = torch.empty((nb, kk), dtype=torch.float64, device=dev)
    betas = torch.empty((nb, kk), dtype=torch.float64, device=dev)
    err = lib.bs_tridiag_chain(
        pop.dw_f32.data_ptr(), pop.up_f32.data_ptr(), pop.diag_a.data_ptr(),
        pop.diag_b.data_ptr(), planes.data_ptr(), state.data_ptr(),
        partials.data_ptr(), alphas.data_ptr(), betas.data_ptr(), nb,
        *_geometry(pop), kk, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_tridiag_chain")
    return alphas, betas


def tridiag_call(op, v32p: torch.Tensor, kk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: kk Lanczos steps of one chain from v32p [ddp, dup] -> raw
    (alphas, betas) [kk] f64 on the vector's device."""
    pop = _pop(op)
    if v32p.is_cuda:
        al, be = _run_tridiag(pop, v32p[None].contiguous(), kk)
        launch_counts["tridiag"] += 1
    elif v32p.device.type == "cpu":
        al, be = tridiag_chain_plain(pop, v32p[None], kk)
    else:
        raise ValueError(f"tridiag_call: unsupported device {v32p.device}")
    return al[0], be[0]


def gf_tridiag_call(op, v32p: torch.Tensor, kk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: kk Lanczos steps of the nb chains v32p [nb, ddp, dup] in one
    kernel chain -> raw (alphas, betas) [nb, kk] f64."""
    pop = _pop(op)
    if v32p.is_cuda:
        al, be = _run_tridiag(pop, v32p.contiguous(), kk)
        launch_counts["gf_tridiag"] += 1
        return al, be
    if v32p.device.type == "cpu":
        return gf_tridiag_batch_plain(pop, v32p, kk)
    raise ValueError(f"gf_tridiag_call: unsupported device {v32p.device}")


def cheb_call(op, v32p: torch.Tensor, kk: int, c: float, inv_e: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: kk scaled-Chebyshev steps of v32p [ddp, dup] -> (the last
    unnormalized vector f32 [ddp, dup], its norm f64 0-d tensor)."""
    pop = _pop(op)
    if v32p.device.type == "cpu":
        return cheb_chain_plain(pop, v32p, kk, c, inv_e)
    if not v32p.is_cuda:
        raise ValueError(f"cheb_call: unsupported device {v32p.device}")
    from .. import _kernels
    lib = _kernels.lib()
    _check_cuda_inputs(pop, v32p)
    ddp, dup = pop.padded_shape
    dev = v32p.device
    planes = torch.zeros((2, ddp, dup), dtype=torch.float32, device=dev)
    planes[0] = v32p
    state = torch.zeros(4, dtype=torch.float64, device=dev)
    state[0] = 1.0
    partials = torch.empty(lib.bs_chain_nblk(ddp, dup), dtype=torch.float64,
                           device=dev)
    norm = torch.empty(1, dtype=torch.float64, device=dev)
    err = lib.bs_cheb_chain(
        pop.dw_f32.data_ptr(), pop.up_f32.data_ptr(), pop.diag_a.data_ptr(),
        pop.diag_b.data_ptr(), planes.data_ptr(), state.data_ptr(),
        partials.data_ptr(), norm.data_ptr(), float(c), float(inv_e),
        *_geometry(pop), kk, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_cheb_chain")
    launch_counts["cheb"] += 1
    return planes[kk % 2], norm[0]


# --------------------------------------------------------------------------
# glue
# --------------------------------------------------------------------------
def tridiag_chain(op, v32p: torch.Tensor, m: int
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """m-step Lanczos tridiagonalization from a normalized padded v0.

    Returns (alphas[m], betas[m], beta_out) host f64 — (alphas, betas) in
    the lanczos_tridiag layout (betas[0]=0, betas[j] couples steps j-1 <-> j)
    and beta_out the coupling out of the last vector (the Ritz residual
    scale). One chain launch; the host reads the results once."""
    al, be = tridiag_call(op, v32p, m)
    al = al.cpu().numpy()
    be_raw = be.cpu().numpy()
    betas = np.concatenate([[0.0], be_raw[:m - 1]])
    return al, betas, float(be_raw[m - 1])


def cheb_chain(op, v32p: torch.Tensor, m: int, c: float, e: float
               ) -> torch.Tensor:
    """Scaled Chebyshev filter T_K((H - c)/e) v of degree K = the bucket
    of m, normalized output (no host sync). Components inside [c-e, c+e]
    are damped to <= 1; those below c-e grow like
    cosh(K acosh((c-lam)/e)), so the ground state dominates."""
    v, nrm = cheb_call(op, v32p, _bucket_k(m), c, 1.0 / e)
    return v / torch.clamp(nrm, min=1e-30).float()


# Ritz ghost-cluster tolerance, as a fraction of the spectral span. A chain
# without reorthogonalization re-creates converged eigenvalues as
# near-duplicate "ghosts" just above theta_0, and a copy still converging
# sits a little higher; everything within this window of theta_0 is one
# target cluster (the filter cut must sit outside it and the seed overlap
# sums over it). The JAX package tuned 3e-5 to its split-bf16 noise. With
# the port's f32 chain at nbath = 11 (default bath, all 109 band-sparse
# sectors, on an H100), 3e-5 let a converging copy of theta_0 at
# 2.3e-4 x span pass for the gap in sectors (4,5) and (7,6): the cut fell
# next to theta_0, the filter barely amplified, and the seed never reached
# eta_target in 3 rounds. 3e-4 covers that with margin and seeds all 109
# (ROADMAP C); merging a real state that close only widens the filtered
# cluster, which the top-off / polish resolve.
_GHOST_TOL = 3e-4


def _ritz_bounds(op, v0, m_tri):
    """One tridiag chain -> (theta ascending, b_safe, cluster overlap
    |<v_start, span{ritz in theta_0 cluster}>|, cluster_tol)."""
    alphas, betas, beta_out = tridiag_chain(op, v0, m_tri)
    m_eff = m_tri
    for j in range(1, m_tri):
        if betas[j] <= 1e-20:          # invariant subspace exhausted
            m_eff = j
            beta_out = 0.0
            break
    t = np.diag(alphas[:m_eff]) + np.diag(betas[1:m_eff], 1) \
        + np.diag(betas[1:m_eff], -1)
    theta, s = np.linalg.eigh(t)
    span = max(float(theta[-1] - theta[0]), 1e-12)
    # the top Ritz value underestimates lambda_max; pad by its residual so
    # the filter interval truly covers the spectrum
    resid_top = abs(beta_out * float(s[m_eff - 1, -1]))
    b_safe = float(theta[-1]) + 4.0 * resid_top + 1e-3 * span
    cluster_tol = _GHOST_TOL * span
    cluster = theta <= float(theta[0]) + cluster_tol
    s00 = float(np.sqrt(np.sum(s[0, cluster] ** 2)))
    return theta, b_safe, s00, cluster_tol


def ground_state_seed(op: BlockSparseSectorOp, m_tri: int = 96,
                      m_cheb: int = 128, seed: int = 17,
                      v0: Optional[torch.Tensor] = None,
                      max_rounds: int = 3, eta_target: float = 3e-3,
                      return_padded: bool = False):
    """Ground-state seed via tridiag chains (B2) + Chebyshev filters (B3).

    Iterates (tridiag chain -> Ritz bounds -> filter) until the current
    vector's overlap with the lowest Ritz direction reaches
    1 - eta_target^2 (or ``max_rounds``). The damping cut sits strictly
    inside the (theta_0, theta_1) Ritz gap and the upper bound b comes from
    the first round (a random start sees the top of the spectrum).

    Returns (theta_min estimate, normalized seed, eta): the seed natural
    [dim_dw, dim_up] f64 by default, or permuted padded f32 when
    ``return_padded``. The start vector is numpy ``default_rng(seed)``, as
    in the reference, so both packages start from the same vector. The pad
    subspace starts exactly zero and stays exactly zero.
    """
    if v0 is None:
        rng = np.random.default_rng(seed)
        v0n = rng.standard_normal((op.dim_dw, op.dim_up))
        v0 = to_padded(op, v0n / np.linalg.norm(v0n))
    v = v0
    b_global = None
    theta = None
    eta = 1.0
    for _ in range(max_rounds):
        theta, b_safe, s00, cluster_tol = _ritz_bounds(op, v, m_tri)
        eta = float(np.sqrt(max(1.0 - s00 * s00, 0.0)))
        b_global = b_safe if b_global is None else max(b_global, b_safe)
        if 1.0 - s00 * s00 <= eta_target * eta_target:
            break
        span = max(b_global - float(theta[0]), 1e-12)
        distinct = theta[theta > theta[0] + cluster_tol]
        gap = float(distinct[0] - theta[0]) if distinct.size \
            else 0.02 * span
        cut = float(theta[0]) + 0.35 * gap
        c = 0.5 * (b_global + cut)
        e = max(0.5 * (b_global - cut), 1e-12 * span)
        v = cheb_chain(op, v, m_cheb, c, e)
    if return_padded:
        return float(theta[0]), v, eta
    vnat = from_padded(op, v, torch.float64)
    return float(theta[0]), vnat / torch.linalg.vector_norm(vnat), eta


def gf_tridiag_batch(op: BlockSparseSectorOp, v_batch, m: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched GF tridiagonalization through the B4 chain kernel.

    v_batch: [B, dim] f64 flat natural-layout start vectors (normalized),
    numpy or tensor; returns (alphas [B, m], betas [B, m]) host f64 in the
    lanczos_tridiag layout (betas[:, 0] = 0) — drop-in for
    ``lanczos_tridiag_batched`` where :func:`gf_chain_applicable` holds.
    All chains of a chunk advance together; chunks only bound the planes'
    device memory (:data:`CHAIN_DEVICE_BUDGET`)."""
    pop = op.pop
    v_batch = torch.as_tensor(v_batch, device=op.device)
    b_total = v_batch.shape[0]
    per_chain = _chain_bytes(pop, 2) - _chain_bytes(pop, 1)
    chunk = max(1, (CHAIN_DEVICE_BUDGET - _chain_bytes(pop, 0)) // per_chain)
    al_all, be_all = [], []
    for i0 in range(0, b_total, chunk):
        vs = v_batch[i0:i0 + chunk].reshape(-1, op.dim_dw, op.dim_up)
        al, be = gf_tridiag_call(op, to_padded(op, vs), m)
        al_all.append(al.cpu().numpy())
        be_all.append(be.cpu().numpy())
    al = np.concatenate(al_all)
    be_raw = np.concatenate(be_all)
    betas = np.concatenate([np.zeros((b_total, 1)), be_raw[:, :m - 1]],
                           axis=1)
    return al, betas
