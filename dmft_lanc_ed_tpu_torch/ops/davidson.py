"""Davidson eigensolver, ``lanc_method="dvdson"`` (port of
``dmft_lanc_ed_tpu/ops/davidson.py``).

The reference's DVDSON path (`sp_dvdson_eigh`, ED_DIAG.f90:189-204): the
expansion vectors are diagonally preconditioned residuals t = r /
(theta - D) instead of the Lanczos recurrence, which pays where the
diagonal dominates (large-U sectors). The structure follows
:func:`.lanczos.lanczos_ground_state`: a host-driven outer loop, the
projected matrix diagonalized by host LAPACK, a thick restart with the
lowest Ritz vectors, locking in spectral order, and the optional f64
Rayleigh-Ritz polish (:func:`.lanczos.refine_eigenpairs`) after a
mixed-precision apply. Vectors live on the op's device; random starts
come from numpy ``default_rng(seed)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.observability import kernel_stats


def _dav_insert(op, basis, hbasis, t_mat, k: int, v_new, op_apply: Callable):
    """CGS2-orthonormalize v_new against basis rows < k (rows >= k are
    zero), insert it at row k, apply H and record the projected column.
    Returns the norm of the orthogonalized direction (0: v_new was
    linearly dependent, and nothing was inserted)."""
    v = v_new
    for _ in range(2):
        v = v - (basis @ v) @ basis
    beta = float(torch.linalg.vector_norm(v))
    if not beta > 1e-14:
        return 0.0
    v = v / beta
    basis[k] = v
    w = op_apply(op, v)
    hbasis[k] = w
    col = basis @ w                             # rows > k are zero
    t_mat[:, k] = col
    t_mat[k, :] = col
    return beta


def _dav_residual(basis, hbasis, s, theta: float, diag, eta: float):
    """The Ritz vector's residual r = s.HB - theta s.B and the Davidson
    expansion t = r / (theta - D), |theta - D| floored at eta so the
    preconditioner stays bounded near diagonal entries: (t, |r|)."""
    r = s @ hbasis - theta * (s @ basis)
    denom = theta - diag
    denom = torch.where(denom.abs() < eta,
                        torch.where(denom < 0, -eta, eta), denom)
    return r / denom, float(torch.linalg.vector_norm(r))


def op_diag_flat(op) -> torch.Tensor:
    """Flat diagonal of a sector operator (the DVDSON preconditioner) for
    every backend's op: ELL and dense (their separate phonon diagonal),
    direct (the factored diagonal and the phonon ladder w0 n), band-sparse
    (its natural-order diagonal)."""
    from .direct import DirectSectorOp, direct_diag
    if isinstance(op, DirectSectorOp):          # the factored diagonal
        d = direct_diag(op)
    else:
        d = op.diag
    if d.ndim == 3:                              # already [P, dd, du]
        return d.reshape(-1)
    ph = getattr(op, "ph_diag", None)
    if ph is not None:                           # ELL / dense phonons
        return (ph[:, None, None] + d[None]).reshape(-1)
    ph_n = getattr(op, "ph_n", None)
    if ph_n is not None:                         # direct phonons
        return (op.ph_w0 * ph_n[:, None, None] + d[None]).reshape(-1)
    return d.reshape(-1)


def davidson_ground_state(
    op,
    op_apply: Callable,
    dim: int,
    neigen: int,
    diag,
    ncv: Optional[int] = None,
    tol: float = 1e-14,
    max_iter: int = 3000,
    seed: int = 17,
    dtype=torch.float64,
    polish_apply: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs by preconditioned Davidson.

    The contract of :func:`.lanczos.lanczos_ground_state` on flat vectors,
    plus ``diag``: the operator's flat diagonal (the preconditioner,
    sp_dvdson's ADIAG argument). Returns (energies [k], vectors [k, dim]
    host f64) ascending."""
    dev = op.device
    neigen = min(neigen, dim)
    m = min(ncv or max(2 * neigen + 16, 24), dim)
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 2, 1))
    rng = np.random.default_rng(seed)
    diag = torch.as_tensor(diag, device=dev).to(dtype).reshape(dim)
    eta = 1e-3 * (float(diag.abs().max()) + 1.0)

    def random_vec():
        v = torch.as_tensor(rng.standard_normal(dim), dtype=dtype,
                            device=dev)
        return v / torch.linalg.vector_norm(v)

    v_next = random_vec()
    basis = torch.zeros((m, dim), dtype=dtype, device=dev)
    hbasis = torch.zeros_like(basis)
    t_mat = torch.zeros((m, m), dtype=dtype, device=dev)
    k = n_conv = 0
    for _ in range(max_iter):
        beta = _dav_insert(op, basis, hbasis, t_mat, k, v_next, op_apply)
        kernel_stats.record(1 if beta else 0, getattr(op, "nnz", 0))
        if beta == 0.0:
            v_next = random_vec()      # linearly dependent: a fresh start
            continue
        k += 1
        tm = t_mat[:k, :k].cpu().numpy()
        theta_np, s_np = np.linalg.eigh(0.5 * (tm + tm.T))
        s_pad = np.zeros(m)
        # the converged prefix in spectral order (locking)
        n_conv = 0
        x_low = None
        for j in range(min(k, neigen + 1)):
            s_pad[:k] = s_np[:, j]
            t_pre, rnorm = _dav_residual(
                basis, hbasis, torch.as_tensor(s_pad, dtype=dtype,
                                               device=dev),
                float(theta_np[j]), diag, eta)
            if j == n_conv and rnorm <= tol * max(abs(theta_np[j]), 1.0):
                n_conv += 1
                continue
            x_low = t_pre
            break
        if n_conv >= neigen and k >= neigen:
            s = torch.as_tensor(s_np[:, :neigen], dtype=dtype, device=dev)
            vecs = s.T @ basis[:k]
            vals = theta_np[:neigen]
            if polish_apply is not None:
                from .lanczos import refine_eigenpairs
                vals, vecs = refine_eigenpairs(op, polish_apply, vecs)
            vecs_flat = vecs.double().cpu().numpy()
            order = np.argsort(vals)
            return np.asarray(vals)[order], vecs_flat[order]
        if k >= m:
            # thick restart with the lowest l_keep Ritz pairs
            l = min(l_keep, k - 1)
            s_keep = torch.as_tensor(s_np[:, :l].T, dtype=dtype, device=dev)
            basis[:l] = s_keep @ basis
            hbasis[:l] = s_keep @ hbasis
            basis[l:] = 0.0
            hbasis[l:] = 0.0
            t_mat.zero_()
            t_mat[range(l), range(l)] = torch.as_tensor(
                theta_np[:l], dtype=dtype, device=dev)
            k = l
        v_next = x_low if x_low is not None else random_vec()
    raise RuntimeError(
        f"davidson_ground_state: no convergence after {max_iter} "
        f"iterations ({n_conv}/{neigen} converged, dim={dim})")
