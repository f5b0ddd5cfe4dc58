"""Krylov eigensolvers (port of ``dmft_lanc_ed_tpu/ops/lanczos.py``).

Replaces the reference's P-ARPACK / plain-Lanczos layer (SF_SP_LINALG
`sp_eigh` / `sp_lanc_tridiag`, ED_DIAG.f90:151-204, ED_GF_NORMAL.f90:224-238):

- :func:`lanczos_tridiag` / :func:`lanczos_tridiag_batched` — plain 3-term
  recurrence producing the (alpha, beta) tridiagonal for the GF continued
  fraction, no reorthogonalization. The JAX ``vmap`` over chains is a
  leading batch dimension here: the applies take ``[..., dim]`` vectors.
- :func:`lanczos_ground_state` — thick-restart Lanczos with CGS2 full
  reorthogonalization and an optional f64 Rayleigh-Ritz polish
  (:func:`refine_eigenpairs`).

Operators are ``(op, op_apply)`` pairs with ``op_apply(op, v) -> H v`` on
torch tensors living on the op's device.

Sharded vectors: with ``reduce=`` (a callable that sums a tensor over the
ranks of a dw-row-sharded solve, :meth:`~..parallel.mesh.DwMesh.allreduce`)
every inner product and norm is a local sum followed by ``reduce``, the
port of the JAX package's ``sharding=`` (its partitioner's psums). Every
rank then holds the same bits of every projection, so every rank takes the
same host decisions. Without it the sums are the unsharded ones, in the
unchanged order. The breakdown guards use
``torch.where``, so a thick-restart basis build synchronizes with the host
twice per restart (the projected matrix and the residual norm), never per
step; a GF tridiagonalization once per chain. The small eigenproblems run
on host LAPACK, as in the reference.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.observability import kernel_stats, trace

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

_EPS = 1e-30

# thick-restart basis builds of lanczos_ground_state since the last reset
restart_counts = {"ground_state": 0}
# calls of refine_eigenpairs and their seconds since the last reset (each
# round brings its projection to the host, so the seconds hold the card's
# work)
polish_counts = {"calls": 0, "s": 0.0}


def _norm(w: torch.Tensor, reduce: Optional[Callable], dim=-1,
          keepdim: bool = False) -> torch.Tensor:
    """2-norm over `dim`; over the ranks too when `reduce` is given."""
    if reduce is None:
        return torch.linalg.vector_norm(w, dim=dim, keepdim=keepdim)
    sq = (w * w).sum() if dim is None else (w * w).sum(dim, keepdim=keepdim)
    return torch.sqrt(reduce(sq))


def _step(op, op_apply, v_prev, v, beta, reduce=None):
    """One plain Lanczos step on [..., dim] vectors (batch-aware)."""
    w = op_apply(op, v) - beta[..., None] * v_prev
    alpha = (v * w).sum(-1)
    if reduce is not None:
        alpha = reduce(alpha)
    w = w - alpha[..., None] * v
    beta_new = _norm(w, reduce)
    ok = beta_new > _EPS
    v_new = torch.where(ok[..., None],
                        w / torch.where(ok, beta_new, 1.0)[..., None], 0.0)
    beta_new = torch.where(ok, beta_new, 0.0)
    alive = _norm(v, reduce) > 0.5                      # unit or exactly 0
    alpha = torch.where(alive, alpha, 0.0)
    return v, v_new, beta_new, alpha


def lanczos_tridiag_batched(op, v0_batch: torch.Tensor, m: int,
                            op_apply: Callable,
                            reduce: Optional[Callable] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """m-step tridiagonalization of B chains: v0_batch [B, dim] normalized
    -> (alphas, betas) [B, m] host f64, with betas[:, 0] == 0 and betas[:, i]
    the coupling step i-1 <-> i (the (alanc, blanc) layout of
    ED_GF_NORMAL.f90:633-637). A chain whose invariant subspace is
    exhausted (beta = 0) zeros out and contributes zero-weight poles.
    With ``reduce``, v0_batch holds this rank's rows of each chain."""
    v = v0_batch
    v_prev = torch.zeros_like(v)
    beta = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(m):
        v_prev, v, beta, alpha = _step(op, op_apply, v_prev, v, beta, reduce)
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, -1).double().cpu().numpy()
    b = torch.stack(betas, -1).double().cpu().numpy()
    b = np.concatenate([np.zeros(b.shape[:-1] + (1,)), b[..., :-1]], -1)
    return a, b


def lanczos_tridiag(op, v0: torch.Tensor, m: int, op_apply: Callable
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Single-chain :func:`lanczos_tridiag_batched`: v0 [dim] -> [m], [m]."""
    a, b = lanczos_tridiag_batched(op, v0[None], m, op_apply)
    return a[0], b[0]


def tridiag_eigh(alphas, betas) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of the Lanczos tridiagonal on host LAPACK (the
    reference's `eigh` on (alanc, blanc), ED_GF_NORMAL.f90:637)."""
    a = np.asarray(alphas)
    b = np.asarray(betas)
    t = np.diag(a) + np.diag(b[1:], 1) + np.diag(b[1:], -1)
    return np.linalg.eigh(t)


# --------------------------------------------------------------------------
# ground-state solver: thick-restart Lanczos (Rayleigh-Ritz restarted)
# --------------------------------------------------------------------------
class _BasisResult(NamedTuple):
    v_basis: torch.Tensor   # [b, m, *vshape]
    t_mat: np.ndarray       # [b, m, m] projected matrices (upper triangle)
    beta_last: np.ndarray   # [b] coupling out of the last vector (residual)
    v_next: torch.Tensor    # [b, *vshape] normalized residual (or zeros)


def _build_basis_rr(apply_b: Callable, prefix, theta0, v_start, m: int,
                    l: int, fast_proj: bool = False,
                    reduce: Optional[Callable] = None) -> _BasisResult:
    """Extend l-vector Ritz prefixes to m-vector orthonormal bases, for b
    independent elements at once.

    Thick-restart Lanczos with CGS2 full reorthogonalization (TRLan): the
    prefix rows are Ritz vectors of the previous restart, so the projected
    matrix is diag(theta0) on the prefix block; T[j, i] = <v_j, H v_i> is
    recorded from the first-pass orthogonalization coefficients. The JAX
    package's ``vmap`` over a bucket of sectors is the leading axis b here:
    ``apply_b`` maps [b, *vshape] -> [b, *vshape], and the projections are
    batched matmuls. prefix [b, l, *vshape], theta0 [b, l], v_start
    [b, *vshape].

    ``fast_proj`` runs the CGS2 projections on a true-f32 shadow of the
    basis (vectors and norms stay f64), as ``ops/lanczos.py:143-174`` of
    the JAX package does on accelerators: the orthogonality floor becomes
    ~1e-7, which the mixed-apply tolerance floor and the f64 polish absorb.
    ``reduce`` sums the projections and norms over the ranks.
    """
    dtype = v_start.dtype
    b = v_start.shape[0]
    vshape = tuple(v_start.shape[1:])
    n = int(np.prod(vshape))
    dev = v_start.device
    vb = torch.zeros((b, m, n), dtype=dtype, device=dev)
    t_mat = torch.zeros((b, m, m), dtype=dtype, device=dev)
    if l:
        vb[:, :l] = prefix.reshape(b, l, n)
        t_mat[:, torch.arange(l), torch.arange(l)] = theta0
    use32 = fast_proj and dtype == torch.float64
    vb32 = vb.float() if use32 else None

    def cgs_pass(rows: int, w):
        """One classical GS pass against the first `rows` basis vectors."""
        if rows == 0:
            return None, w
        basis = vb32[:, :rows] if use32 else vb[:, :rows]
        c = torch.bmm(basis, (w.float() if use32 else w)[..., None])[..., 0]
        if reduce is not None:
            c = reduce(c)
        corr = torch.bmm(c[:, None, :], basis)[:, 0]
        return c.to(dtype), w - corr.to(dtype)

    _, v = cgs_pass(l, v_start.reshape(b, n))
    _, v = cgs_pass(l, v)
    v = v / torch.clamp(_norm(v, reduce, dim=1, keepdim=True), min=_EPS)
    beta = torch.zeros(b, dtype=dtype, device=dev)
    for i in range(l, m):
        vb[:, i] = v
        if use32:
            vb32[:, i] = v.float()
        w = apply_b(v.reshape((b,) + vshape)).reshape(b, n).to(dtype)
        c1, w = cgs_pass(i + 1, w)
        t_mat[:, :i + 1, i] = c1
        _, w = cgs_pass(i + 1, w)
        beta = _norm(w, reduce, dim=1)
        ok = beta > 1e-14
        v = torch.where(ok[:, None], w / torch.where(ok, beta, 1.0)[:, None],
                        0.0)
        beta = torch.where(ok, beta, 0.0)
    return _BasisResult(vb.reshape((b, m) + vshape), t_mat.cpu().numpy(),
                        beta.double().cpu().numpy(), v.reshape((b,) + vshape))


def _ritz(t_mat: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host eigendecomposition of the (upper-triangle-valid) projected T."""
    t = np.triu(t_mat[:m, :m])
    t = t + np.triu(t, 1).T
    return np.linalg.eigh(t)


def lanczos_ground_state(
    op,
    op_apply: Callable,
    dim: int,
    neigen: int,
    ncv: Optional[int] = None,
    tol: float = 1e-14,
    max_restarts: int = 400,
    seed: int = 17,
    dtype=torch.float64,
    v0: Optional[torch.Tensor] = None,
    vshape: Optional[Tuple[int, ...]] = None,
    polish_apply: Optional[Callable] = None,
    reduce: Optional[Callable] = None,
    shard: Tuple[int, int] = (0, 1),
    fast_proj: Optional[bool] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest `neigen` eigenpairs of the operator (replaces ARPACK `sp_eigh`).

    Vectors live in their natural shape `vshape` (default flat ``(dim,)``)
    on the op's device. Random starts come from numpy ``default_rng(seed)``.
    With ``polish_apply`` (an f64-exact apply), eigenpairs from a
    mixed-precision run are refined by :func:`refine_eigenpairs`.

    Sharded (``reduce`` given, ``shard = (rank, ranks)``): `vshape` is this
    rank's block of a vector whose row axis, axis -2 of `vshape`, holds
    ``ranks * vshape[-2]`` rows (a phonon sector's block is [DimPh, L,
    DimUp]), `dim` the global dimension; a random (re)start is the same
    global draw on every rank, of which each takes its own rows.

    ``fast_proj`` (default: with ``polish_apply``, in f64 on a card) runs
    the basis projections on a true-f32 shadow.

    Returns (energies [k], vectors [k, prod(vshape)] host f64) ascending,
    k == neigen.
    """
    vshape = tuple(vshape) if vshape is not None else (dim,)
    dev = op.device
    if fast_proj is None:
        fast_proj = polish_apply is not None and dev.type == "cuda"
    fast_proj = fast_proj and dtype == torch.float64
    neigen = min(neigen, dim)
    m = ncv or max(2 * neigen + 16, 32)
    m = min(m, dim)
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
    rng = np.random.default_rng(seed)

    rank, ranks = shard

    def random_vec():
        if ranks == 1:
            return torch.as_tensor(rng.standard_normal(vshape), dtype=dtype,
                                   device=dev)
        rows = vshape[-2]
        v = rng.standard_normal(vshape[:-2] + (ranks * rows, vshape[-1]))
        return torch.as_tensor(v[..., rank * rows:(rank + 1) * rows, :],
                               dtype=dtype, device=dev)

    v0 = random_vec() if v0 is None else \
        torch.as_tensor(v0, device=dev).to(dtype).reshape(vshape)
    v0 = v0 / _norm(v0, reduce, dim=None)

    def apply_b(v):
        return op_apply(op, v[0])[None]

    prefix = torch.zeros((0,) + vshape, dtype=dtype, device=dev)
    theta0 = torch.zeros((0,), dtype=dtype, device=dev)
    l = 0
    stall = 0
    n_conv_prev = 0
    for _ in range(max_restarts):
        res = _build_basis_rr(apply_b, prefix[None], theta0[None], v0[None],
                              m, l, fast_proj=fast_proj, reduce=reduce)
        restart_counts["ground_state"] += 1
        kernel_stats.record(m - l, getattr(op, "nnz", 0))
        basis, beta_last = res.v_basis[0], float(res.beta_last[0])
        theta_np, s_np = _ritz(res.t_mat[0], m)
        resid = np.abs(beta_last * s_np[m - 1, :])
        n_conv = 0
        while (n_conv < m and
               resid[n_conv] <= tol * max(abs(theta_np[n_conv]), 1.0)):
            n_conv += 1
        if n_conv >= neigen:
            s = torch.as_tensor(s_np[:, :neigen], dtype=dtype, device=dev)
            vecs = torch.tensordot(s.T, basis, dims=1)  # [k, *vshape]
            vals = theta_np[:neigen]
            if polish_apply is not None:
                vals, vecs = refine_eigenpairs(op, polish_apply, vecs,
                                               reduce=reduce)
            vecs_flat = vecs.reshape(neigen, -1).double().cpu().numpy()
            order = np.argsort(vals)
            return np.asarray(vals)[order], vecs_flat[order]

        # thick restart: keep the lowest l_keep Ritz pairs + the residual
        l = min(l_keep, m - 2)
        s = torch.as_tensor(s_np[:, :l], dtype=dtype, device=dev)
        prefix = torch.tensordot(s.T, basis, dims=1)
        theta0 = torch.as_tensor(theta_np[:l], dtype=dtype, device=dev)
        if beta_last > 0.0:
            v0 = res.v_next[0]
        else:
            v0 = random_vec()      # invariant subspace exhausted
        stall = 0 if n_conv > n_conv_prev else stall + 1
        n_conv_prev = n_conv
        m_cap = min(dim, max(4 * (ncv or 32), 256))
        if stall >= 20 and m < m_cap:
            m = min(m_cap, 2 * m)
            l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
            stall = 0
    raise RuntimeError(
        f"lanczos_ground_state: no convergence after {max_restarts} restarts "
        f"({n_conv_prev}/{neigen} converged, dim={dim})")


# --------------------------------------------------------------------------
# f64 Rayleigh-Ritz polish
# --------------------------------------------------------------------------
_DROP_PIN = 1.0e12     # Ritz value reported for a missing direction
_POLISH_RTOL = 1e-9    # polish target: |H y - theta y| / max(1, |theta|)
_POLISH_ROWS = 64      # cap on one round's block Krylov basis (rows)


def refine_eigenpairs(op, op_apply: Callable, vecs: torch.Tensor,
                      steps: int = 2, max_rounds: int = 12,
                      reduce: Optional[Callable] = None,
                      hold: Optional[float] = None
                      ) -> Tuple[np.ndarray, torch.Tensor]:
    """f64 Rayleigh-Ritz polish of approximate eigenpairs.

    Builds the block Krylov space [V, HV, ..., H^depth V] with the exact
    apply, orthonormalizes it by CGS with reorthogonalization, and solves
    the small projected eigenproblem on the host. Rounds repeat until
    every pair's residual |H y - theta y| (read off the projection, no
    extra apply) is at most ``_POLISH_RTOL * max(1, |theta|)``, or
    ``max_rounds``. A value that stops moving is not taken as converged: a
    slow round moves an upper pair's value by less than 1e-13 relative
    while it is still 1e-12 off. A pair that has converged stays in the
    next round's basis but grows no Krylov rows of its own. The depth
    starts at ``steps``; after a round whose largest residual fell less
    than 10x it goes to the most that ``_POLISH_ROWS`` rows in all allow
    (a doubling depth spent three rounds of 4, 8 and 16 steps that moved
    a near-degenerate pair's residual less than one 31-step round did).
    A depth-2 round squares the error only where the gap is wide against
    the spectrum's span; where it is narrow (the Jx/Jp sectors) it contracts
    the error little, and three such rounds left a mixed solve's ground
    state 3e-11 to 7e-11 from the exact energy. Up to twelve rounds: where
    the last wanted level has a neighbor above it closer than the mixed
    solve's f32 noise (a near-degenerate pair cut by the number of wanted
    states), the solve hands over a mixture of the two, whose residual
    cannot fall below their gap until the rounds have filtered out the
    low-lying rest and split the pair; at nbath = 5, a pair 4.5e-7 apart
    stayed 8.9e-9 off after six rounds and came within 4e-15 in twelve
    (the JAX package returns the upper level of such a pair). With
    ``hold``, only the pairs within ``hold * max(1, |theta_0|)`` of the
    lowest count: they alone grow rows and hold the rounds, and the rest
    take what the Rayleigh-Ritz step gives them (the T = 0 scan, where a
    level that far up never joins the ground set: a second level cut from
    a near neighbor above it otherwise spent all twelve rounds and still
    ended 1e-7 to 1e-4 off, and the lowest converges faster alone). An
    input eigenvector with error eta returns with eigenvalue error
    O(eta^2) or better. Returns (values host f64 [k], vectors f64 [k, *vshape] on the
    device). With ``reduce``, vecs are this rank's rows. Each call counts
    in :data:`polish_counts`, and is the span ``ed.polish`` on the same
    clock reads.
    """
    t0 = time.perf_counter_ns()
    k = vecs.shape[0]
    grow = np.arange(k)
    depth = steps
    resid_prev = None
    vals = None
    for _ in range(max_rounds):
        vals, vecs, resid = _refine_once(op, op_apply, vecs, depth, grow,
                                         reduce)
        rel = resid / np.maximum(np.abs(vals), 1.0)
        off = rel > _POLISH_RTOL
        held = off if hold is None else off & (
            vals - vals[0] <= hold * max(1.0, abs(vals[0])))
        if not held.any():
            break
        grow = np.flatnonzero(held)
        cap = max(steps, (_POLISH_ROWS - k) // len(grow))
        worst = float(rel[held].max())
        if resid_prev is not None and worst > 0.1 * resid_prev:
            depth = cap
        depth = min(depth, cap)
        resid_prev = worst
    t1 = time.perf_counter_ns()
    polish_counts["calls"] += 1
    polish_counts["s"] += (t1 - t0) * 1e-9
    trace.add("ed.polish", t0, t1, pairs=k)
    return vals, vecs


def _refine_project(op, vecs: torch.Tensor, steps: int, op_apply: Callable,
                    grow, reduce: Optional[Callable] = None):
    """Block power basis + CGS2 + projection (device half of the polish):
    every input vector, and ``steps`` powers of H on those whose indices
    are in `grow`.

    Each candidate is orthogonalized against the rows kept so far by
    classical Gram-Schmidt twice, a pass two products with the row block
    (one sum over the ranks). A candidate whose orthogonal remainder falls
    below 1e-10 of its own norm is rank-dropped: its slot becomes an
    exact-zero row, which the projected problem leaves out. H is applied
    to orthonormalized vectors only. Returns (b_mat [r, *vshape], H b_mat,
    a_mat [r, r] host, ok [r] host).
    """
    vecs = vecs.double()
    k = vecs.shape[0]
    vshape = tuple(vecs.shape[1:])
    r = k + len(grow) * steps
    b_mat = vecs.new_zeros((r,) + vshape)
    hb = torch.empty_like(b_mat)
    b_flat = b_mat.reshape(r, -1)
    oks = []

    def accept(cand):
        n = len(oks)
        cand_nrm = _norm(cand, reduce, dim=None)
        w = cand.reshape(-1)
        for _ in range(2):
            c = b_flat[:n] @ w
            w = w - (c if reduce is None else reduce(c)) @ b_flat[:n]
        nrm = _norm(w, reduce, dim=None)
        ok = nrm > 1e-10 * torch.clamp(cand_nrm, min=1.0)
        b_flat[n] = torch.where(ok, w / torch.where(ok, nrm, 1.0), 0.0)
        oks.append(ok)
        return n

    applied = [False] * r

    def apply_row(i):
        hb[i] = op_apply(op, b_mat[i]).reshape(vshape)
        applied[i] = True
        return hb[i]

    frontier = [accept(vecs[j]) for j in range(k)]
    frontier = [frontier[j] for j in grow]
    for _ in range(steps):
        frontier = [accept(apply_row(idx)) for idx in frontier]
    for i in range(r):
        if not applied[i]:
            apply_row(i)
    a_mat = b_flat @ hb.reshape(r, -1).T
    if reduce is not None:
        a_mat = reduce(a_mat)
    a_mat = 0.5 * (a_mat + a_mat.T)
    return b_mat, hb, a_mat.cpu().numpy(), torch.stack(oks).cpu().numpy()


def _refine_once(op, op_apply: Callable, vecs: torch.Tensor, steps: int,
                 grow, reduce: Optional[Callable] = None
                 ) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """One polish round: (values [k], unit vectors, residual norms [k])."""
    k = vecs.shape[0]
    b_mat, hb, a_mat, ok = _refine_project(op, vecs, steps, op_apply,
                                           grow, reduce)
    # the eigenproblem of the kept rows alone: a dropped row pinned far
    # above the spectrum would set the scale of LAPACK's backward error
    keep = np.flatnonzero(ok)
    w, s_keep = np.linalg.eigh(a_mat[np.ix_(keep, keep)])
    n = min(k, len(keep))
    vals = np.full(k, _DROP_PIN)
    vals[:n] = w[:n]
    s = np.zeros((len(ok), k))
    s[keep, :n] = s_keep[:, :n]
    if n < k:
        log.warning("refine_eigenpairs: rank-dropped basis leaves %d < %d "
                    "valid directions; results truncated", n, k)
    s_cols = torch.as_tensor(s, dtype=b_mat.dtype, device=b_mat.device)
    out = torch.tensordot(s_cols.T, b_mat, dims=1)
    h_out = torch.tensordot(s_cols.T, hb, dims=1)
    theta = torch.as_tensor(vals, dtype=out.dtype, device=out.device
                            ).reshape((k,) + (1,) * (out.ndim - 1))
    nrm = torch.clamp(_norm(out.reshape(k, -1), reduce, dim=1), min=1e-200)
    resid = _norm((h_out - theta * out).reshape(k, -1), reduce, dim=1) / nrm
    return (vals, out / nrm.reshape((k,) + (1,) * (out.ndim - 1)),
            resid.cpu().numpy())
