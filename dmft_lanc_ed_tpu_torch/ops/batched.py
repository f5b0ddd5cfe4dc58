"""Batched small-sector diagonalization (port of
``dmft_lanc_ed_tpu/ops/batched.py``).

The reference scans sectors strictly one after another
(ED_DIAG.f90:58-278); most of them hold only 1e2-1e4 states, far too few
to occupy the card one at a time. Sectors whose padded dense factors share
a shape bucket are *stacked* and solved by one thick-restart Lanczos with a
leading batch axis: every Krylov step is one batched matmul over
[B, DimDw_p, DimUp_p] vectors (the JAX package's ``vmap``).

Mechanics:
- each sector's :class:`~.dense.DenseSectorOp` is built on the host and
  zero-padded on both hop axes to the bucket shape; padded rows form an
  exactly decoupled invariant subspace whose diagonal is shifted by
  +PAD_SHIFT, and start vectors carry exact-zero pad components, so the
  physical spectrum is computed exactly. The stack goes to the device in
  one copy per field;
- restart control (Ritz extraction, residual tests) runs per element on
  the host; the bucket iterates until every element has converged
  (converged ones ride along). On mixed precision the basis stays f64
  with f32-shadow projections, and each converged element is polished by
  the f64 Rayleigh-Ritz refinement. Elements that do not converge within
  the bucket budget come back as None, and the caller solves them
  serially.

Not carried over: the TPU's compile workarounds — the fixed batch floor
``B_FIXED`` with its dummy elements, the pinned-width Ritz prefix of the
first restart, and the orientation transpose that let a sector and its
mirror share one executable. Buckets are exact shape keys.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.observability import kernel_stats, trace
from .dense import DenseSectorOp, matvec_dense, matvec_dense_mixed
from .lanczos import _build_basis_rr, _ritz, refine_eigenpairs

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

PAD_SHIFT = 1.0e3

# buckets solved, sectors in them, thick restarts (one per bucket step) and
# sectors left unconverged, since the last reset
bucket_counts = {"buckets": 0, "sectors": 0, "restarts": 0,
                 "unconverged": 0}

_OP_FIELDS = ("diag", "hup", "hdw", "hup32", "hdw32", "nd_a", "nd_b",
              "nd_a32", "nd_b32", "ph_diag", "eph_el", "eph_x")
_APPLY = {"f64": matvec_dense, "mixed": matvec_dense_mixed}


def reset_bucket_counts() -> None:
    for k in bucket_counts:
        bucket_counts[k] = 0


def _pow2_at_least(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def bucket_key(op: DenseSectorOp) -> Tuple:
    """Shape-bucket key: (padded DimUp, padded DimDw, DimPh, Jx/Jp
    terms), the JAX package's key."""
    nd_t = 0 if op.nd_a is None else op.nd_a.shape[0]
    return (_pow2_at_least(op.dim_up, floor=64),
            _pow2_at_least(op.dim_dw, floor=64), op.dim_ph, nd_t)


def pad_dense_op_2d(op: DenseSectorOp, du_p: int, dd_p: int
                    ) -> DenseSectorOp:
    """Zero-pad both hop axes to (du_p, dd_p); pad diagonal += PAD_SHIFT.
    The Jx/Jp factors and the e-ph electron factor pad with zeros; the
    phonon-axis fields keep their shape."""
    du, dd = op.dim_up, op.dim_dw
    pu, pd = du_p - du, dd_p - dd
    if pu == 0 and pd == 0:
        return op
    diag = F.pad(op.diag, (0, pu, 0, pd))
    diag[dd:, :] += PAD_SHIFT
    diag[:dd, du:] += PAD_SHIFT
    kw = {}
    if op.nd_a is not None:
        kw.update({f: F.pad(getattr(op, f), (0, pu, 0, pu))
                   for f in ("nd_a", "nd_a32")})
        kw.update({f: F.pad(getattr(op, f), (0, pd, 0, pd))
                   for f in ("nd_b", "nd_b32")})
    if op.ph_diag is not None:
        kw.update(ph_diag=op.ph_diag, eph_x=op.eph_x,
                  eph_el=F.pad(op.eph_el, (0, pu, 0, pd)))
    return DenseSectorOp(
        diag=diag, hup=F.pad(op.hup, (0, pu, 0, pu)),
        hup32=F.pad(op.hup32, (0, pu, 0, pu)),
        hdw=F.pad(op.hdw, (0, pd, 0, pd)),
        hdw32=F.pad(op.hdw32, (0, pd, 0, pd)), nnz_count=op.nnz_count,
        **kw)


def stack_ops(ops: Sequence[DenseSectorOp], device=None) -> DenseSectorOp:
    """Stack same-shape ops into one op with a leading batch axis, on
    `device` (default: where they are); absent fields stay None."""
    def st(f):
        vals = [getattr(o, f) for o in ops]
        return None if vals[0] is None else torch.stack(vals).to(device)
    return DenseSectorOp(nnz_count=sum(o.nnz_count for o in ops),
                         **{f: st(f) for f in _OP_FIELDS})


def _slice_op(stacked: DenseSectorOp, b: int) -> DenseSectorOp:
    return DenseSectorOp(nnz_count=stacked.nnz_count, **{
        f: None if getattr(stacked, f) is None else getattr(stacked, f)[b]
        for f in _OP_FIELDS})


def _pad_vec(v_flat: np.ndarray, op: DenseSectorOp, du_p: int, dd_p: int
             ) -> np.ndarray:
    """Flat sector vector -> padded [(DimPh,) dd_p, du_p] with exact-zero
    pad."""
    v = v_flat.reshape(op.vshape)
    pads = ((0, 0),) * (v.ndim - 2) + ((0, dd_p - op.dim_dw),
                                       (0, du_p - op.dim_up))
    return np.pad(v, pads)


def lanczos_ground_state_bucket(
    ops: Sequence[DenseSectorOp],
    neigen: int,
    tol: float,
    precision: str = "f64",
    ncv: Optional[int] = None,
    max_restarts: int = 60,
    seed: int = 17,
    dtype=torch.float64,
    device=None,
) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Solve a shape bucket of sectors in one batched thick-restart Lanczos
    on `device` (default: where the ops are).

    Returns per sector (evals [k], evecs [k, dim] flat, unpadded, host
    f64), or None for a sector that did not converge within the bucket
    budget. Start vectors come from numpy ``default_rng(seed)``, one per
    sector in order, as in the JAX package.
    """
    b = len(ops)
    du_p, dd_p, dim_ph, _ = bucket_key(ops[0])
    vshape = (dd_p, du_p) if dim_ph == 1 else (dim_ph, dd_p, du_p)
    padded = [pad_dense_op_2d(o, du_p, dd_p) for o in ops]
    with trace.span("ed.upload") as up:
        stacked = stack_ops(padded, device)
        if trace.on and stacked.device.type == "cuda":
            nbytes = sum(getattr(stacked, f).nbytes for f in _OP_FIELDS
                         if getattr(stacked, f) is not None)
            up["bytes"] = nbytes
            trace.count("h2d_bytes", nbytes)
    dev = stacked.device
    dims = [o.dim for o in ops]
    neigen = min(neigen, min(dims))
    m = ncv or max(2 * neigen + 16, 32)
    m = min(m, min(dims))
    l_keep = min(max(2 * neigen, neigen + 4), max(m - 4, 1))
    apply_nd = _APPLY[precision]
    fast_proj = precision != "f64"
    rng = np.random.default_rng(seed)

    def start(i):
        """Random in the physical block, exact zero in the pad."""
        v = _pad_vec(rng.standard_normal(ops[i].dim), ops[i], du_p, dd_p)
        return v / np.linalg.norm(v)

    v0 = torch.as_tensor(np.stack([start(i) for i in range(b)]),
                         dtype=dtype, device=dev)
    prefix = torch.zeros((b, 0) + vshape, dtype=dtype, device=dev)
    theta0 = torch.zeros((b, 0), dtype=dtype, device=dev)
    l = 0
    done: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for _ in range(max_restarts):
        res = _build_basis_rr(lambda v: apply_nd(stacked, v), prefix,
                              theta0, v0, m, l, fast_proj=fast_proj)
        bucket_counts["restarts"] += 1
        kernel_stats.record(b * (m - l), stacked.nnz_count // b)
        l = min(l_keep, m - 2)
        s_keep = np.zeros((b, m, l))
        theta_keep = np.zeros((b, l))
        for i in range(b):
            theta_i, s_i = _ritz(res.t_mat[i], m)
            s_keep[i] = s_i[:, :l]
            theta_keep[i] = theta_i[:l]
            if i in done:
                continue
            resid = np.abs(res.beta_last[i] * s_i[m - 1, :])
            n_conv = 0
            while (n_conv < m and
                   resid[n_conv] <= tol * max(abs(theta_i[n_conv]), 1.0)):
                n_conv += 1
            if n_conv < neigen:
                continue
            s = torch.as_tensor(s_i[:, :neigen], dtype=dtype, device=dev)
            vecs = torch.tensordot(s.T, res.v_basis[i], dims=1)
            vals = theta_i[:neigen]
            if precision != "f64":
                # mixed-apply floor ~3e-6: the self-tuning f64 polish pins
                # the values (an f32 basis would need a residual-guarded
                # loop here, which is why the basis stays f64)
                vals, vecs = refine_eigenpairs(_slice_op(stacked, i),
                                               matvec_dense, vecs)
            order = np.argsort(vals)
            vecs_h = vecs.double().cpu().numpy()
            flat = np.stack([vecs_h[k][..., :ops[i].dim_dw, :ops[i].dim_up]
                             .reshape(-1) for k in order])
            done[i] = (np.asarray(vals)[order], flat)
        if len(done) == b:
            break
        # thick restart of every element (converged ones ride along)
        s_t = torch.as_tensor(s_keep, dtype=dtype, device=dev)
        prefix = torch.einsum("bml,bm...->bl...", s_t, res.v_basis)
        theta0 = torch.as_tensor(theta_keep, dtype=dtype, device=dev)
        v0 = res.v_next
        # exhausted chains restart from fresh random physical directions
        dead = np.nonzero(res.beta_last <= 0.0)[0]
        if dead.size:
            v0 = v0.clone()
            for i in dead:
                v0[i] = torch.as_tensor(start(i), dtype=dtype, device=dev)
    else:
        log.warning("batched bucket (%d sectors, shape %sx%s): %d/%d "
                    "unconverged after %d restarts — serial fallback",
                    b, du_p, dd_p, b - len(done), b, max_restarts)
    bucket_counts["buckets"] += 1
    bucket_counts["sectors"] += b
    bucket_counts["unconverged"] += b - len(done)
    return [done.get(i) for i in range(b)]
