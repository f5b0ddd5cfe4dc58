"""Sector-scan diagonalization driver (port of ``dmft_lanc_ed_tpu/diag.py``).

Replacement of ED_DIAG.f90 (`diagonalize_impurity` / `ed_diag_d`): scans the
(Nup, Ndw) sectors, runs host LAPACK for dimensions up to
`lanc_dim_threshold` and a Krylov solve above it, and collects states into a
:class:`~.eigenspace.StateList`: the T=0 ground-state window (gs_threshold
semantics, ED_DIAG.f90:251-263) or the capacity-limited finite-T list, with
`ed_post_diag`-style adaptation (ED_DIAG.f90:471-605).

Dispatch, as in the JAX package: with ``ed_batch_sectors`` (the default)
and a dense or band-sparse backend, Krylov sectors of up to
``ed_batch_dim_max`` states are solved first, stacked in shape buckets
(:func:`_solve_batched_sectors`, ops/batched.py); the rest, and any bucket
element left unconverged, are solved one by one. Band-sparse sectors
(ed_backend "pallas") take the two-stage solve of
:func:`_blocksparse_ground_state`.

With ``cfg.mesh_shape`` and that many ranks running (parallel/), every rank
runs this scan; Krylov sectors with dim_dw >= ``ed_shard_min_dimdw`` are
solved dw-sharded over the ranks: through the band-sparse kernel B5 where
its halo form applies (parallel/bs_sharded.py), else through the sharded
direct operator (``ed_backend="direct"`` or ``ed_sparse_h=F``) or the
sharded dense one (parallel/production.py), phonon and Jx/Jp sectors
included, each choice logged. Every rank ends with the same states.

``ed_diag_type="full"`` diagonalizes every sector completely by host
LAPACK (:func:`_diag_full`) and keeps every state. ``lanc_method="dvdson"``
solves each serial Krylov sector by preconditioned Davidson
(ops/davidson.py) over the sector's production apply, with the f64 polish
where that apply is mixed; the batched and sharded sectors keep their
Lanczos solves, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from .bath import Bath
from .config import EDConfig
from .eigenspace import EigenState, StateList
from .hamiltonian import build_sector_hamiltonian, dense_hamiltonian
from .ops.batched import (bucket_counts, bucket_key,
                          lanczos_ground_state_bucket)
from .ops.blocksparse import (BlockSparseSectorOp, build_blocksparse_op,
                              from_padded, matvec_bs_exact_padded,
                              matvec_bs_mixed_padded, matvec_bs_padded,
                              to_padded)
from .ops.davidson import davidson_ground_state, op_diag_flat
from .ops.dense import build_dense_op
from .ops.bs_chain import _K_BUCKETS, chain_applicable, ground_state_seed
from .ops.factory import (apply_is_exact, exact_apply, make_sector_op,
                          resolve_backend, resolve_device, resolve_precision)
from .ops.lanczos import (_POLISH_RTOL, _refine_once, lanczos_ground_state,
                          refine_eigenpairs, restart_counts)
from .ops.op_cache import SectorOpCache, sector_op
from .parallel.bs_sharded import (blocksparse_shardable,
                                  bs_sharded_ground_state)
from .parallel.production import (shard_sector_op, sharded_backend,
                                  sharded_ground_state, should_shard,
                                  solver_mesh)
from .sectors import SectorQN, SectorTable
from .utils.observability import trace

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

# thick restarts of the two-stage solve's mixed top-off, and the calls of
# its guard's parity split and f64 top-off, since the last reset (each
# solve reports its own in timings)
topoff_counts = {"topoff_restarts": 0, "parity_splits": 0, "f64_topoffs": 0}
_PARITY_MIX = 1e-5     # norm of a unit vector's smaller spin-flip part
_F64_TOL = 1e-12       # residual tolerance of the f64 top-off
_F64_NCV = 64          # its smallest Krylov basis
# at T = 0 the polish holds its rounds for the levels within this share of
# |E0| of a sector's lowest (or 10 gs_threshold, if more): one further up
# never joins the ground set, whatever its last digits
_POLISH_HOLD = 1e-6


def _lanc_tol(cfg: EDConfig, exact: bool) -> float:
    """Krylov residual tolerance honoring the noise floor of the apply the
    solve runs: an f64-exact apply reaches 1e-14; a mixed one (true-f32
    products, ~1e-7 relative) stagnates near 3e-6, and the f64
    Rayleigh-Ritz polish recovers the rest. The JAX package takes the floor
    from the configured backend, so there a sector that the band-sparse
    backend hands to an f64 dense operator (phonons, Jx/Jp, every bucket)
    stops at 3e-6 with no polish (ROADMAP C)."""
    return max(cfg.lanc_tolerance, 1e-14 if exact else 3e-6)


@dataclass
class DiagState:
    """Cross-iteration diagonalization control state (neigen adaptation)."""
    neigen_sector: Dict[SectorQN, int] = field(default_factory=dict)
    lanc_nstates_total: int = 1
    sector_hint: Optional[List[SectorQN]] = None   # restart restriction


def _scan_sectors(cfg: EDConfig, table: SectorTable,
                  ctl: DiagState) -> List[SectorQN]:
    qns = table.all_qns()
    if cfg.ed_twin:
        qns = [s for s in qns if all(u >= d for u, d in zip(s[0], s[1]))]
    if cfg.ed_sectors and ctl.sector_hint:
        shift = cfg.ed_sectors_shift
        keep = []
        for s in qns:
            for h in ctl.sector_hint:
                if (max(abs(a - b) for a, b in zip(s[0], h[0])) <= shift and
                        max(abs(a - b) for a, b in zip(s[1], h[1])) <= shift):
                    keep.append(s)
                    break
        qns = keep
    return qns


def _sector_neigen(cfg: EDConfig, ctl: DiagState, sqn, dim: int) -> int:
    if cfg.finite_t:
        return min(dim, ctl.neigen_sector.get(sqn, cfg.lanc_nstates_sector))
    return min(dim, cfg.lanc_nstates_sector)


def _solve_batched_sectors(cfg: EDConfig, table: SectorTable, hloc, bath,
                           ctl: DiagState, h_basis, mesh, qns, device
                           ) -> Dict:
    """Pre-solve the small Krylov sectors in shape buckets (ops/batched.py);
    returns {sqn: (evals, evecs)} for the sectors solved."""
    buckets: Dict = {}
    for sqn in qns:
        dim = table.dim(sqn)
        neigen = _sector_neigen(cfg, ctl, sqn, dim)
        if not dim > max(cfg.lanc_dim_threshold, neigen):
            continue                       # dense path
        if dim > cfg.ed_batch_dim_max:
            continue                       # large: serial/sharded path
        if should_shard(cfg, mesh, table.sector(sqn).dim_dw, dim):
            continue
        ncv = max(min(dim, cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add),
                  2 * neigen + 16)
        if dim < ncv:
            continue                       # basis would exhaust the sector
        # host-resident build: padding and stacking stay on the host, the
        # bucket goes to the device in one copy per field
        with trace.span("ed.op_build", site="bucket", qn=sqn,
                        backend="dense"):
            trace.count("op_builds.bucket")
            op = build_dense_op(cfg, table.sector(sqn), hloc, bath, "cpu",
                                h_basis=h_basis)
        buckets.setdefault(bucket_key(op), []).append((sqn, op, neigen))

    results: Dict = {}
    for bkey, group in buckets.items():
        neigen = max(g[2] for g in group)
        min_dim = min(g[1].dim for g in group)
        # a deeper basis than the serial default: the JAX package measured
        # m = 48 best for its buckets (fewer restarts beat the ~m^2 CGS2)
        ncv = max(min(min_dim, max(48, cfg.lanc_ncv_factor * neigen
                                   + cfg.lanc_ncv_add)), 2 * neigen + 16)
        with trace.span("ed.bucket", sectors=len(group)) as sp:
            restarts = bucket_counts["restarts"]
            sols = lanczos_ground_state_bucket(
                [g[1] for g in group], neigen,
                tol=_lanc_tol(cfg, resolve_precision(cfg, device) == "f64"),
                precision=resolve_precision(cfg, device),
                ncv=min(ncv, min_dim), device=device)
            sp["restarts"] = bucket_counts["restarts"] - restarts
        log.info("batched bucket %s: %d sectors, neigen=%d, %d solved",
                 bkey[:2], len(group), neigen,
                 sum(s is not None for s in sols))
        for (sqn, _, _), sol in zip(group, sols):
            if sol is not None:
                results[sqn] = sol
    return results


def _spin_flip_symmetric(op) -> bool:
    """True when the sector is its own twin and H commutes with the spin
    flip, which there is X -> X^T of the [dim_dw, dim_up] vector and of
    the permuted padded one (nup == ndw with both spins alike: the same
    states, the same permutation and the same hop factor; a diagonal
    symmetric to the last bits of its sums)."""
    pop = op.pop
    if op.dim_dw != op.dim_up or not torch.equal(op.perm_dw, op.perm_up):
        return False
    n = op.dim_dw
    d = pop.diag_p[:n, :n]
    scale = max(1.0, float(d.abs().max()))
    return (torch.equal(pop.hup_p, pop.hdw_p) and
            float((d - d.T).abs().max()) <= 1e-13 * scale)


def _parity_split(pop, vals, vecs: torch.Tensor, neigen: int,
                  force: bool = False, hold: Optional[float] = None):
    """The handed-over vectors of a spin-flip symmetric sector, split
    into their even and odd parts where any of them mixes the two (or
    always, with `force`), cut to the lowest `neigen` by a Rayleigh-Ritz
    step and polished together in f64: (values, vectors), each of one
    parity; ``hold`` as :func:`refine_eigenpairs` takes it.

    A pair of levels of opposite parity closer than the mixed top-off's
    floor (the Ising-Hund doublet, impurity up-up-up against
    down-down-down, which only the bath splits) reaches the polish as one
    mixture of the two; each part alone lies in one parity class, so the
    polish splits the pair exactly, however close it is. Split before the
    polish, the handover costs the polish no rounds on the mixture."""
    flip = vecs.transpose(-1, -2)
    parts = (0.5 * (vecs + flip), 0.5 * (vecs - flip))
    norms = [torch.linalg.vector_norm(p.flatten(1), dim=1) for p in parts]
    mixed = float(torch.minimum(*norms).max()) > _PARITY_MIX
    if not (mixed or force):
        return vals, vecs
    with (trace.span("ed.parity_split", pairs=len(vecs)) if mixed
          else contextlib.nullcontext()):
        if mixed:
            topoff_counts["parity_splits"] += 1
            trace.count("parity_splits")
        kept = []
        for part, nrm in zip(parts, norms):
            for v, nv in zip(part, nrm.tolist()):
                if nv <= _PARITY_MIX:
                    continue
                w = (v / nv).flatten()
                for _ in range(2):
                    for u in kept:
                        w = w - torch.dot(u, w) * u
                nw = float(torch.linalg.vector_norm(w))
                if nw > 1e-3:
                    kept.append(w / nw)
        if len(kept) < neigen:
            return vals, vecs
        block = torch.stack(kept).reshape((-1,) + tuple(vecs.shape[1:]))
        if len(kept) > neigen:
            _, block, _ = _refine_once(pop, matvec_bs_exact_padded, block,
                                       0, np.arange(0))
            block = block[:neigen]
        return refine_eigenpairs(pop, matvec_bs_exact_padded, block,
                                 hold=hold)


def _f64_topoff(pop, v0: torch.Tensor, neigen: int, ncv: int, reason: str):
    """Thick-restart Lanczos over the f64-exact apply from `v0`, to a
    residual of _F64_TOL: the fallback where the mixed top-off raised or
    its polished lowest pair missed the polish's target (a cluster of
    levels closer than the mixed floor, of which the handover held a
    mixture). None where it does not converge either."""
    with trace.span("ed.f64_topoff", reason=reason) as sp:
        topoff_counts["f64_topoffs"] += 1
        trace.count("f64_topoffs")
        restarts = restart_counts["ground_state"]
        try:
            out = lanczos_ground_state(
                pop, matvec_bs_exact_padded, pop.dim, neigen,
                ncv=max(ncv, _F64_NCV), tol=_F64_TOL, dtype=torch.float64,
                v0=v0, vshape=pop.padded_shape)
        except RuntimeError as exc:
            log.warning("f64 top-off (%s) did not converge: %s", reason, exc)
            out = None
        sp["restarts"] = restart_counts["ground_state"] - restarts
    return out


def _polish(op, vals, vecs_p, neigen: int, flip: bool,
            hold: Optional[float]):
    """The f64 polish of the mixed top-off's handover, split by spin-flip
    parity first where the sector has that symmetry (`flip`)."""
    pop = op.pop
    vecs = torch.as_tensor(vecs_p, device=op.device).double().reshape(
        (-1,) + pop.padded_shape)
    if flip:
        return _parity_split(pop, vals, vecs, neigen, force=True, hold=hold)
    return refine_eigenpairs(pop, matvec_bs_exact_padded, vecs, hold=hold)


def _guard(op, vals, vecs_p, neigen: int, ncv: int, flip: bool,
           hold: Optional[float] = None):
    """What the two-stage solve hands back, held to the sector's lowest
    levels: split by spin-flip parity where the sector has that symmetry
    (`flip`) and a vector mixes the classes; redone by the f64 top-off
    where the lowest pair's residual |H y - theta y| missed the polish's
    target."""
    pop = op.pop
    vecs = torch.as_tensor(vecs_p, device=op.device).double().reshape(
        (-1,) + pop.padded_shape)
    if flip:
        vals, vecs = _parity_split(pop, vals, vecs, neigen, hold=hold)
    r = matvec_bs_exact_padded(pop, vecs[0]) - float(vals[0]) * vecs[0]
    if float(torch.linalg.vector_norm(r)) > 2 * _POLISH_RTOL * max(
            1.0, abs(float(vals[0]))):
        out = _f64_topoff(pop, vecs.sum(0), neigen, ncv, "residual")
        if out is not None and out[0][0] <= vals[0]:
            vals, vecs_p = out
            vecs = torch.as_tensor(vecs_p, device=op.device).reshape(
                (-1,) + pop.padded_shape)
            if flip:
                vals, vecs = _parity_split(pop, vals, vecs, neigen,
                                           hold=hold)
    return vals, vecs


def _blocksparse_ground_state(cfg: EDConfig, op, dim: int, neigen: int,
                              ncv: int, use_chain: Optional[bool] = None):
    """Two-stage ground-state path of the band-sparse backend.

    Stage 1, where one chain fits (``chain_applicable``): the chain kernels
    (ops/bs_chain.py) — a B2 Lanczos tridiagonalization gives the Ritz
    bounds, a B3 Chebyshev filter bootstrapped from them gives the seed.
    Otherwise the per-call path: f32 thick-restart Lanczos whose apply is
    one B1 matvec launch per step. Stage 2: with a good chain seed and one
    wanted state, the f64 Rayleigh-Ritz polish alone (a few guarded calls);
    otherwise a mixed-precision Lanczos top-off seeded with stage 1's
    vector, then the polish (:func:`_polish`: in a spin-flip symmetric
    sector, of the handover's even and odd parts; at T = 0 held only to
    the levels near the sector's lowest). What either hands back passes
    :func:`_guard` (spin-flip parity, the lowest pair's residual, the f64
    top-off); where the mixed top-off raises, the f64 top-off takes over
    from the seed. Everything runs in the permuted padded space; the final
    vectors return to the natural order once. Returns (values host f64,
    vectors [k, dim] host f64)."""
    pop = op.pop
    pshape = pop.padded_shape

    def unpad_all(vals, vecs_p):
        """Padded Ritz vectors -> natural flat, renormalized (pad weight
        is ~0: the pad block is exactly decoupled and +PAD_SHIFT away)."""
        with trace.span("ed.unpad"):
            vecs_p = torch.as_tensor(vecs_p, device=op.device).reshape(
                (-1,) + pshape)
            vn = from_padded(op, vecs_p, torch.float64).reshape(
                len(vecs_p), -1)
            vn = vn / torch.linalg.vector_norm(vn, dim=1, keepdim=True)
            if trace.on and vn.is_cuda:
                trace.count("d2h_bytes", vn.nbytes)
            return np.asarray(vals), vn.cpu().numpy()

    flip = _spin_flip_symmetric(op)
    hold = None if cfg.finite_t else max(_POLISH_HOLD,
                                         10.0 * cfg.gs_threshold)
    if use_chain is None:
        use_chain = chain_applicable(op)
    if use_chain:
        with trace.span("ed.seed"):
            theta0, seed_p, eta = ground_state_seed(
                op, m_tri=96, m_cheb=min(2 * max(ncv, 64), _K_BUCKETS[-1]),
                return_padded=True)
        seed = seed_p.double()
        seed = seed / torch.linalg.vector_norm(seed)
        if neigen == 1 and eta <= 3e-3:
            # with a seed this good the f64 polish alone reaches f64 (its
            # per-call error contraction is ~500x); on persistent failure
            # fall through to the full top-off with the best vector found
            for _ in range(3):
                vals, vecs = refine_eigenpairs(pop, matvec_bs_exact_padded,
                                               seed[None])
                r = matvec_bs_exact_padded(pop, vecs[0]) - vals[0] * vecs[0]
                seed = vecs[0]
                if float(torch.linalg.vector_norm(r)) <= 1e-7 * max(
                        1.0, abs(vals[0])):
                    return unpad_all(*_guard(op, vals, vecs, neigen, ncv,
                                             flip))
    else:
        # the JAX package's jitted thick restart traces the op, which drops
        # the trim runs, and so applies the whole-window kernel B1b
        # (blocksparse.py:660-672); the port keeps that split: this solve
        # runs B1b, chain_step runs the trimmed B1a (bit-identical outputs)
        with trace.span("ed.seed"):
            v0n = np.random.default_rng(17).standard_normal(
                (op.dim_dw, op.dim_up))
            v0 = to_padded(op, v0n / np.linalg.norm(v0n))
            _, evecs_p = lanczos_ground_state(
                pop, partial(matvec_bs_padded, trim=False), pop.dim, neigen,
                ncv=ncv, tol=max(_lanc_tol(cfg, False), 5e-5),
                dtype=torch.float32, v0=v0, vshape=pshape)
            seed = torch.as_tensor(evecs_p[0],
                                   device=op.device).reshape(pshape)
    with trace.span("ed.topoff") as sp:
        restarts = restart_counts["ground_state"]
        try:
            out = lanczos_ground_state(
                pop, matvec_bs_mixed_padded, pop.dim, neigen, ncv=ncv,
                tol=_lanc_tol(cfg, False), dtype=torch.float64,
                v0=seed, vshape=pshape, fast_proj=op.device.type == "cuda")
        except RuntimeError as exc:
            log.info("mixed top-off: %s; the f64 top-off takes over", exc)
            out = None
        restarts = restart_counts["ground_state"] - restarts
        topoff_counts["topoff_restarts"] += restarts
        sp["restarts"] = restarts
        trace.count("topoff.restarts", restarts)
    if out is None:
        out = _f64_topoff(pop, seed, neigen, ncv, "raised")
        if out is None:
            raise RuntimeError("two-stage solve: neither the mixed nor the "
                               f"f64 top-off converged (dim={dim})")
    else:
        out = _polish(op, *out, neigen, flip, hold)
    return unpad_all(*_guard(op, *out, neigen, ncv, flip, hold))


def _sharded_ground_state(cfg: EDConfig, sqn, sec, hloc, bath, h_basis,
                          mesh, dim: int, neigen: int, ncv: int, device):
    """A Krylov sector solved dw-sharded over the mesh (the reference's
    P-ARPACK over the MPI Dw-split, ED_DIAG.f90:151-171): the band-sparse
    kernel B5 when its halo form applies to this sector and mesh, else the
    sharded direct or dense backend (production.sharded_backend), each
    choice logged. Same result on every rank."""
    backend = sharded_backend(cfg, mesh.device)
    if resolve_backend(cfg, device) == "pallas":
        with trace.span("ed.op_build", site="diag", qn=sqn,
                        backend="pallas"):
            trace.count("op_builds.diag")
            h = build_sector_hamiltonian(cfg, sec, hloc, bath,
                                         h_basis=h_basis)
            why_not = blocksparse_shardable(h, mesh.size)
            # built on the host: each rank moves only its shard to its card
            op = build_blocksparse_op(h, "cpu") if why_not is None else None
        if op is not None:
            log.info("sector %s (dim %d): dw-sharded band-sparse fused solve "
                     "on %d devices", sqn, dim, mesh.size)
            return bs_sharded_ground_state(cfg, op, mesh, neigen, ncv)
        log.info("sector %s (dim %d): band-sparse shard path unavailable "
                 "(%s) — sharded %s backend", sqn, dim, why_not, backend)
    else:
        log.info("sector %s (dim %d): sharded %s backend on %d ranks", sqn,
                 dim, backend, mesh.size)
    with trace.span("ed.op_build", site="diag", qn=sqn, backend=backend):
        trace.count("op_builds.diag")
        sop = shard_sector_op(cfg, sec, hloc, bath, h_basis, mesh)
    # start vector with exact-zero pad rows (the pad subspace is invariant,
    # parallel/production.pad_dense_op)
    v0 = sop.pad_flat(np.random.default_rng(17).standard_normal(dim))
    return sharded_ground_state(
        sop, neigen, ncv, _lanc_tol(cfg, sop.exact_nd is sop.apply_nd), v0)


def diagonalize_impurity(cfg: EDConfig, table: SectorTable, hloc: np.ndarray,
                         bath: Bath, ctl: Optional[DiagState] = None,
                         device="cuda",
                         h_basis: Optional[np.ndarray] = None,
                         op_cache: Optional[SectorOpCache] = None
                         ) -> StateList:
    """One full spectrum determination (diagonalize_impurity, ED_DIAG.f90:22)
    on `device` (the card unless the caller asks for "cpu"). With
    `op_cache` (a solver's), the band-sparse sectors of the serial scan
    take their operators from it (``ops/op_cache.py``)."""
    device = resolve_device(device)
    if cfg.ed_diag_type == "full":
        return _diag_full(cfg, table, hloc, bath, h_basis)
    ctl = ctl or DiagState(lanc_nstates_total=cfg.lanc_nstates_total)
    finite_t = cfg.finite_t
    state_list = StateList(
        max_size=ctl.lanc_nstates_total if finite_t else None)

    mesh = solver_mesh(cfg, device)
    qns = _scan_sectors(cfg, table, ctl)
    batch_results: Dict = {}
    if cfg.ed_batch_sectors and \
            resolve_backend(cfg, device) not in ("ell", "direct"):
        batch_results = _solve_batched_sectors(cfg, table, hloc, bath, ctl,
                                               h_basis, mesh, qns, device)

    oldzero = np.inf
    diag_log = []
    sector_tops = []
    for sqn in qns:
        dim = table.dim(sqn)
        neigen = _sector_neigen(cfg, ctl, sqn, dim)
        sec = table.sector(sqn)

        lanc_solve = dim > max(cfg.lanc_dim_threshold, neigen)
        with trace.span("ed.sector", qn=sqn, dim=dim) as sp:
            if sqn in batch_results:
                sp["route"] = "batched"
                evals, evecs = batch_results[sqn]
                evals, evecs = evals[:neigen], evecs[:neigen]
            elif lanc_solve and should_shard(cfg, mesh, sec.dim_dw, dim):
                sp["route"] = "sharded"
                ncv = min(dim,
                          cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add)
                ncv = max(ncv, 2 * neigen + 16)
                evals, evecs = _sharded_ground_state(
                    cfg, sqn, sec, hloc, bath, h_basis, mesh, dim, neigen,
                    min(ncv, dim), device)
            elif lanc_solve:
                op, op_apply = sector_op(
                    cfg, sec, hloc, bath, device,
                    partial(make_sector_op, cfg, sec, hloc, bath, device,
                            h_basis=h_basis),
                    "diag", resolve_backend(cfg, device), h_basis=h_basis,
                    cache=op_cache)
                ncv = min(dim,
                          cfg.lanc_ncv_factor * neigen + cfg.lanc_ncv_add)
                ncv = max(ncv, 2 * neigen + 16)
                polish = None if apply_is_exact(op_apply) \
                    else exact_apply(op)
                if cfg.lanc_method == "dvdson":
                    # Davidson with diagonal preconditioning
                    # (sp_dvdson_eigh, ED_DIAG.f90:189-204)
                    sp["route"] = "serial"
                    evals, evecs = davidson_ground_state(
                        op, op_apply, dim, neigen, op_diag_flat(op),
                        ncv=min(ncv, dim),
                        tol=_lanc_tol(cfg, apply_is_exact(op_apply)),
                        dtype=torch.float64, polish_apply=polish)
                elif isinstance(op, BlockSparseSectorOp):
                    sp["route"] = "chain"
                    evals, evecs = _blocksparse_ground_state(
                        cfg, op, dim, neigen, min(ncv, dim))
                else:
                    sp["route"] = "serial"
                    evals, evecs = lanczos_ground_state(
                        op, op_apply, dim, neigen, ncv=min(ncv, dim),
                        tol=_lanc_tol(cfg, apply_is_exact(op_apply)),
                        dtype=torch.float64,
                        polish_apply=polish)
            else:
                sp["route"] = "eigh"
                w, v = _host_eigh(cfg, sec, sqn, hloc, bath, h_basis)
                evals, evecs = w[:neigen], v[:, :neigen].T

        diag_log.append((sqn, np.asarray(evals).copy(), lanc_solve))
        sector_tops.append((sqn, float(np.max(evals)) if len(evals) else
                            -np.inf, len(evals) >= dim))
        # twin reconstruction: the spin-flipped sector's eigenvector is the
        # [dw, up] transpose of this one
        twin_qn = table.twin(sqn) if cfg.ed_twin and sqn != table.twin(sqn) \
            else None

        def twin_vec(vec_flat):
            v3 = vec_flat.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
            return np.ascontiguousarray(np.swapaxes(v3, 1, 2)).reshape(-1)

        for k in range(len(evals)):
            e = float(evals[k])
            vec = np.asarray(evecs[k], np.float64)
            adds = [(sqn, vec)]
            if twin_qn is not None:
                adds.append((twin_qn, twin_vec(vec)))
            for qn_i, vec_i in adds:
                if finite_t:
                    state_list.add(EigenState(qn_i, e, vec_i,
                                              twin=qn_i != sqn))
                elif e < oldzero - 10.0 * cfg.gs_threshold:
                    # T=0 ground-state window (ED_DIAG.f90:251-263)
                    oldzero = e
                    state_list = StateList(max_size=None)
                    state_list.add(EigenState(qn_i, e, vec_i,
                                              twin=qn_i != sqn))
                elif abs(e - oldzero) <= cfg.gs_threshold:
                    oldzero = min(oldzero, e)
                    state_list.add(EigenState(qn_i, e, vec_i,
                                              twin=qn_i != sqn))
    state_list.diag_log = diag_log
    if finite_t and state_list.size:
        tol = 1e-8 * max(1.0, state_list.emax - state_list.emin)
        unclean = [sqn for sqn, top, full in sector_tops
                   if not full and top < state_list.emax - tol]
        state_list.clean_cut = not unclean
        if unclean:
            log.info("diag: state list is not a clean energy cut (sectors "
                     "%s top out below emax)", unclean[:4])
    _post_diag(cfg, state_list, ctl)
    return state_list


def _diag_full(cfg: EDConfig, table: SectorTable, hloc, bath,
               h_basis) -> StateList:
    """Full diagonalization of every sector (ed_full_d, ED_DIAG.f90:287-398)
    by host LAPACK, every eigenpair kept: the observables and the GF then
    take exact Boltzmann sums."""
    state_list = StateList(max_size=None)
    for sqn in table.all_qns():
        w, v = _host_eigh(cfg, table.sector(sqn), sqn, hloc, bath, h_basis)
        for k in range(len(w)):
            state_list.add(EigenState(sqn, float(w[k]),
                                      np.ascontiguousarray(v[:, k])))
    return state_list


def _host_eigh(cfg: EDConfig, sec, sqn, hloc, bath, h_basis):
    """The sector's whole spectrum by host LAPACK: (values, vectors as
    columns)."""
    with trace.span("ed.op_build", site="eigh", qn=sqn, backend="host"):
        trace.count("op_builds.eigh")
        hd = dense_hamiltonian(build_sector_hamiltonian(cfg, sec, hloc, bath,
                                                        h_basis=h_basis))
    with trace.span("ed.eigh", qn=sqn, dim=sec.dim):
        return np.linalg.eigh(hd)


def _post_diag(cfg: EDConfig, state_list: StateList, ctl: DiagState) -> None:
    """Adaptive spectrum sizing (ed_post_diag, ED_DIAG.f90:471-605)."""
    if not cfg.finite_t or state_list.size == 0:
        if not cfg.finite_t:
            ctl.sector_hint = state_list.sectors_contributing()
        return
    counts: Dict[SectorQN, int] = {}
    for s in state_list.states:
        counts[s.qn] = counts.get(s.qn, 0) + 1
    for sqn, c in counts.items():
        ctl.neigen_sector[sqn] = c + 1
    egs, emax = state_list.emin, state_list.emax
    tail = np.exp(-cfg.beta * (emax - egs))
    if tail > cfg.cutoff and state_list.max_size is not None \
            and state_list.size >= state_list.max_size:
        ctl.lanc_nstates_total += cfg.lanc_nstates_step
        log.info("post_diag: growing lanc_nstates_total -> %d (tail %.2e)",
                 ctl.lanc_nstates_total, tail)
    elif tail < cfg.cutoff and state_list.size > 2 * cfg.lanc_nstates_step:
        e_cut = egs - np.log(cfg.cutoff) / cfg.beta
        keep = [s for s in state_list.states if s.e <= e_cut]
        if len(keep) < state_list.size:
            ctl.lanc_nstates_total = max(len(keep), 1)
