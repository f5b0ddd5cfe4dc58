"""Impurity Green's functions and self-energy (port of
``dmft_lanc_ed_tpu/gf.py``; reference ED_GF_NORMAL.f90, ED_GF_SHARED.f90).

GFs are stored as pole/weight data (the reference's `GFmatrix`) and
evaluated on any frequency grid in one broadcast. Excitation vectors
c|psi>, c^+|psi> are built on the host by injective fancy assignment over
the sector maps; their Krylov tridiagonalizations run on the device, batched
by target sector (:class:`_ExcBatcher`):

- targets with dim >= ``ed_gf_chain_min_dim`` of the band-sparse backend run
  the B4 chain kernel (:func:`~.ops.bs_chain.gf_tridiag_batch`);
- smaller targets run a batched Lanczos scan over the dense operator;
- with ``cfg.mesh_shape`` and that many ranks running, targets with
  dim_dw >= ``ed_shard_min_dimdw`` run the batched scan over the dw-sharded
  dense or direct operator (parallel/production.py; phonon blocks
  included), each rank holding its rows of
  the chains (the reference's scattered vectors, ED_GF_NORMAL.f90:224-238);
  they bypass B4, as in the JAX package.

The tiny tridiagonal eigenproblems run on host LAPACK. Conventions as in
the reference: pole contribution peso/(z - isign*(lambda_j - E_i)),
peso = norm2 * Z(1,j)^2 * boltzmann/Z (add_to_lanczos_gf_normal).

The off-diagonal GF (``ed_solve_offdiag_gf``, and every hybrid or replica
bath) queues the mixed vectors (c_a + c_b)|psi> into the same target
sectors as the diagonal ones, so a target's diagonal and mixed chains run
in one batch, and recombines G_ab = 1/2 (G_mix - G_aa - G_bb) pole by pole
(ED_GF_NORMAL.f90:82-98, :347-588). ``build_gf_full`` is the full-ED
Lehmann double sum, on the host.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch

from .bath import Bath
from .bath_functions import invg0_bath
from .config import EDConfig
from .eigenspace import StateList
from .ops.factory import resolve_device
from .ops.lanczos import lanczos_tridiag_batched, tridiag_eigh
from .ops.op_cache import sector_op
from .parallel.production import (ShardedSectorOp, apply_counts,
                                  shard_sector_op, should_shard, solver_mesh)
from .sectors import Sector, SectorQN, SectorTable, op_map
from .utils.observability import kernel_stats, trace

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

Channel = Tuple[int, int, int]   # (ispin, iorb, jorb)


@dataclass
class GFPoles:
    """Rational representation sum_k w_k / (z - p_k) of one GF channel."""
    weights: np.ndarray = field(default_factory=lambda: np.zeros(0))
    poles: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def add(self, w: np.ndarray, p: np.ndarray) -> None:
        self.weights = np.concatenate([self.weights, w])
        self.poles = np.concatenate([self.poles, p])

    def __call__(self, z: np.ndarray) -> np.ndarray:
        if len(self.weights) == 0:
            return np.zeros(len(z), dtype=np.complex128)
        zz = np.asarray(z, np.complex128)
        w = np.asarray(self.weights, np.complex128)
        p = np.asarray(self.poles)
        return (w[None, :] / (zz[:, None] - p[None, :])).sum(-1)


@dataclass
class GFData:
    """All GF channels of one solve."""
    channels: Dict[Channel, GFPoles] = field(default_factory=dict)
    # excitations routed through the B4 chain kernel and the dense scan
    routing: Tuple[int, int] = (0, 0)

    def get(self, c: Channel) -> GFPoles:
        if c not in self.channels:
            self.channels[c] = GFPoles()
        return self.channels[c]

    def evaluate(self, cfg: EDConfig, z: np.ndarray) -> np.ndarray:
        """[nspin, nspin, norb, norb, L] on the given frequency points."""
        out = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, len(z)),
                       dtype=np.complex128)
        for (s, a, b), gp in self.channels.items():
            out[s, s, a, b] = gp(z)
        return out


def apply_op(cfg: EDConfig, sec_from: Sector, sec_to: Sector, vec,
             iorb: int, ispin: int, create: bool) -> np.ndarray:
    """vvinit = c^{(+)}_{iorb, ispin} |vec>, mapped into sector `sec_to`
    (host numpy; ED_GF_NORMAL.f90:184-216 / 259-290 behavior). vec: flat
    in sector_from linear order; returns flat in sector_to order."""
    du_f, dd_f, dp = sec_from.dim_up, sec_from.dim_dw, sec_from.dim_ph
    du_t, dd_t = sec_to.dim_up, sec_to.dim_dw
    v = np.asarray(vec).reshape(dp, dd_f, du_f)
    if ispin == 0:
        idx, sgn = op_map(sec_from.states_up[0], sec_to.states_up[0],
                          iorb, create)
        m = idx >= 0
        out = np.zeros((dp, dd_t, du_t), v.dtype)
        out[:, :, idx[m]] = v[:, :, m] * sgn[m].astype(v.dtype)[None, None]
    else:
        idx, sgn = op_map(sec_from.states_dw[0], sec_to.states_dw[0],
                          iorb, create)
        m = idx >= 0
        out = np.zeros((dp, dd_t, du_f), v.dtype)
        out[:, idx[m], :] = v[:, m, :] \
            * sgn[m].astype(v.dtype)[None, :, None]
    return out.reshape(-1)


class HCache:
    """Per-solve cache of target-sector operators on `device` (the card
    unless the caller asks for "cpu"): (op, apply) pairs from the backend
    factory, built once per sector. Under the band-sparse backend, targets
    below ``ed_gf_chain_min_dim`` get the dense operator (its apply is the
    same mixed contract as the band-sparse flat apply); the others come
    from the solver's `op_cache` where one is given (``ops/op_cache.py``:
    the scan's operator of this bath as it is). With a mesh,
    :meth:`sharded` gives the dw-sharded operator of a large target."""

    def __init__(self, cfg: EDConfig, table: SectorTable, hloc, bath: Bath,
                 device="cuda", h_basis=None, op_cache=None):
        from .ops.factory import resolve_backend
        self.cfg = cfg
        self.table = table
        self.hloc = hloc
        self.bath = bath
        self.device = resolve_device(device)
        self.h_basis = h_basis
        self.backend = resolve_backend(cfg, self.device)
        self.mesh = solver_mesh(cfg, self.device)
        self.op_cache = op_cache
        self._cache: Dict[SectorQN, tuple] = {}
        self._sharded: Dict[SectorQN, ShardedSectorOp] = {}

    def _dense_target(self, sec: Sector) -> bool:
        return (self.backend == "pallas"
                and sec.dim < self.cfg.ed_gf_chain_min_dim)

    def _build(self, sec: Sector):
        from .ops.factory import _DENSE_APPLY, make_sector_op, \
            resolve_precision
        from .ops.dense import build_dense_op
        if self._dense_target(sec):
            op = build_dense_op(self.cfg, sec, self.hloc, self.bath,
                                self.device, h_basis=self.h_basis)
            return op, _DENSE_APPLY[resolve_precision(self.cfg, self.device)]
        return make_sector_op(self.cfg, sec, self.hloc, self.bath,
                              self.device, h_basis=self.h_basis)

    def __call__(self, sqn: SectorQN):
        if sqn not in self._cache:
            sec = self.table.sector(sqn)
            self._cache[sqn] = sector_op(
                self.cfg, sec, self.hloc, self.bath, self.device,
                partial(self._build, sec), "gf", self.backend,
                h_basis=self.h_basis,
                cache=None if self._dense_target(sec) else self.op_cache)
        return self._cache[sqn]

    def sharded(self, sqn: SectorQN):
        """ShardedSectorOp for the sector, or None when unsharded."""
        sec = self.table.sector(sqn)
        if not should_shard(self.cfg, self.mesh, sec.dim_dw, sec.dim):
            return None
        if sqn not in self._sharded:
            self._sharded[sqn] = shard_sector_op(
                self.cfg, sec, self.hloc, self.bath, self.h_basis, self.mesh)
        return self._sharded[sqn]


class _ExcBatcher:
    """Collects excitation vectors by target sector, then runs each
    sector's chains together (batched continued fractions)."""

    def __init__(self, cfg: EDConfig, hcache: HCache, max_bytes=1 << 27):
        self.cfg = cfg
        self.hcache = hcache
        self.groups: Dict[SectorQN, List] = {}
        self.max_bytes = max_bytes
        self.routing = (0, 0)

    def add(self, jqn: SectorQN, vv: np.ndarray, norm2: float,
            state_e: float, isign: int, peso: float, gf: GFPoles) -> None:
        self.groups.setdefault(jqn, []).append(
            (vv, norm2, state_e, isign, peso, gf))

    @staticmethod
    def _accumulate(chunk, a_np, b_np) -> None:
        """Tridiagonals -> continued-fraction poles (add_to_lanczos_gf)."""
        with trace.span("ed.gf_poles", chains=len(chunk)):
            for t, a, b in zip(chunk, a_np, b_np):
                _, norm2, state_e, isign, peso, gf = t
                theta, s = tridiag_eigh(a, b)
                weights = norm2 * peso * (s[0, :] ** 2)
                poles = isign * (theta - state_e)
                keep = np.abs(weights) > 1e-30
                gf.add(weights[keep], poles[keep])

    def run(self) -> None:
        from .ops.blocksparse import BlockSparseSectorOp
        from .ops.bs_chain import gf_chain_applicable, gf_tridiag_batch
        n_chain = n_scan = 0
        for jqn, tasks in self.groups.items():
            with trace.span("ed.gf_chains", qn=jqn, chains=len(tasks)) as sp:
                dim = tasks[0][0].shape[0]
                log.debug("gf batch: sector %s, %d excitations, dim %d",
                          jqn, len(tasks), dim)
                m = min(dim, self.cfg.lanc_ngfiter)
                vs = np.stack([t[0] for t in tasks])
                sop = self.hcache.sharded(jqn)
                if sop is not None:
                    # this rank's rows of every chain of the target, summed
                    # over the ranks at each projection
                    sp["route"] = "sharded"
                    n_scan += len(tasks)
                    apply_counts["gf_chains"] += len(tasks)
                    kernel_stats.record(m * len(tasks), sop.nnz)
                    v0 = sop.pad_flat_batch(vs).reshape(len(tasks), -1)
                    a_b, b_b = lanczos_tridiag_batched(
                        sop, v0, m, ShardedSectorOp.apply_flat,
                        reduce=sop.mesh.allreduce)
                    self._accumulate(tasks, a_b, b_b)
                    continue
                op, op_apply = self.hcache(jqn)
                if (isinstance(op, BlockSparseSectorOp)
                        and dim >= self.cfg.ed_gf_chain_min_dim
                        and gf_chain_applicable(op, m)):
                    # B4: every excitation of this target in one chain launch
                    sp["route"] = "B4"
                    n_chain += len(tasks)
                    kernel_stats.record(m * len(tasks), op.nnz)
                    a_b, b_b = gf_tridiag_batch(op, vs, m)
                    self._accumulate(tasks, a_b, b_b)
                    continue
                sp["route"] = "scan"
                bmax = max(1, self.max_bytes // max(dim * 8, 1))
                for i0 in range(0, len(tasks), bmax):
                    chunk = tasks[i0:i0 + bmax]
                    n_scan += len(chunk)
                    kernel_stats.record(m * len(chunk),
                                        getattr(op, "nnz", 0))
                    v0 = torch.as_tensor(vs[i0:i0 + bmax],
                                         dtype=torch.float64,
                                         device=op.device)
                    a_b, b_b = lanczos_tridiag_batched(op, v0, m, op_apply)
                    if trace.on and v0.is_cuda:
                        trace.count("h2d_bytes", v0.nbytes)
                        trace.count("d2h_bytes", a_b.nbytes + b_b.nbytes)
                    self._accumulate(chunk, a_b, b_b)
        if n_chain or n_scan:
            log.info("gf batch routing: %d excitations via fused chain "
                     "kernel, %d via batched scan", n_chain, n_scan)
        self.routing = (n_chain, n_scan)
        self.groups.clear()


def _queue_excitation(cfg, table, batcher: _ExcBatcher, st, iorb, ispin,
                      create, peso, gf: GFPoles, op_vec=None,
                      jqn_override=None) -> None:
    """Queue c^{(+)}_{iorb,ispin}|psi>, or the given `op_vec` in the
    sector `jqn_override`, normalized once; a zero vector (norm^2 <
    1e-28) adds no chain."""
    isign = +1 if create else -1
    iud = iorb if table.ns_ud > 1 else 0
    jqn = jqn_override or (table.cdg_sector(st.qn, iud, ispin) if create
                           else table.c_sector(st.qn, iud, ispin))
    if jqn is None:
        return
    vv = np.asarray(op_vec) if op_vec is not None else apply_op(
        cfg, table.sector(st.qn), table.sector(jqn), st.vec, iorb, ispin,
        create)
    norm2 = float(np.vdot(vv, vv).real)
    if norm2 < 1e-28:
        return
    batcher.add(jqn, vv / np.sqrt(norm2), norm2, st.e, isign, peso, gf)


def build_gf_normal(cfg: EDConfig, table: SectorTable, hcache: HCache,
                    state_list: StateList) -> GFData:
    """Diagonal (and off-diagonal) electron GF (build_gf_normal), batched
    by target sector."""
    gf = GFData()
    weights, zeta = state_list.boltzmann_weights(cfg.beta, cfg.finite_t)
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    batcher = _ExcBatcher(cfg, hcache)
    with trace.span("ed.gf_excite"):
        for w_s, st in zip(weights, state_list.states):
            if cfg.finite_t and cfg.beta * (st.e - state_list.emin) >= 200:
                continue
            peso = w_s / zeta
            for ispin in range(cfg.nspin):
                for iorb in range(cfg.norb):
                    ch = gf.get((ispin, iorb, iorb))
                    _queue_excitation(cfg, table, batcher, st, iorb, ispin,
                                      True, peso, ch)
                    _queue_excitation(cfg, table, batcher, st, iorb, ispin,
                                      False, peso, ch)
            if offdiag:
                _queue_gf_offdiag(cfg, table, batcher, st, peso, gf)
    batcher.run()
    gf.routing = batcher.routing
    if offdiag:
        _recombine_offdiag(cfg, gf)
    return gf


def _queue_gf_offdiag(cfg, table, batcher, st, peso, gf: GFData) -> None:
    """Mixed-operator channels (c_a + c_b)|psi> for a < b
    (ED_GF_NORMAL.f90:347-588), queued under the channel (s, a, b)."""
    sec_i = table.sector(st.qn)
    for ispin in range(cfg.nspin):
        targets = {}
        for create in (True, False):
            jqn = (table.cdg_sector(st.qn, 0, ispin) if create
                   else table.c_sector(st.qn, 0, ispin))
            if jqn is not None:
                sec_j = table.sector(jqn)
                targets[create] = jqn, [
                    apply_op(cfg, sec_i, sec_j, st.vec, a, ispin, create)
                    for a in range(cfg.norb)]
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                for create, (jqn, vecs) in targets.items():
                    _queue_excitation(cfg, table, batcher, st, a, ispin,
                                      create, peso, gf.get((ispin, a, b)),
                                      op_vec=vecs[a] + vecs[b],
                                      jqn_override=jqn)


def _recombine_offdiag(cfg: EDConfig, gf: GFData) -> None:
    """G_ab <- 1/2 (G_mix - G_aa - G_bb) pole-wise, G_ba = G_ab
    (ED_GF_NORMAL.f90:82-98)."""
    for ispin in range(cfg.nspin):
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                mix = gf.channels.get((ispin, a, b))
                if mix is None:
                    continue
                gaa = gf.get((ispin, a, a))
                gbb = gf.get((ispin, b, b))
                new = GFPoles()
                new.add(0.5 * mix.weights, mix.poles)
                new.add(-0.5 * gaa.weights, gaa.poles)
                new.add(-0.5 * gbb.weights, gbb.poles)
                gf.channels[(ispin, a, b)] = new
                gf.channels[(ispin, b, a)] = new   # symmetric


def build_gf_full(cfg: EDConfig, table: SectorTable,
                  state_list: StateList) -> GFData:
    """Exact Lehmann sum over the full spectrum (full_build_gf_normal),
    host numpy:

    G_ab(z) = 1/Z sum_{i,j} <j|c^+_a|i> <j|c^+_b|i> (e^{-bEi} + e^{-bEj})
              / (z - (Ej - Ei)),

    the off-diagonal channels (a != b) with ``ed_solve_offdiag_gf`` or a
    non-normal bath; with orbital-resolved sectors (``ns_ud > 1``) each
    orbital has its own target sector and only the diagonal channels
    exist."""
    gf = GFData()
    beta = cfg.beta
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    by_sector: Dict[SectorQN, List] = {}
    for st in state_list.states:
        by_sector.setdefault(st.qn, []).append(st)
    e0 = state_list.emin
    zeta = sum(np.exp(-beta * (st.e - e0)) for st in state_list.states)

    def amplitudes(sqn, jqn, ispin, orbs):
        """(<j|c^+_a|i> [Nj, Ni] per orbital a, boltzmann sums, poles)."""
        sec_i, sec_j = table.sector(sqn), table.sector(jqn)
        states_i, states_j = by_sector[sqn], by_sector[jqn]
        vecs_j = np.stack([np.asarray(s.vec) for s in states_j])
        amps = {a: vecs_j @ np.stack([
            apply_op(cfg, sec_i, sec_j, s.vec, a, ispin, True)
            for s in states_i]).T for a in orbs}
        ei = np.array([s.e for s in states_i])
        ej = np.array([s.e for s in states_j])
        wb = (np.exp(-beta * (ei[None, :] - e0))
              + np.exp(-beta * (ej[:, None] - e0)))
        return amps, wb, ej[:, None] - ei[None, :]

    for ispin in range(cfg.nspin):
        accum: Dict[Tuple[int, int], list] = {}

        def push(a, b, w, p):
            keep = np.abs(w) > cfg.cutoff * 1e-3
            accum.setdefault((a, b), []).append((w[keep], p[keep]))
        for sqn in by_sector:
            if table.ns_ud == 1:
                jqn = table.cdg_sector(sqn, 0, ispin)
                if jqn is None or jqn not in by_sector:
                    continue
                amps, wb, p = amplitudes(sqn, jqn, ispin, range(cfg.norb))
                for a in range(cfg.norb):
                    for b in range(cfg.norb):
                        if a == b or offdiag:
                            push(a, b, amps[a] * amps[b] * wb / zeta, p)
            else:
                for a in range(cfg.norb):
                    jqn = table.cdg_sector(sqn, a, ispin)
                    if jqn is None or jqn not in by_sector:
                        continue
                    amps, wb, p = amplitudes(sqn, jqn, ispin, (a,))
                    push(a, a, amps[a] ** 2 * wb / zeta, p)
        for (a, b), lst in accum.items():
            gf.get((ispin, a, b)).add(np.concatenate([x[0] for x in lst]),
                                      np.concatenate([x[1] for x in lst]))
    return gf


def build_sigma(cfg: EDConfig, hloc, bath: Bath, gf: GFData, z: np.ndarray,
                h_basis=None) -> Tuple[np.ndarray, np.ndarray]:
    """Dyson self-energy (build_sigma_normal, ED_GF_NORMAL.f90:935-1002):
    returns (Sigma, G) on the given frequency points, reference layout.
    With off-diagonal channels (a hybrid or replica bath, or
    ``ed_solve_offdiag_gf``) Sigma = G0^-1 - G^-1 per spin as [norb, norb]
    matrices, inverted on the host."""
    g = gf.evaluate(cfg, z)
    ig0 = invg0_bath(cfg, hloc, bath, z, h_basis).numpy()
    sigma = np.zeros_like(g)
    if cfg.bath_type == "normal" and not cfg.ed_solve_offdiag_gf:
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                sigma[s, s, a, a] = ig0[s, s, a, a] - 1.0 / g[s, s, a, a]
    else:
        for s in range(cfg.nspin):
            inv = np.linalg.inv(g[s, s].transpose(2, 0, 1))
            sigma[s, s] = ig0[s, s] - inv.transpose(1, 2, 0)
    return sigma, g
