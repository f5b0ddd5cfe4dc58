"""A solver's band-sparse sector operators, kept on the device across
solves, with only their bath-dependent values made anew.

Between two solves of one :class:`~..solver.EDSolver` only the bath moves.
A band-sparse operator (``ops/blocksparse.py``) depends on it through the
values of its hop factors (each one-spin hop term's amplitude, times a
sign, at fixed positions) and through its diagonal (the one-spin level
sums e_up + e_dw over a bath-independent interaction part). The basis, the
RCM permutations, the slab geometry, the trim runs and their tables, and
the positions and signs of every hop entry depend only on the sector and
on which amplitudes are nonzero. So the first build of a sector (a
*miss*) records, beside the op, a skeleton: for each hop term of each
spin, the positions its entries take in every value field, their signs,
and the interaction part of the diagonal. A later solve whose amplitudes
have the same zeros (the key) *refills* the op: it uploads the amplitudes
and the one-spin levels, scatters the factors on the device, adds the
diagonal in the host's order of operations and runs the diagonal's ACA
there as the host runs it, to the rank the miss found (one host read
checks that the host would have stopped there; a failed check drops the
entry for a fresh build). Every value is then the fresh build's, bit for
bit. The refilled op is a new
:class:`~.blocksparse.BlockSparseSectorOp` with fresh value tensors and
the structure tensors shared, so an op that an earlier solve handed out
keeps its values, and the per-op bf16 splits (``ops/bf16x3``) never
mistake one for the other. Within a solve, a lookup whose bath values
equal the entry's *reuses* its op as it is: the GF's targets that the
scan has just solved.

:func:`sector_op` is what the scan and the GF call: reuse (counter
``op_cache.reuse``, no span), or the ``ed.op_build`` span with a refill
(``cache="refill"``, counter ``op_cache.refill``) or a fresh build
(counter ``op_builds.<site>``; ``cache="miss"`` and ``op_cache.miss``
where the cache recorded it). At the end of each solve the solver drops
every entry the solve did not touch, and the value tensors of the others:
between solves an entry holds its skeleton alone.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..bath import Bath, bath_levels
from ..config import EDConfig
from ..hamiltonian import (_electron_diag_factors, _spin_hop_terms,
                           build_sector_hamiltonian)
from ..sectors import Sector, hop_entries
from ..utils.observability import trace
from .blocksparse import (ACA_RANK_MAX, PAD_SHIFT, BlockSparseSectorOp,
                          blocksparse_applicable, build_blocksparse_op,
                          matvec_bs_flat)

ACA_TOL = 1e-12     # blocksparse._aca's default tolerance

# an op's bath-dependent fields: what a refill makes anew, and what an
# entry lets go of between solves
_POP_VALUES = ("dw_f32", "up_f32", "diag_a", "diag_b", "diag_p", "hup_p",
               "hdw_p", "hup_p32", "hdw_p32")
_OP_VALUES = ("diag", "hup", "hdw", "hup32", "hdw32")


@dataclass(frozen=True)
class _Bath:
    """The bath-dependent numbers of one sector's operator: each spin's
    hop terms (pos_create, pos_destroy, amp) in ``_spin_hop_terms`` order,
    their amplitudes, the one-spin levels, and the factors of the
    diagonal's interaction part (a_dw @ b_up.T)."""
    terms: tuple
    amps: Tuple[np.ndarray, np.ndarray]     # up, dw: [terms] f64
    e_up: np.ndarray                        # [dim_up] f64
    e_dw: np.ndarray                        # [dim_dw] f64
    a_dw: np.ndarray
    b_up: np.ndarray

    @property
    def key(self) -> tuple:
        return tuple(tuple(a != 0.0) for a in self.amps)

    def same(self, other: "_Bath") -> bool:
        return all(np.array_equal(x, y) for x, y in zip(
            (*self.amps, self.e_up, self.e_dw),
            (*other.amps, other.e_up, other.e_dw)))


def _bath_numbers(cfg: EDConfig, sec: Sector, hloc, bath: Bath,
                  h_basis) -> _Bath:
    """The numbers ``build_sector_hamiltonian`` takes from the bath, at
    O(dim_up + dim_dw) cost."""
    bath_diag, diag_hybr, hbath = bath_levels(cfg, bath, h_basis)
    hloc = np.asarray(hloc, dtype=np.float64)
    terms = tuple(_spin_hop_terms(cfg, spin, hloc, diag_hybr, hbath)
                  for spin in (0, 1))
    amps = tuple(np.array([t[2] for t in ts], np.float64) for ts in terms)
    return _Bath(terms, amps, *_electron_diag_factors(cfg, sec, hloc,
                                                      bath_diag))


@dataclass(frozen=True)
class _HopTable:
    """Where one spin's hop entries land: the entry's term, its sign, and
    its flat index in the natural factor, the padded permuted factor and
    the f32 slabs (int64, on the device)."""
    term: torch.Tensor
    sign: torch.Tensor      # f64, +-1
    nat: torch.Tensor
    pad: torch.Tensor
    slab: torch.Tensor


def _hop_table(states: np.ndarray, terms, iperm: np.ndarray, np_: int,
               w: int, d: int, axis: int, device) -> _HopTable:
    """The table of one spin's factor over `states`: ``hop_entries`` of
    each nonzero term at unit amplitude gives its entries and signs (the
    terms are distinct pairs of levels, so no two share an entry)."""
    n = len(states)
    parts = [(np.full(len(r), t), r, c, v)
             for t, (p, q, amp) in enumerate(terms) if amp != 0.0
             for r, c, v in [hop_entries(states, p, q, 1.0)]]
    tid, rows, cols, sign = (np.concatenate(x) for x in zip(
        *parts, (np.zeros(0, np.int64),) * 3 + (np.zeros(0),)))
    pr, pc = iperm[rows], iperm[cols]
    if axis == 0:       # dw row slabs [nt, 128, w]
        panel, inner, along = pr // 128, pr % 128, pc
    else:               # up column slabs [nt, w, 128]
        panel, inner, along = pc // 128, pc % 128, pr
    off = along - np.clip((panel - d) * 128, 0, np_ - w)
    slab = panel * 128 * w + (inner * w + off if axis == 0
                              else off * 128 + inner)

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return _HopTable(term=dev(tid), sign=dev(sign, torch.float64),
                     nat=dev(rows * n + cols), pad=dev(pr * np_ + pc),
                     slab=dev(slab))


@dataclass
class _Entry:
    k: tuple                # (sector qn, device)
    cfg: EDConfig
    key: tuple              # the amplitudes' zeros (_Bath.key)
    bath: Optional[_Bath]   # the numbers `op` holds; None between solves
    op: BlockSparseSectorOp     # its value fields None between solves
    hops: Tuple[_HopTable, _HopTable]    # up, dw
    fixed: torch.Tensor     # [dd, du] f64: the diagonal less e_up + e_dw
    # what a refill reads of the op's shapes
    device: torch.device
    padded: Tuple[int, int]
    slabs: Tuple[torch.Size, torch.Size]     # up_f32, dw_f32
    rank_cols: int          # diag_a's columns


def _scatter(n: int, idx: torch.Tensor, vals: torch.Tensor, dtype,
             shape) -> torch.Tensor:
    out = torch.zeros(n, dtype=dtype, device=vals.device)
    out[idx] = vals.to(dtype)
    return out.reshape(shape)


def _with_values(op: BlockSparseSectorOp, pop_vals: dict, op_vals: dict
                 ) -> BlockSparseSectorOp:
    return dataclasses.replace(
        op, pop=dataclasses.replace(op.pop, **pop_vals), **op_vals)


class SectorOpCache:
    """The band-sparse sector operators of one solver, by sector and
    device (see the module's docstring). Holds at most one solve's
    working set: :meth:`end_solve` drops what the solve did not touch,
    and the value tensors of what it did."""

    def __init__(self):
        self._entries: Dict[tuple, _Entry] = {}
        self._touched: set = set()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, qn) -> bool:
        return any(k[0] == qn for k in self._entries)

    def begin_solve(self) -> None:
        self._touched = set()

    def end_solve(self) -> None:
        for k in [k for k in self._entries if k not in self._touched]:
            del self._entries[k]
        for e in self._entries.values():
            e.bath = None
            e.op = _with_values(e.op, dict.fromkeys(_POP_VALUES),
                                dict.fromkeys(_OP_VALUES))

    def lookup(self, cfg: EDConfig, sec: Sector, hloc, bath: Bath, device,
               h_basis=None) -> Tuple[Optional[_Entry], _Bath]:
        """The entry that can make this sector's op for `bath` (None where
        there is none, or its key or configuration differs, which drops
        it), and the bath's numbers."""
        k = _key(sec, device)
        self._touched.add(k)
        vals = _bath_numbers(cfg, sec, hloc, bath, h_basis)
        e = self._entries.get(k)
        if e is not None and (e.cfg is not cfg or e.key != vals.key):
            del self._entries[k]
            e = None
        return e, vals

    def store(self, cfg: EDConfig, sec: Sector, device, vals: _Bath,
              op: BlockSparseSectorOp) -> None:
        """Record the skeleton of an op freshly built for the numbers
        `vals` (a miss)."""
        pop, dev = op.pop, op.device
        ddp, dup = pop.padded_shape
        with trace.span("ed.upload") as up:
            hops = tuple(
                _hop_table(np.asarray(states), vals.terms[spin],
                           iperm.cpu().numpy(), np_, w, d, axis, dev)
                for spin, states, iperm, np_, w, d, axis in (
                    (0, sec.states_up[0], op.iperm_up, dup, pop.w_up,
                     pop.d_up, 1),
                    (1, sec.states_dw[0], op.iperm_dw, ddp, pop.w_dw,
                     pop.d_dw, 0)))
            fixed = torch.as_tensor(vals.a_dw @ vals.b_up.T, device=dev)
            if dev.type == "cuda":
                nbytes = fixed.nbytes + sum(
                    getattr(t, f.name).nbytes for t in hops
                    for f in dataclasses.fields(t))
                up["bytes"] = nbytes
                trace.count("h2d_bytes", nbytes)
        k = _key(sec, device)
        self._entries[k] = _Entry(
            k=k, cfg=cfg, key=vals.key, bath=vals, op=op, hops=hops,
            fixed=fixed, device=dev, padded=(ddp, dup),
            slabs=(pop.up_f32.shape, pop.dw_f32.shape),
            rank_cols=pop.diag_a.shape[1])
        self._touched.add(k)

    def refill(self, e: _Entry, vals: _Bath) -> Optional[BlockSparseSectorOp]:
        """A new op of the entry's sector for the bath numbers `vals`, or
        None (and the entry dropped) where the diagonal's ACA would take
        another rank."""
        dev = e.device
        dd, du = e.op.dim_dw, e.op.dim_up
        ddp, dup = e.padded
        host = np.concatenate([*vals.amps, vals.e_up, vals.e_dw])
        with trace.span("ed.upload") as up:
            x = torch.as_tensor(host, device=dev)
            if dev.type == "cuda":
                up["bytes"] = x.nbytes
                trace.count("h2d_bytes", x.nbytes)
        n_up, n_dw = len(vals.amps[0]), len(vals.amps[1])
        amps = (x[:n_up], x[n_up:n_up + n_dw])
        e_up = x[n_up + n_dw:n_up + n_dw + du]
        e_dw = x[n_up + n_dw + du:]

        f64, f32 = torch.float64, torch.float32
        fields = []
        for t, a, n, np_, slab_shape in (
                (e.hops[0], amps[0], du, dup, e.slabs[0]),
                (e.hops[1], amps[1], dd, ddp, e.slabs[1])):
            v = a[t.term] * t.sign
            fields.append(dict(
                nat=_scatter(n * n, t.nat, v, f64, (n, n)),
                nat32=_scatter(n * n, t.nat, v, f32, (n, n)),
                pad=_scatter(np_ * np_, t.pad, v, f64, (np_, np_)),
                pad32=_scatter(np_ * np_, t.pad, v, f32, (np_, np_)),
                slab=_scatter(slab_shape.numel(), t.slab, v, f32,
                              slab_shape)))
        up_f, dw_f = fields

        # the host's order: (e_up[None, :] + e_dw[:, None]) + a_dw @ b_up.T
        diag = (e_up[None, :] + e_dw[:, None]) + e.fixed
        diag_n = diag.index_select(0, e.op.perm_dw).index_select(
            1, e.op.perm_up)
        diag_p = torch.full((ddp, dup), PAD_SHIFT, dtype=f64, device=dev)
        diag_p[:dd, :du] = diag_n
        ab = _aca_device(diag_n, e.op.pop.diag_rank)
        if ab is None:
            self._entries.pop(e.k, None)
            return None
        a, b = ab
        r = a.shape[1]
        diag_a = torch.zeros((ddp, e.rank_cols), dtype=f32, device=dev)
        diag_b = torch.zeros((e.rank_cols, dup), dtype=f32, device=dev)
        diag_a[:dd, :r] = a
        diag_b[:r, :du] = b
        diag_a[dd:, r] = PAD_SHIFT
        diag_b[r, :] = 1.0
        diag_a[:dd, r + 1] = PAD_SHIFT
        diag_b[r + 1, du:] = 1.0

        op = _with_values(
            e.op,
            dict(dw_f32=dw_f["slab"], up_f32=up_f["slab"], diag_a=diag_a,
                 diag_b=diag_b, diag_p=diag_p, hup_p=up_f["pad"],
                 hdw_p=dw_f["pad"], hup_p32=up_f["pad32"],
                 hdw_p32=dw_f["pad32"]),
            dict(diag=diag, hup=up_f["nat"], hdw=dw_f["nat"],
                 hup32=up_f["nat32"], hdw32=dw_f["nat32"]))
        e.op, e.bath = op, vals
        return op


def _key(sec: Sector, device) -> tuple:
    return (sec.qn, str(torch.device(device)))


def _aca_device(diag: torch.Tensor, rank: int, tol: float = ACA_TOL
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``blocksparse._aca`` on the device, `rank` steps: each pivot the
    first largest |residual| (numpy's and torch's argmax alike), each step
    the host's arithmetic, so the f32 factors a [dd, R], b [R, du] are the
    host's bit for bit, or None where the host's ACA would not take
    exactly `rank` steps (a pivot at the tolerance, or a residual above
    it). One host read."""
    r = diag.clone()
    du = r.shape[1]
    scale = r.abs().max()
    a_list, b_list, piv = [], [], []
    for _ in range(rank):
        flat = r.abs().reshape(-1).argmax().reshape(1)
        i, j = flat // du, flat % du
        a = r.index_select(1, j).reshape(-1)
        p = a.index_select(0, i)
        b = r.index_select(0, i).reshape(-1) / p
        piv.append(p.abs())
        a_list.append(a)
        b_list.append(b)
        r.sub_(torch.outer(a, b))
    low = torch.cat(piv).min() if piv else scale
    res, low, scale = torch.stack([r.abs().max(), low, scale]).tolist()
    scale = scale or 1.0
    # the host stops at the first pivot <= tol * scale, or after
    # ACA_RANK_MAX steps, and keeps a residual <= 10 * tol * scale
    stop = tol if rank < ACA_RANK_MAX else 10 * tol
    if not (rank and low > tol * scale and res <= stop * scale):
        return None
    return (torch.stack(a_list, 1).float(), torch.stack(b_list, 0).float())


def _cacheable(cfg: EDConfig, backend: str) -> bool:
    """Whether the sectors take the band-sparse operator in float64, the
    one a refill makes: the band-sparse backend without the phonon and
    Jx/Jp terms that ``blocksparse_applicable`` refuses."""
    return (backend == "pallas" and np.dtype(cfg.ed_dtype) == np.float64
            and cfg.dim_ph <= 1
            and not (cfg.norb > 1 and (cfg.jx != 0.0 or cfg.jp != 0.0)))


def sector_op(cfg: EDConfig, sec: Sector, hloc, bath: Bath, device,
              build: Callable[[], tuple], site: str, backend: str,
              h_basis=None, cache: Optional[SectorOpCache] = None
              ) -> tuple:
    """The (op, apply) pair of a sector: ``build()`` under the
    ``ed.op_build`` span of `site`, counted as ``op_builds.<site>``. With
    a `cache` and the band-sparse `backend`: within a solve the cached op
    of the same bath as it is (``op_cache.reuse``, no span); else the
    cached op refilled for this bath (``op_cache.refill``); else the
    band-sparse build, which the cache records (``op_cache.miss``), or
    ``build()`` where the sector exceeds the band-sparse operator's device
    budget. Where the configuration has no float64 band-sparse operator
    the cache stays out."""
    if not _cacheable(cfg, backend):
        cache = None
    e = vals = None
    if cache is not None:
        e, vals = cache.lookup(cfg, sec, hloc, bath, device, h_basis)
        if e is not None and e.bath is not None and e.bath.same(vals):
            trace.count("op_cache.reuse")
            return e.op, matvec_bs_flat
    with trace.span("ed.op_build", site=site, qn=sec.qn,
                    backend=backend) as sp:
        op = cache.refill(e, vals) if e is not None else None
        if op is not None:
            sp["cache"] = "refill"
            trace.count("op_cache.refill")
            return op, matvec_bs_flat
        trace.count(f"op_builds.{site}")
        if cache is None:
            return build()
        h = build_sector_hamiltonian(cfg, sec, hloc, bath, h_basis=h_basis)
        if not blocksparse_applicable(h):
            return build()
        op = build_blocksparse_op(h, device)
        cache.store(cfg, sec, device, vals, op)
        sp["cache"] = "miss"
        trace.count("op_cache.miss")
        return op, matvec_bs_flat
