"""Susceptibilities and the phonon Green's function (port of
``dmft_lanc_ed_tpu/chi.py``; reference ED_GF_CHISPIN.f90,
ED_GF_CHIDENS.f90, ED_GF_PHONON.f90).

Hermitian-operator Krylov response functions: the operator is applied
diagonally (S_z, n) or across phonon blocks (x = b + b^+) within the *same*
sector, every start vector of a sector is tridiagonalized in one batch
(:class:`_ChiBatcher`), and the excitation data (dE, peso) are stored.
Evaluation on the bosonic Matsubara grid, imaginary time and the real axis
reproduces the reference's accumulation formulas (add_to_lanczos_spinChi,
ED_GF_CHISPIN.f90:436-489; add_to_lanczos_phonon, ED_GF_PHONON.f90:132-179):

  chi(iv_0)  = sum 2 peso (1-e^{-beta dE})/dE          [beta dE > 1e-3]
  chi(iv_n)  = sum peso (1-e^{-beta dE}) 2 dE/(v_n^2 + dE^2)
  chi(tau)   = sum peso e^{-tau dE}
  chi(w+i0+) = -sum peso (1-e^{-beta dE}) [1/(w+ie-dE) - 1/(w+ie+dE)]
  (phonon D: overall opposite sign on iv/real axes.)

Routing, as the GF's (gf._ExcBatcher): a band-sparse sector with dim >=
``ed_gf_chain_min_dim`` where :func:`~.ops.bs_chain.gf_chain_applicable`
holds runs all its chains in one call of the B4 chain kernel
(:func:`~.ops.bs_chain.gf_tridiag_batch`); every other sector runs the
batched Lanczos scan under a byte budget. Under a mesh the chains run on
the whole sector operator on every rank, as in the JAX package. Not
carried over: the JAX package's fixed batch floor of 8 and its power-of-two
batch padding.

One departure in form, not in value: each start vector O|psi> has its
component along |psi> itself taken out before the chain, and that weight
stored as an exact dE = 0 pole (:meth:`_ChiBatcher.add`). The exact pole
adds nothing at iv_n > 0 or on the real axis and adds <psi|O|psi>^2 to
chi(tau), as the converged Ritz pole of the whole vector would. A chain
whose products carry f32 error (B4, the mixed dense scan) puts that Ritz
value off E_psi (B4 at 853,776 states: +1.3e-7 and -2.7e-6): above the
1e-8 reverse-ordering tolerance of :func:`_store_poles`, which then counts
<n_a>^2 twice in chi_dens(tau), and across the 1e-3/beta iv_0 cut at low
enough temperature. For the same reason the reverse-ordering test of such
a chain takes a Ritz value within :data:`_F32_RITZ_RTOL` of a listed
energy of the chain's sector for that listed state (the JAX package
applies its 1e-8 tolerance alone to every chain).

Full-ED twins (ed_diag_type="full"): :class:`PairChiPoles` and the
``full_build_*`` functions take the Lehmann double sum over the complete
spectrum on the host.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from .config import EDConfig
from .eigenspace import StateList
from .gf import HCache
from .observables import _x_matrix
from .ops.factory import apply_is_exact
from .ops.lanczos import lanczos_tridiag_batched, tridiag_eigh
from .sectors import SectorTable, occupations
from .utils.observability import kernel_stats

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

# excitations of the last build of each kind ("spin", "dens", "phonon")
# routed through the B4 chain kernel and through the batched scan
routing: Dict[str, Tuple[int, int]] = {}


@dataclass
class ChiPoles:
    """Excitation data of one hermitian-operator response channel.

    One-sided ordered-pair storage: for a thermal state |i> (Boltzmann
    weight w_i) and a Ritz excitation theta with matrix-element strength P,

        peso = P w_i / Z,  pth = P w_theta / Z,  de = theta - E_i,
        rev  = 1 if theta is NOT covered by the state list else 0.

    The ordering with |i> in the thermal slot is always accumulated; the
    reverse ordering is added explicitly (rev=1) only when the partner
    state is absent from the state list (its own Krylov run provides it
    otherwise). Exact at T=0, and at finite T it matches the full-ED double
    sum (the reference's lanc factors double-count pairs of thermally
    occupied states; ROADMAP C, "Where the reference is fragile")."""
    peso: np.ndarray = field(default_factory=lambda: np.zeros(0))
    pth: np.ndarray = field(default_factory=lambda: np.zeros(0))
    de: np.ndarray = field(default_factory=lambda: np.zeros(0))
    rev: np.ndarray = field(default_factory=lambda: np.zeros(0))
    beta: float = 1.0

    def add(self, peso, pth, de, rev) -> None:
        self.peso = np.concatenate([self.peso, peso])
        self.pth = np.concatenate([self.pth, pth])
        self.de = np.concatenate([self.de, de])
        self.rev = np.concatenate([self.rev, rev])

    def _check_beta(self, beta: float) -> None:
        """The pole weights are baked at the solve's beta; evaluating at
        another temperature is inconsistent and rejected."""
        if len(self.peso) and abs(beta - self.beta) > 1e-12 * self.beta:
            raise ValueError(
                f"ChiPoles evaluated at beta={beta} but weights were "
                f"accumulated at beta={self.beta}")

    def matsubara(self, beta: float, vm: np.ndarray) -> np.ndarray:
        """chi(iv_n) on the bosonic grid (vm[0] == 0 handled specially)."""
        self._check_beta(beta)
        out = np.zeros(len(vm))
        p, pt, de, rev = self.peso, self.pth, self.de, self.rev
        if len(p) == 0:
            return out
        # iv=0: the reference skips |beta dE| <= 1e-3 pairs (Curie term)
        up = beta * de > 1e-3
        dn = (beta * de < -1e-3) & (rev > 0)
        out[0] = (2.0 * (p[up] - pt[up]) / de[up]).sum() \
            + (2.0 * (p[dn] - pt[dn]) / de[dn]).sum()
        if len(vm) > 1:
            fac = p - rev * pt
            out[1:] = (fac[None, :] * 2.0 * de[None, :]
                       / (vm[1:, None] ** 2 + de[None, :] ** 2)).sum(-1)
        return out

    def imtime(self, tau: np.ndarray) -> np.ndarray:
        if len(self.peso) == 0:
            return np.zeros(len(tau))
        p, de, rev = self.peso, self.de, self.rev
        fwd = p[None, :] * np.exp(-tau[:, None] * de[None, :])
        bwd = (rev * p)[None, :] * np.exp(
            -(self.beta - tau)[:, None] * de[None, :])
        return (fwd + bwd).sum(-1)

    def realaxis(self, beta: float, wr: np.ndarray, eps: float) -> np.ndarray:
        if len(self.peso) == 0:
            return np.zeros(len(wr), dtype=np.complex128)
        self._check_beta(beta)
        z = wr + 1j * eps
        fac = self.peso - self.pth
        return (fac[None, :] * (1.0 / (z[:, None] + self.de[None, :])
                                - self.rev[None, :]
                                / (z[:, None] - self.de[None, :]))
                ).sum(-1)


ChiSet = Dict[Tuple[int, int], ChiPoles]    # (iorb, jorb); (-1,-1) = total


def _diag_op_excite(sec, vec, diag_op) -> np.ndarray:
    """O|psi> for a diagonal operator O[dw, up] in the same sector."""
    v = np.asarray(vec).reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
    return (v * np.asarray(diag_op)[None]).reshape(-1)


# Where a Ritz value of a chain with f32 products (B4, the mixed dense
# scan) may sit off its eigenvalue, relative to max(1, |E|): ~1e-7 x |E|
# measured (nbath = 4, beta = 100: 4e-7 at |E| = 5.1 through B4's plain
# version, 1.8e-6 through the JAX package's B4 in interpret mode). Such a
# Ritz copy of a listed state can land above emax + 1e-8: the
# reverse-ordering test of :func:`_poles` would then take it for a state
# above the list and count its pair twice, from its own chain and in
# reverse, which moved chi(w) at eps = 0.01 by 10 % of max|chi| (ROADMAP
# C13). Only copies of the listed energies of the chain's own sector are
# matched at this tolerance: a level outside the list that lies just above
# emax keeps its reverse pair (a tolerance on every Ritz value would drop
# that of a level 1e-6 above emax, 5.6e-2 of max|chi| in
# tests/test_torch_real_axis.py).
_F32_RITZ_RTOL = 1e-6


def _poles(cfg: EDConfig, strength, theta, state_e, therm, listed=None):
    """(peso, pth, de, rev) of Ritz poles theta with strengths P.

    ``therm`` = (e0, emax, zeta, wi): global ground-state energy, top of the
    state list, partition function, and this state's Boltzmann weight.
    ``listed``: for a chain with f32 products, the state list's energies in
    the chain's sector; a Ritz value within :data:`_F32_RITZ_RTOL` of one
    of them is that listed state."""
    e0, emax, zeta, wi = therm
    de = theta - state_e
    eth = np.maximum(theta - e0, 0.0)                 # shifted pole energy
    peso = strength * wi / zeta
    pth = strength * np.exp(-cfg.beta * eth) / zeta
    # reverse ordering included only when the partner state cannot be in
    # the state list (energy above the list's coverage)
    tol = 1e-8 * max(1.0, abs(emax - e0))
    rev = theta > emax + tol
    if listed is not None and len(listed):
        near = (np.abs(theta[:, None] - listed[None, :])
                <= _F32_RITZ_RTOL * np.maximum(1.0, np.abs(listed)))
        rev &= ~near.any(axis=1)
    return peso, pth, de, rev.astype(np.float64)


def _store(chi: ChiPoles, peso, pth, de, rev) -> None:
    keep = np.maximum(np.abs(peso), np.abs(pth)) > 1e-30
    chi.add(peso[keep], pth[keep], de[keep], rev[keep])


def _store_poles(cfg, alphas, betas, norm2, state_e, therm,
                 chi: ChiPoles, listed=None) -> None:
    """Ritz-decompose one tridiagonal and store one-sided pole data."""
    theta, s = tridiag_eigh(alphas, betas)
    chi.beta = cfg.beta
    _store(chi, *_poles(cfg, norm2 * (s[0, :] ** 2), theta, state_e,
                        therm, listed))


class _ChiBatcher:
    """Collects same-sector excitation vectors and tridiagonalizes each
    sector's together: at finite T every retained state spawns
    norb(norb+3)/2 channels in its own sector, all sharing the operator."""

    def __init__(self, cfg: EDConfig, hcache: HCache, state_list: StateList,
                 max_bytes=1 << 27):
        self.cfg = cfg
        self.hcache = hcache
        self.listed: Dict = {}        # sector -> the list's energies there
        for st in state_list.states:
            self.listed.setdefault(st.qn, []).append(st.e)
        self.groups: Dict = {}
        self.max_bytes = max_bytes
        self.routing = (0, 0)

    def add(self, sqn, vv, psi, state_e, therm, chi: ChiPoles) -> None:
        """Queue the chain of vv = O|psi> (psi: the state, same sector).
        Its component along psi is stored as the exact pole theta = E_psi
        (module docstring), the rest is queued normalized; a remainder of
        norm^2 < 1e-28 adds no chain."""
        vv = np.asarray(vv)
        psi = np.asarray(psi)
        c = float(np.dot(psi, vv))
        vv = vv - c * psi
        chi.beta = self.cfg.beta
        _store(chi, *_poles(self.cfg, np.array([c * c]),
                            np.array([state_e]), state_e, therm))
        norm2 = float(np.dot(vv, vv))
        if norm2 < 1e-28:
            return
        self.groups.setdefault(sqn, []).append(
            (vv / np.sqrt(norm2), norm2, state_e, therm, chi))

    def _accumulate(self, sqn, chunk, a_np, b_np, f32: bool) -> None:
        listed = np.asarray(self.listed.get(sqn, ())) if f32 else None
        for (_, norm2, state_e, therm, chi), a, b in zip(chunk, a_np, b_np):
            _store_poles(self.cfg, a, b, norm2, state_e, therm, chi, listed)

    def run(self) -> None:
        from .ops.blocksparse import BlockSparseSectorOp
        from .ops.bs_chain import gf_chain_applicable, gf_tridiag_batch
        n_chain = n_scan = 0
        for sqn, tasks in self.groups.items():
            op, op_apply = self.hcache(sqn)
            dim = tasks[0][0].shape[0]
            m = min(dim, self.cfg.lanc_ngfiter)
            vs = np.stack([t[0] for t in tasks])
            if (isinstance(op, BlockSparseSectorOp)
                    and dim >= self.cfg.ed_gf_chain_min_dim
                    and gf_chain_applicable(op, m)):
                # B4: every chain of the sector in one chain launch
                n_chain += len(tasks)
                kernel_stats.record(m * len(tasks), op.nnz)
                a_b, b_b = gf_tridiag_batch(op, vs, m)
                self._accumulate(sqn, tasks, a_b, b_b, f32=True)
                continue
            bmax = max(1, self.max_bytes // max(dim * 8, 1))
            for i0 in range(0, len(tasks), bmax):
                chunk = tasks[i0:i0 + bmax]
                n_scan += len(chunk)
                kernel_stats.record(m * len(chunk), getattr(op, "nnz", 0))
                v0 = torch.as_tensor(vs[i0:i0 + bmax], dtype=torch.float64,
                                     device=op.device)
                a_b, b_b = lanczos_tridiag_batched(op, v0, m, op_apply)
                self._accumulate(sqn, chunk, a_b, b_b,
                                 f32=not apply_is_exact(op_apply))
        if n_chain or n_scan:
            log.info("chi batch routing: %d excitations via fused chain "
                     "kernel, %d via batched scan", n_chain, n_scan)
        self.routing = (n_chain, n_scan)
        self.groups.clear()


def _therm_states(cfg: EDConfig, state_list: StateList):
    """(therm, state) per retained state; warns when a finite-T list is not
    a clean energy cut."""
    weights, zeta = state_list.boltzmann_weights(cfg.beta, cfg.finite_t)
    e0, emax = state_list.emin, state_list.emax
    if cfg.finite_t and not getattr(state_list, "clean_cut", True):
        log.warning(
            "chi: state list is not a clean energy cut at emax (some "
            "sectors may hide uncomputed levels below the cut) — the "
            "one-sided reverse weighting can over-weight pairs whose "
            "partner is missing; re-solve after neigen_sector adaptation "
            "for converged susceptibilities")
    for w_s, st in zip(weights, state_list.states):
        yield (e0, emax, zeta, w_s if cfg.finite_t else 1.0), st


def _build_chi_diagop(cfg: EDConfig, table: SectorTable, hcache: HCache,
                      state_list: StateList, op_orb, kind: str) -> ChiSet:
    """Generic driver for diagonal hermitian operators per orbital.

    op_orb(sec, iorb) -> diag array [dim_dw, dim_up]; also builds the mixed
    (a,b) channels and the total (-1,-1) channel, with the reference's
    algebraic recombination chi_ab = 1/2 (chi_mix - chi_aa - chi_bb)."""
    chis: ChiSet = {}
    batcher = _ChiBatcher(cfg, hcache, state_list)
    for therm, st in _therm_states(cfg, state_list):
        sec = table.sector(st.qn)
        ops = [op_orb(sec, a) for a in range(cfg.norb)]

        def queue(key, op):
            batcher.add(st.qn, _diag_op_excite(sec, st.vec, op), st.vec,
                        st.e, therm, chis.setdefault(key, ChiPoles()))
        for a in range(cfg.norb):
            queue((a, a), ops[a])
        for a in range(cfg.norb):
            for b in range(a + 1, cfg.norb):
                queue((a, b), ops[a] + ops[b])
        if cfg.norb > 1:
            queue((-1, -1), sum(ops[1:], ops[0]))
    batcher.run()
    routing[kind] = batcher.routing
    # recombine mixed channels: chi_ab = (chi_mix - chi_aa - chi_bb)/2
    for a in range(cfg.norb):
        for b in range(a + 1, cfg.norb):
            mix = chis.get((a, b))
            if mix is None:
                continue
            new = ChiPoles(beta=cfg.beta)
            for sign, src in ((0.5, mix), (-0.5, chis[(a, a)]),
                              (-0.5, chis[(b, b)])):
                new.add(sign * src.peso, sign * src.pth, src.de, src.rev)
            chis[(a, b)] = new
            chis[(b, a)] = new
    if cfg.norb == 1:
        chis[(-1, -1)] = chis[(0, 0)]
    return chis


def _orbital_occupations(cfg: EDConfig, sec, a: int):
    """(n_up,a [dim_up], n_dw,a [dim_dw]) of the sector's basis, f64."""
    ou = occupations(sec.states_up[0], cfg.ns)[:, a].astype(np.float64)
    od = occupations(sec.states_dw[0], cfg.ns)[:, a].astype(np.float64)
    return ou, od


def _sz_op(cfg: EDConfig):
    def op(sec, a):
        ou, od = _orbital_occupations(cfg, sec, a)
        return 0.5 * (ou[None, :] - od[:, None])
    return op


def _n_op(cfg: EDConfig):
    def op(sec, a):
        ou, od = _orbital_occupations(cfg, sec, a)
        return ou[None, :] + od[:, None]
    return op


def build_chi_spin(cfg: EDConfig, table: SectorTable, hcache: HCache,
                   state_list: StateList) -> ChiSet:
    """S_z(a) = (n_up,a - n_dw,a)/2 response (build_chi_spin)."""
    return _build_chi_diagop(cfg, table, hcache, state_list, _sz_op(cfg),
                             "spin")


def build_chi_dens(cfg: EDConfig, table: SectorTable, hcache: HCache,
                   state_list: StateList) -> ChiSet:
    """Total density n(a) response (build_chi_dens)."""
    return _build_chi_diagop(cfg, table, hcache, state_list, _n_op(cfg),
                             "dens")


def build_gf_phonon(cfg: EDConfig, table: SectorTable, hcache: HCache,
                    state_list: StateList) -> ChiPoles:
    """Displacement GF D(z) from x = b + b^+ (build_gf_phonon).

    Stored as ChiPoles; evaluate with the *negative* of the chi formulas on
    iv/real axes (the reference flips signs for D, ED_GF_PHONON.f90:168-177).
    """
    chi = ChiPoles(beta=cfg.beta)
    x = _x_matrix(cfg.dim_ph)
    batcher = _ChiBatcher(cfg, hcache, state_list)
    for therm, st in _therm_states(cfg, state_list):
        sec = table.sector(st.qn)
        v = np.asarray(st.vec).reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        vv = np.einsum("pq,qdu->pdu", x, v).reshape(-1)
        batcher.add(st.qn, vv, st.vec, st.e, therm, chi)
    batcher.run()
    routing["phonon"] = batcher.routing
    return chi


# ---------------------------------------------------------------------------
# full-ED (Lehmann double-sum) variants — the reference's full_ed_build_*
# twins (ED_GF_CHISPIN.f90:501-592, ED_GF_CHIDENS.f90:502-593,
# ED_GF_PHONON.f90:188-248). Matrix elements <i|O|j> are computed per sector
# as one dense matmul M = V^T (diag(O) V) over the full eigenbasis.
# ---------------------------------------------------------------------------

@dataclass
class PairChiPoles:
    """Full-ED excitation data: pairs (peso, ei, ej) with energies relative
    to the global ground state, plus the (shifted) partition function.
    Evaluation formulas follow the reference literally (both (i,j) orderings
    are stored, so no (1-e^{-beta dE}) recombination is applied here)."""
    peso: np.ndarray
    ei: np.ndarray
    ej: np.ndarray
    zeta: float
    beta: float = 1.0

    def matsubara(self, beta: float, vm: np.ndarray) -> np.ndarray:
        out = np.zeros(len(vm))
        if len(self.peso) == 0:
            return out
        de = self.ei - self.ej
        wj = np.exp(-beta * self.ej)
        p = self.peso / self.zeta
        m0 = beta * de > 1e-3
        out[0] = (p[m0] * 2.0 * wj[m0] * (1.0 - np.exp(-beta * de[m0]))
                  / de[m0]).sum()
        if len(vm) > 1:
            out[1:] = (p[None, :] * wj[None, :] * 2.0 * de[None, :]
                       / (vm[1:, None] ** 2 + de[None, :] ** 2)).sum(-1)
        return out

    def imtime(self, tau: np.ndarray) -> np.ndarray:
        if len(self.peso) == 0:
            return np.zeros(len(tau))
        p = self.peso / self.zeta
        return (p[None, :] * np.exp(-tau[:, None] * self.ei[None, :])
                * np.exp(-(self.beta - tau)[:, None] * self.ej[None, :])
                ).sum(-1)

    def realaxis(self, beta: float, wr: np.ndarray,
                 eps: float) -> np.ndarray:
        if len(self.peso) == 0:
            return np.zeros(len(wr), dtype=np.complex128)
        de = self.ei - self.ej
        p = self.peso / self.zeta
        fac = p * (np.exp(-beta * self.ei) - np.exp(-beta * self.ej))
        z = wr + 1j * eps
        return -(fac[None, :] / (z[:, None] + de[None, :])).sum(-1)


def _sector_eigsets(state_list: StateList):
    """Group a full-ED StateList into per-sector (E, V[dim, nst]) pairs."""
    groups: Dict = {}
    for st in state_list.states:
        groups.setdefault(st.qn, []).append(st)
    for qn, sts in groups.items():
        e = np.array([s.e for s in sts])
        v = np.stack([np.asarray(s.vec) for s in sts], axis=1)
        yield qn, e, v


def _full_pairs(cfg: EDConfig, state_list: StateList, matrices):
    """Lehmann pairs of the full spectrum: for every sector, the pairs
    (i, j) with w_i + w_j >= cutoff; ``matrices(qn, v)`` yields (key,
    <i|O|j> <i|O'|j> [nst, nst]). Returns ({key: PairChiPoles}, Z)."""
    e0 = state_list.emin
    beta = cfg.beta
    zeta = float(sum(np.exp(-beta * (s.e - e0)) for s in state_list.states))
    acc: Dict = {}
    for qn, e_abs, v in _sector_eigsets(state_list):
        e = e_abs - e0
        w = np.exp(-beta * e)
        keep = (w[:, None] + w[None, :]) >= cfg.cutoff     # [nst, nst]
        if not keep.any():
            continue
        ii, jj = np.nonzero(keep)
        for key, pes in matrices(qn, v):
            acc.setdefault(key, []).append((pes[ii, jj], e[ii], e[jj]))
    out = {}
    for key, parts in acc.items():
        pole = PairChiPoles(*(np.concatenate([p[k] for p in parts])
                              for k in range(3)), zeta)
        pole.beta = beta
        out[key] = pole
    return out, zeta


def _full_chi_diagop(cfg: EDConfig, table: SectorTable,
                     state_list: StateList, op_orb) -> ChiSet:
    """Full-ED chi for diagonal per-orbital operators: all (a, b) channels
    (computed directly, no recombination) plus the total channel."""
    def matrices(qn, v):
        sec = table.sector(qn)
        ops = [np.tile(np.asarray(op_orb(sec, a)).reshape(-1), sec.dim_ph)
               for a in range(cfg.norb)]
        ms = [v.T @ (d[:, None] * v) for d in ops]          # [nst, nst]
        for a in range(cfg.norb):
            for b in range(a, cfg.norb):
                yield (a, b), ms[a] * ms[b]
        if cfg.norb > 1:
            mt = sum(ms[1:], ms[0])
            yield (-1, -1), mt * mt

    chis, _ = _full_pairs(cfg, state_list, matrices)
    for key in list(chis):
        if key[0] >= 0 and key[0] != key[1]:
            chis[(key[1], key[0])] = chis[key]
    if cfg.norb == 1 and (0, 0) in chis:
        chis[(-1, -1)] = chis[(0, 0)]
    return chis


def full_build_chi_spin(cfg: EDConfig, table: SectorTable,
                        state_list: StateList) -> ChiSet:
    """Full-ED spin susceptibility (full_ed_build_spinChi_main)."""
    return _full_chi_diagop(cfg, table, state_list, _sz_op(cfg))


def full_build_chi_dens(cfg: EDConfig, table: SectorTable,
                        state_list: StateList) -> ChiSet:
    """Full-ED charge susceptibility (full_ed_build_densChi_main)."""
    return _full_chi_diagop(cfg, table, state_list, _n_op(cfg))


def full_build_gf_phonon(cfg: EDConfig, table: SectorTable,
                         state_list: StateList) -> PairChiPoles:
    """Full-ED displacement GF (full_ed_build_phononGF, ED_GF_PHONON.f90:
    188-248): <i|x|j> matrix elements with x = b + b^+ across phonon blocks;
    same sign conventions as the Lanczos ChiPoles result."""
    x = _x_matrix(cfg.dim_ph)

    def matrices(qn, v):
        sec = table.sector(qn)
        v3 = v.reshape(sec.dim_ph, sec.dim_dw * sec.dim_up, v.shape[1])
        xv = np.einsum("pq,qen->pen", x, v3).reshape(-1, v.shape[1])
        m = v.reshape(-1, v.shape[1]).T @ xv
        yield "x", m * m

    poles, zeta = _full_pairs(cfg, state_list, matrices)
    if "x" in poles:
        return poles["x"]
    return PairChiPoles(np.zeros(0), np.zeros(0), np.zeros(0), zeta,
                        beta=cfg.beta)
