"""Static observables and local energy.

Host numpy, copied from ``dmft_lanc_ed_tpu/observables.py`` (reference
ED_OBSERVABLES.f90 `observables_impurity`, `local_energy_impurity`):
thermal averages over the retained eigenstates. Every correlator is a
handful of dense contractions between |psi|^2-type densities and the
per-sector occupation tables. The port's eigenstates are host numpy
vectors already, so the phase touches no device.

Quantities (reference names in parentheses):
- dens/dens_up/dens_dw per orbital, docc, magnetization (ed_dens*, ed_docc,
  ed_mag), <Sz_a Sz_b> (sz2), <n_a n_b> (n2), total <S^2>/<N^2> analogues
- single-particle impurity density matrix <c^+_{a s} c_{b s}> (imp_dm)
- local energies: ed_Eknot, ed_Epot, ed_Ehartree, ed_Dust, ed_Dund, ed_Dse,
  ed_Dph (ED_OBSERVABLES.f90:381-570)
- quasiparticle weight zimp and scattering rate simp from Sigma(iw_1)
  (get_szr, ED_OBSERVABLES.f90:1001-1012)
- phonon occupation distribution (Nph_probability) when nph > 0
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import EDConfig
from .eigenspace import StateList
from .sectors import Sector, SectorTable, hop_entries, occupations

Array = np.ndarray


@dataclass
class Observables:
    dens: Array = None          # [norb]
    dens_up: Array = None
    dens_dw: Array = None
    docc: Array = None          # [norb]
    mag: Array = None           # [norb]
    sz2: Array = None           # [norb, norb]
    n2: Array = None            # [norb, norb]
    s2tot: float = 0.0
    egs: float = 0.0
    imp_dm: Array = None        # [nspin, norb, norb]
    # local energy decomposition
    eknot: float = 0.0
    epot: float = 0.0
    ehartree: float = 0.0
    eint: float = 0.0           # epot + ehartree
    dust: float = 0.0
    dund: float = 0.0
    dse: float = 0.0
    dph: float = 0.0
    # phonons
    ph_occ: Optional[Array] = None   # [dim_ph] occupation probability
    x_ph: float = 0.0                # <x> lattice displacement
    x2_ph: float = 0.0
    x_prob: Optional[Array] = None   # [lpos] displacement PDF (lattice_prob)
    x_grid: Optional[Array] = None
    occ_prob: Optional[Array] = None  # [3^norb] occupation configurations
    # Matsubara-derived
    zimp: Array = None          # [nspin, norb]
    simp: Array = None


def _host_vec(st) -> np.ndarray:
    """The state's f64 host vector, cached on the EigenState so the
    observables and local-energy sweeps share it."""
    v = getattr(st, "_vec_host", None)
    if v is None:
        v = np.asarray(st.vec, dtype=np.float64)
        st._vec_host = v
    return v


def _state_densities(cfg: EDConfig, sec: Sector, st):
    """Per-state building blocks (host): v [ph, dw, up], rho2 = v*v,
    occupation tables [dim, norb]."""
    v = _host_vec(st).reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
    rho2 = v * v
    occ_up = occupations(sec.states_up[0], cfg.ns).astype(np.float64)
    occ_dw = occupations(sec.states_dw[0], cfg.ns).astype(np.float64)
    return v, rho2, occ_up[:, :cfg.norb], occ_dw[:, :cfg.norb]


def observables_impurity(cfg: EDConfig, table: SectorTable,
                         state_list: StateList) -> Observables:
    norb = cfg.norb
    obs = Observables(
        dens=np.zeros(norb), dens_up=np.zeros(norb), dens_dw=np.zeros(norb),
        docc=np.zeros(norb), mag=np.zeros(norb),
        sz2=np.zeros((norb, norb)), n2=np.zeros((norb, norb)),
        imp_dm=np.zeros((cfg.nspin, norb, norb)),
        ph_occ=np.zeros(cfg.dim_ph) if cfg.dim_ph > 1 else None,
    )
    weights, zeta = state_list.boltzmann_weights(cfg.beta, cfg.finite_t)
    obs.egs = state_list.emin

    for w_s, st in zip(weights, state_list.states):
        peso = w_s / zeta
        sec = table.sector(st.qn)
        v, rho2, occ_up, occ_dw = _state_densities(cfg, sec, st)
        w_up = rho2.sum(axis=(0, 1))                    # [dim_up]
        w_dw = rho2.sum(axis=(0, 2))                    # [dim_dw]
        nu = w_up @ occ_up                              # <n_up,a>
        nd = w_dw @ occ_dw
        obs.dens_up += peso * nu
        obs.dens_dw += peso * nd
        obs.dens += peso * (nu + nd)
        obs.mag += peso * (nu - nd)
        # cross-spin <n_up,a n_dw,b>: rho2 contracted both ways
        w_el = rho2.sum(axis=0)                         # [dim_dw, dim_up]
        cross = occ_dw.T @ w_el @ occ_up                # [b(dw), a(up)]
        cross = cross.T                                 # -> [a(up), b(dw)]
        obs.docc += peso * np.diagonal(cross)
        # same-spin <n_a n_b> within one factor
        upup = (occ_up * w_up[:, None]).T @ occ_up
        dwdw = (occ_dw * w_dw[:, None]).T @ occ_dw
        n2 = upup + dwdw + cross + cross.T
        obs.n2 += peso * n2
        obs.sz2 += peso * 0.25 * (upup + dwdw - cross - cross.T)
        # single-particle density matrix
        obs.imp_dm += peso * _density_matrix(cfg, sec, v)
        # phonons
        if cfg.dim_ph > 1:
            obs.ph_occ += peso * rho2.sum(axis=(1, 2))
            rho_ph = np.einsum("pdu,qdu->pq", v, v)     # phonon dm
            obs.x_ph += peso * float(np.trace(rho_ph @ _x_matrix(cfg.dim_ph)))
            if obs.x_prob is None:
                obs.x_prob = np.zeros(cfg.lpos)
                obs.x_grid = np.linspace(cfg.xmin, cfg.xmax, cfg.lpos)
            obs.x_prob += peso * _displacement_pdf(rho_ph, obs.x_grid)
        # occupation-configuration probabilities (Occupation_prob.ed):
        # joint distribution over (empty/single/double) per orbital
        code = np.zeros((sec.dim_dw, sec.dim_up), dtype=np.int64)
        for a in range(norb):
            n_a = occ_up[None, :, a] + occ_dw[:, None, a]
            code += (3 ** a) * n_a.astype(np.int64)
        if obs.occ_prob is None:
            obs.occ_prob = np.zeros(3 ** norb)
        obs.occ_prob += peso * np.bincount(code.reshape(-1),
                                           weights=w_el.reshape(-1),
                                           minlength=3 ** norb)

    obs.s2tot = float(obs.sz2.sum())
    if cfg.dim_ph > 1:
        nvec = np.arange(cfg.dim_ph)
        obs.x2_ph = float(((2 * nvec + 1) * obs.ph_occ).sum())
    return obs


def _x_matrix(dim_ph: int) -> Array:
    x = np.zeros((dim_ph, dim_ph))
    for p in range(dim_ph - 1):
        x[p, p + 1] = np.sqrt(p + 1.0)
        x[p + 1, p] = np.sqrt(p + 1.0)
    return x


def _hermite_functions(nmax: int, x: Array) -> Array:
    """Orthonormal harmonic-oscillator wavefunctions phi_n(x), n < nmax."""
    phi = np.zeros((nmax, len(x)))
    phi[0] = np.pi ** -0.25 * np.exp(-0.5 * x * x)
    if nmax > 1:
        phi[1] = np.sqrt(2.0) * x * phi[0]
    for n in range(2, nmax):
        phi[n] = (np.sqrt(2.0 / n) * x * phi[n - 1]
                  - np.sqrt((n - 1.0) / n) * phi[n - 2])
    return phi


def _displacement_pdf(rho_ph: Array, x: Array) -> Array:
    """P(x) = sum_pq rho_pq phi_p(x) phi_q(x) (lattice_prob.ed content)."""
    phi = _hermite_functions(rho_ph.shape[0], x)
    return np.einsum("pq,px,qx->x", rho_ph, phi, phi)


def _orbital_pairs(cfg: EDConfig):
    """The (a, b) of <c^+_a c_b> a sector can hold. In an orbital-resolved
    sector (ed_total_ud=F) each orbital's up and down counts are conserved,
    so <c^+_a c_b> is 0 for a != b: the hop's image lies outside the
    sector's composite basis, and only the diagonal is taken. (The JAX
    package searches the image in that basis and fails with an IndexError,
    ROADMAP C12.)"""
    norb = cfg.norb
    if not cfg.ed_total_ud:
        return [(a, a) for a in range(norb)]
    return [(a, b) for a in range(norb) for b in range(norb)]


def _density_matrix(cfg: EDConfig, sec: Sector, v: np.ndarray) -> Array:
    """<c^+_{a s} c_{b s}> (single_particle_density_matrix), host gathers."""
    norb = cfg.norb
    dm = np.zeros((cfg.nspin, norb, norb))
    for s in range(cfg.nspin):
        states = sec.states_up[0] if s == 0 else sec.states_dw[0]
        for a, b in _orbital_pairs(cfg):
            rows, cols, vals = hop_entries(states, a, b, 1.0)
            if len(rows) == 0:
                continue
            if s == 0:
                dm[s, a, b] += float(np.sum(
                    v[:, :, rows] * vals[None, None, :] * v[:, :, cols]))
            else:
                dm[s, a, b] += float(np.sum(
                    v[:, rows, :] * vals[None, :, None] * v[:, cols, :]))
    return dm


def local_energy_impurity(cfg: EDConfig, table: SectorTable,
                          state_list: StateList, hloc: np.ndarray,
                          obs: Observables) -> None:
    """Fill the energy fields of `obs` (local_energy_impurity)."""
    norb = cfg.norb
    uloc = np.array(cfg.uloc[:norb])
    weights, zeta = state_list.boltzmann_weights(cfg.beta, cfg.finite_t)
    eknot = epot = ehartree = dust = dund = dse = dph = 0.0
    sdw = cfg.nspin - 1

    for w_s, st in zip(weights, state_list.states):
        peso = w_s / zeta
        sec = table.sector(st.qn)
        v, rho2, occ_up, occ_dw = _state_densities(cfg, sec, st)
        w_up = rho2.sum(axis=(0, 1))
        w_dw = rho2.sum(axis=(0, 2))
        nu = w_up @ occ_up
        nd = w_dw @ occ_dw
        # Eknot: impurity local hamiltonian (diag + offdiag hops)
        eknot += peso * float(np.diagonal(hloc[0, 0]) @ nu
                              + np.diagonal(hloc[sdw, sdw]) @ nd)
        dm = _density_matrix(cfg, sec, v)
        for s in range(cfg.nspin):
            off = hloc[s, s] - np.diag(np.diagonal(hloc[s, s]))
            eknot += peso * float((off * dm[s]).sum())
        if cfg.nspin == 1:
            # dm holds only the up-spin block when nspin==1; the dw-spin
            # off-diagonal hop expectation must be added explicitly
            off = hloc[0, 0] - np.diag(np.diagonal(hloc[0, 0]))
            dm_dw = _density_matrix_dw_only(cfg, sec, v)
            eknot += peso * float((off * dm_dw).sum())
        # interaction expectations
        w_el = rho2.sum(axis=0)
        cross = (occ_dw.T @ w_el @ occ_up).T            # [a(up), b(dw)]
        docc = np.diagonal(cross)
        epot += peso * float(uloc @ docc)
        if norb > 1:
            upup = (occ_up * w_up[:, None]).T @ occ_up
            dwdw = (occ_dw * w_dw[:, None]).T @ occ_dw
            x_ust = x_und = 0.0
            for a in range(norb):
                for b in range(a + 1, norb):
                    x_ust += cross[a, b] + cross[b, a]
                    x_und += upup[a, b] + dwdw[a, b]
            epot += peso * (cfg.ust * x_ust + (cfg.ust - cfg.jh) * x_und)
            dust += peso * x_ust
            dund += peso * x_und
            # S-E / P-H expectations via the nd tensor-product terms
            if cfg.jx != 0.0 or cfg.jp != 0.0:
                se, ph = _exchange_expectations(cfg, sec, v)
                epot += peso * (cfg.jx * se + cfg.jp * ph)
                dse += peso * se
                dph += peso * ph
        if cfg.hfmode:
            ehartree += peso * float(-0.5 * uloc @ (nu + nd)
                                     + 0.25 * uloc.sum())
            if norb > 1:
                ntot = nu + nd
                for a in range(norb):
                    for b in range(a + 1, norb):
                        ehartree += peso * (
                            -0.5 * (2 * cfg.ust - cfg.jh)
                            * (ntot[a] + ntot[b])
                            + 0.25 * (2 * cfg.ust - cfg.jh))
    obs.eknot, obs.epot, obs.ehartree = eknot, epot, ehartree
    obs.dust, obs.dund, obs.dse, obs.dph = dust, dund, dse, dph
    obs.eint = epot + ehartree


def _density_matrix_dw_only(cfg, sec, v) -> Array:
    norb = cfg.norb
    dm = np.zeros((norb, norb))
    states = sec.states_dw[0]
    for a, b in _orbital_pairs(cfg):
        rows, cols, vals = hop_entries(states, a, b, 1.0)
        if len(rows) == 0:
            continue
        dm[a, b] += float(np.sum(
            v[:, rows, :] * vals[None, :, None] * v[:, cols, :]))
    return dm


def _exchange_expectations(cfg: EDConfig, sec: Sector, v: np.ndarray):
    """<S-E> and <P-H> operator expectations with unit amplitude."""
    from .sectors import hop_entries as he
    up, dw = sec.states_up[0], sec.states_dw[0]
    se = ph = 0.0

    def term(amp_up, amp_dw):
        # expectation of (A_up (x) B_dw): sum over entries
        (ru, cu, vu) = amp_up
        (rd, cd, vd) = amp_dw
        if len(ru) == 0 or len(rd) == 0:
            return 0.0
        # <psi| A(x)B |psi> = sum_{eu, ed} vu ve psi[rd, ru] psi[cd, cu]
        left = v[:, rd, :][:, :, ru]
        right = v[:, cd, :][:, :, cu]
        w = vd[None, :, None] * vu[None, None, :]
        return float(np.sum(left * right * w))

    for a in range(cfg.norb):
        for b in range(cfg.norb):
            if a == b:
                continue
            se += term(he(up, a, b, 1.0), he(dw, b, a, 1.0))
            ph += term(he(up, a, b, 1.0), he(dw, a, b, 1.0))
    return se, ph


def zimp_simp(cfg: EDConfig, sigma_mats: np.ndarray, wm: np.ndarray):
    """Quasiparticle weight + scattering rate from Sigma(iw_1) (get_szr)."""
    zimp = np.zeros((cfg.nspin, cfg.norb))
    simp = np.zeros((cfg.nspin, cfg.norb))
    for s in range(cfg.nspin):
        for a in range(cfg.norb):
            zimp[s, a] = 1.0 / (1.0 + abs(
                sigma_mats[s, s, a, a, 0].imag / wm[0]))
            simp[s, a] = sigma_mats[s, s, a, a, 0].imag
    return zimp, simp
