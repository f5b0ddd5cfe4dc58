"""File I/O — reference-format .ed output and restart files (port of
``dmft_lanc_ed_tpu/io.py``).

Re-design of ED_IO.f90 + the writer subroutines scattered through
ED_OBSERVABLES/ED_DIAG/ED_BATH: same file names, column layouts, number
formats and `.restart`/`.used` conventions as the JAX package, so the same
arrays give byte-identical files and post-processing tooling written for
the reference keeps working. GF/Sigma files use the SciFortran `splot`
column order (w, Im f, Re f). Everything here is host numpy.

Writers (reference source):
- observables_{info,all,last}[suffix].ed (ED_OBSERVABLES.f90:1019-1144)
- energy_{info,last}.ed                  (write_energy_info / write_energy)
- parameters_last.ed
- imp{Sigma,G,G0}_l<a><b>_s<s>_{iw,realw}.ed (ED_IO.f90:255-489)
- spinChi/densChi_l<ab>_{iv,tau,realw}.ed, impDph_{iv,realw}.ed: written
  from any object with the susceptibility methods (``matsubara``,
  ``imtime``, ``realaxis``: ``chi.ChiPoles``, ``chi.PairChiPoles``);
  ``write_all`` writes them for a result that carries them
  (``chispin_flag``, ``chidens_flag``, phonons)
- hamiltonian.{used,restart}             (ED_BATH/dmft_aux.f90:220-331)
- state_list.ed / sectors_list.restart   (ED_DIAG.f90:484-526)
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .bath import Bath, pack_bath, unpack_bath
from .config import EDConfig
from .diag import DiagState
from .eigenspace import StateList
from .observables import Observables
from .sectors import SectorTable
from .solver import (SolveResult, bosonic_grid, matsubara_grid, real_grid,
                     tau_grid)


def _splot(path: str, x: np.ndarray, f: np.ndarray) -> None:
    """SciFortran splot format: w, Im f, Re f (complex) or w, f (real)."""
    with open(path, "w") as fh:
        if np.iscomplexobj(f):
            for xi, fi in zip(x, f):
                fh.write(f"{xi:.9f}   {fi.imag:.9f}   {fi.real:.9f}\n")
        else:
            for xi, fi in zip(x, f):
                fh.write(f"{xi:.9f}   {fi:.9f}\n")


def print_impsigma(cfg: EDConfig, res: SolveResult, outdir: str = ".",
                   suffix: str = "") -> None:
    _print_gf_files(cfg, res.sigma_mats, res.sigma_real, "impSigma",
                    outdir, suffix)


def print_impg(cfg: EDConfig, res: SolveResult, outdir: str = ".",
               suffix: str = "") -> None:
    _print_gf_files(cfg, res.g_mats, res.g_real, "impG", outdir, suffix)


def print_impg0(cfg: EDConfig, res: SolveResult, outdir: str = ".",
                suffix: str = "") -> None:
    _print_gf_files(cfg, res.g0_mats, res.g0_real, "impG0", outdir, suffix)


def _print_gf_files(cfg, fmats, freal, prefix, outdir, suffix):
    wm = matsubara_grid(cfg)
    wr = real_grid(cfg)
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    for s in range(cfg.nspin):
        for a in range(cfg.norb):
            for b in range(cfg.norb):
                if a != b and not offdiag:
                    continue
                name = f"{prefix}_l{a + 1}{b + 1}_s{s + 1}"
                _splot(os.path.join(outdir, f"{name}_iw{suffix}.ed"),
                       wm, fmats[s, s, a, b])
                _splot(os.path.join(outdir, f"{name}_realw{suffix}.ed"),
                       wr, freal[s, s, a, b])


def print_chi(cfg: EDConfig, chis: Dict, kind: str, outdir: str = ".",
              suffix: str = "") -> None:
    """spinChi/densChi files on iv, tau, realw grids (ED_IO print_chi)."""
    vm = bosonic_grid(cfg)
    tau = tau_grid(cfg)
    wr = real_grid(cfg)
    for (a, b), chi in chis.items():
        lbl = "tot" if a < 0 else f"{a + 1}{b + 1}"
        name = f"{kind}Chi_l{lbl}"
        _splot(os.path.join(outdir, f"{name}_iv{suffix}.ed"),
               vm, chi.matsubara(cfg.beta, vm))
        _splot(os.path.join(outdir, f"{name}_tau{suffix}.ed"),
               tau, chi.imtime(tau))
        _splot(os.path.join(outdir, f"{name}_realw{suffix}.ed"),
               wr, chi.realaxis(cfg.beta, wr, cfg.eps))


def print_impd(cfg: EDConfig, dph, outdir: str = ".", suffix: str = "") -> None:
    """Phonon displacement GF files impDph (sign conventions of
    add_to_lanczos_phonon)."""
    vm = bosonic_grid(cfg)
    wr = real_grid(cfg)
    _splot(os.path.join(outdir, f"impDph_iv{suffix}.ed"),
           vm, -dph.matsubara(cfg.beta, vm))
    _splot(os.path.join(outdir, f"impDph_realw{suffix}.ed"),
           wr, -dph.realaxis(cfg.beta, wr, cfg.eps))


def write_observables(cfg: EDConfig, obs: Observables, outdir: str = ".",
                      suffix: str = "") -> None:
    """observables_{info,all,last}.ed with the reference column layout."""
    norb, nspin = cfg.norb, cfg.nspin
    info = ["#"]
    col = 0
    def push(name):
        nonlocal col
        col += 1
        info.append(f"{col}{name}")
    for a in range(norb):
        push(f"dens_{a + 1}")
    for a in range(norb):
        push(f"docc_{a + 1}")
    for a in range(norb):
        push(f"nup_{a + 1}")
    for a in range(norb):
        push(f"ndw_{a + 1}")
    for a in range(norb):
        push(f"mag_{a + 1}")
    push("s2")
    push("egs")
    for a in range(norb):
        for b in range(norb):
            push(f"sz2_{a + 1}{b + 1}")
    for a in range(norb):
        for b in range(norb):
            push(f"n2_{a + 1}{b + 1}")
    for s in range(nspin):
        for a in range(norb):
            push(f"z_{a + 1}s{s + 1}")
    for s in range(nspin):
        for a in range(norb):
            push(f"sig_{a + 1}s{s + 1}")
    push("nph")
    push("w_ph")
    with open(os.path.join(outdir, "observables_info.ed"), "w") as fh:
        fh.write(("{:>16s}" * len(info)).format(*info).strip() + "\n")

    nph_mean = 0.0
    if obs.ph_occ is not None:
        nph_mean = float((np.arange(cfg.dim_ph) * obs.ph_occ).sum())
    row = np.concatenate([
        obs.dens, obs.docc, obs.dens_up, obs.dens_dw, obs.mag,
        [obs.s2tot, obs.egs], obs.sz2.reshape(-1), obs.n2.reshape(-1),
        obs.zimp.reshape(-1) if obs.zimp is not None else np.zeros(nspin * norb),
        obs.simp.reshape(-1) if obs.simp is not None else np.zeros(nspin * norb),
        [nph_mean, cfg.w0_ph]])
    line = " ".join(f"{x:15.9f}" for x in row) + "\n"
    with open(os.path.join(outdir, f"observables_last{suffix}.ed"), "w") as fh:
        fh.write(line)
    with open(os.path.join(outdir, f"observables_all{suffix}.ed"), "a") as fh:
        fh.write(line)
    with open(os.path.join(outdir, f"parameters_last{suffix}.ed"), "w") as fh:
        vals = [cfg.xmu, cfg.beta, *cfg.uloc[:norb], cfg.ust, cfg.jh,
                cfg.jx, cfg.jp]
        fh.write(" ".join(f"{x:15.9f}" for x in vals) + "\n")


def write_energy(cfg: EDConfig, obs: Observables, outdir: str = ".",
                 suffix: str = "") -> None:
    """energy_{info,last}.ed (reference <Hi>, <V>, <Eloc>, <Ehf>, <Dst>, <Dnd>)."""
    with open(os.path.join(outdir, "energy_info.ed"), "w") as fh:
        fh.write("# 1<Hi> 2<V>=<Hi-Ehf> 3<Eloc> 4<Ehf> 5<Dst> 6<Dnd>\n")
    vals = [obs.epot + obs.ehartree, obs.epot, obs.eknot, obs.ehartree,
            obs.dust, obs.dund]
    with open(os.path.join(outdir, f"energy_last{suffix}.ed"), "w") as fh:
        fh.write(" ".join(f"{x:15.9f}" for x in vals) + "\n")


def save_bath(cfg: EDConfig, bath_array: np.ndarray, outdir: str = ".",
              suffix: str = "", used: bool = False) -> None:
    """hamiltonian.restart / .used in the reference column layout
    (write_dmft_bath: rows = bath index, cols = (e, v) per (orb, spin))."""
    ext = ".used" if used else ".restart"
    path = os.path.join(outdir, cfg.hfile + suffix + ext)
    bath = unpack_bath(cfg, bath_array)
    with open(path, "w") as fh:
        if cfg.bath_type in ("normal", "hybrid"):
            e = np.asarray(bath.e)
            v = np.asarray(bath.v)
            hdr = []
            for s in range(cfg.nspin):
                if cfg.bath_type == "normal":
                    for a in range(cfg.norb):
                        hdr += [f"#Ek_l{a + 1}_s{s + 1}", f"Vk_l{a + 1}_s{s + 1}"]
                else:
                    hdr += [f"#Ek_s{s + 1}"] + \
                        [f"Vk_l{a + 1}_s{s + 1}" for a in range(cfg.norb)]
            fh.write(" ".join(f"{h:>21s}" for h in hdr) + "\n")
            for k in range(cfg.nbath):
                row = []
                for s in range(cfg.nspin):
                    if cfg.bath_type == "normal":
                        for a in range(cfg.norb):
                            row += [e[s, a, k], v[s, a, k]]
                    else:
                        row += [e[s, 0, k]] + [v[s, a, k]
                                               for a in range(cfg.norb)]
                fh.write(" ".join(f"{x:21.12f}" for x in row) + "\n")
        else:
            lam = np.asarray(bath.lam)
            v = np.asarray(bath.v_rep)
            for _ in range(cfg.nbath):
                fh.write(f"{lam.shape[1]:3d}\n")
            for p in range(cfg.nbath):
                for s in range(cfg.nspin):
                    fh.write(f"{v[p, s]:21.12f}\n")
                fh.write(" ".join(f"{x:21.12f}" for x in lam[p]) + "\n")


def read_bath_restart(cfg: EDConfig, outdir: str = ".", suffix: str = ""
                      ) -> Optional[np.ndarray]:
    """Read hamiltonian.restart if present (init_dmft_bath read branch)."""
    path = os.path.join(outdir, cfg.hfile + suffix + ".restart")
    if not os.path.exists(path):
        return None
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()])
    if cfg.bath_type in ("normal", "hybrid"):
        norb_e = cfg.norb if cfg.bath_type == "normal" else 1
        e = np.zeros((cfg.nspin, norb_e, cfg.nbath))
        v = np.zeros((cfg.nspin, cfg.norb, cfg.nbath))
        for k, row in enumerate(rows[:cfg.nbath]):
            i = 0
            for s in range(cfg.nspin):
                if cfg.bath_type == "normal":
                    for a in range(cfg.norb):
                        e[s, a, k] = row[i]
                        v[s, a, k] = row[i + 1]
                        i += 2
                else:
                    e[s, 0, k] = row[i]
                    i += 1
                    for a in range(cfg.norb):
                        v[s, a, k] = row[i]
                        i += 1
        return pack_bath(cfg, Bath(e=e, v=v))
    # replica: Nsym header (one line per replica), then per replica p:
    # Nspin hybridization lines + one lambda row, the exact inverse of
    # save_bath's replica branch (read_dmft_bath, ED_BATH/dmft_aux.f90:159-210)
    nsym = int(rows[0][0])
    lam = np.zeros((cfg.nbath, nsym))
    v = np.zeros((cfg.nbath, cfg.nspin))
    idx = cfg.nbath
    for p in range(cfg.nbath):
        for s in range(cfg.nspin):
            v[p, s] = rows[idx][0]
            idx += 1
        lam[p] = rows[idx][:nsym]
        idx += 1
    return pack_bath(cfg, Bath(lam=lam, v_rep=v))


def write_occupation_prob(cfg: EDConfig, obs: Observables, outdir: str = ".",
                          suffix: str = "") -> None:
    """Occupation_prob.ed (3^Norb configuration table), Nph_probability.ed,
    lattice_prob.ed (ED_OBSERVABLES.f90:1019-1144)."""
    if obs.occ_prob is not None:
        with open(os.path.join(outdir, f"Occupation_prob{suffix}.ed"),
                  "w") as fh:
            for code, p in enumerate(obs.occ_prob):
                cfgs = []
                c = code
                for _ in range(cfg.norb):
                    cfgs.append(str(c % 3))
                    c //= 3
                fh.write(f"{''.join(cfgs):>6s} {p:15.9f}\n")
    if obs.ph_occ is not None:
        with open(os.path.join(outdir, f"Nph_probability{suffix}.ed"),
                  "w") as fh:
            fh.write(" ".join(f"{p:15.9f}" for p in obs.ph_occ) + "\n")
    if obs.x_prob is not None:
        _splot(os.path.join(outdir, f"lattice_prob{suffix}.ed"),
               obs.x_grid, obs.x_prob)


def read_state_list_restart(cfg: EDConfig, outdir: str = ".",
                            suffix: str = ""):
    """Re-seed the diagonalization control state from state_list.restart
    (setup_global restart branch, ED_SETUP.f90:319-345). Returns a
    DiagState or None."""
    path = os.path.join(outdir, f"state_list{suffix}.restart")
    if not os.path.exists(path):
        path = os.path.join(outdir, f"state_list{suffix}.ed")
        if not os.path.exists(path):
            return None
    counts = {}
    n = 0
    with open(path) as fh:
        for line in fh:
            parts = line.replace("[", " ").replace("]", " ").split()
            if len(parts) < 3:
                continue
            n += 1
            nups = tuple(int(x) for x in parts[3:3 + cfg.ns_ud])
            ndws = tuple(int(x) for x in parts[3 + cfg.ns_ud:3 + 2 * cfg.ns_ud])
            qn_i = (nups, ndws)
            counts[qn_i] = counts.get(qn_i, 0) + 1
    if n == 0:
        return None
    ctl = DiagState(lanc_nstates_total=max(n, 1))
    for qn_i, c in counts.items():
        ctl.neigen_sector[qn_i] = max(1, c)
    ctl.sector_hint = list(counts)
    return ctl


def write_state_list(cfg: EDConfig, state_list: StateList, outdir: str = ".",
                     suffix: str = "") -> None:
    """state_list.ed + sectors_list.restart (ed_post_diag outputs)."""
    with open(os.path.join(outdir, f"state_list{suffix}.ed"), "w") as fh:
        e0 = state_list.emin
        for i, st in enumerate(state_list.states):
            nups = " ".join(str(n) for n in st.qn[0])
            ndws = " ".join(str(n) for n in st.qn[1])
            fh.write(f"{i + 1:6d} {st.e:20.12f} {st.e - e0:20.12f} "
                     f"[{nups}] [{ndws}]\n")
    with open(os.path.join(outdir, "sectors_list.restart"), "w") as fh:
        for sqn in state_list.sectors_contributing():
            fh.write(" ".join(str(n) for n in (*sqn[0], *sqn[1])) + "\n")


def write_eigenvalues_list(cfg: EDConfig, state_list: StateList,
                           table, outdir: str = ".",
                           suffix: str = "") -> None:
    """eigenvalues_list.ed: per-sector header + eigenvalues, appended in
    scan order (print_eigenvalues_list, ED_DIAG.f90:265-270,641-663).
    Header marker: '#' Lanczos, '#X' dense (the reference's lanc/allt flags)."""
    qns = table.all_qns()
    index = {qn: i + 1 for i, qn in enumerate(qns)}
    path = os.path.join(outdir, f"eigenvalues_list{suffix}.ed")
    with open(path, "a") as fh:
        for sqn, evals, lanc in state_list.diag_log:
            tag = " # Sector" if lanc else " #X Sector"
            fh.write(f"{tag}        Indices\n")
            inds = " ".join(f"{n:5d}" for n in (*sqn[0], *sqn[1]))
            fh.write(f"{index.get(sqn, 0):9d} {inds}\n")
            for e in evals:
                fh.write(f"   {e:.16g}\n")
            fh.write("\n")


def write_histogram_states(cfg: EDConfig, state_list: StateList, table,
                           outdir: str = ".", suffix: str = "") -> None:
    """histogram_states.ed: finite-T histogram of which sectors contribute
    to the spectrum (ED_DIAG.f90:530-546; SF_STAT histogram_print format:
    'bin_lower bin_upper count' per sector bin)."""
    qns = table.all_qns()
    index = {qn: i + 1 for i, qn in enumerate(qns)}
    counts = np.zeros(len(qns))
    for st in state_list.states:
        i = index.get(st.qn)
        if i is not None:
            counts[i - 1] += 1.0
    path = os.path.join(outdir, f"histogram_states{suffix}.ed")
    with open(path, "a") as fh:
        for i, c in enumerate(counts):
            fh.write(f"{i + 1:.6f} {i + 2:.6f} {c:.6f}\n")
        fh.write("\n")


def write_all(cfg: EDConfig, res: SolveResult, bath_array: np.ndarray,
              outdir: str = ".", suffix: str = "") -> None:
    """Everything the reference writes after ed_solve (flag-gated)."""
    os.makedirs(outdir, exist_ok=True)
    if cfg.ed_print_sigma:
        print_impsigma(cfg, res, outdir, suffix)
    if cfg.ed_print_g:
        print_impg(cfg, res, outdir, suffix)
    if cfg.ed_print_g0:
        print_impg0(cfg, res, outdir, suffix)
    write_observables(cfg, res.observables, outdir, suffix)
    write_energy(cfg, res.observables, outdir, suffix)
    write_occupation_prob(cfg, res.observables, outdir, suffix)
    write_state_list(cfg, res.state_list, outdir, suffix)
    table = SectorTable(cfg)
    if res.state_list.diag_log:
        write_eigenvalues_list(cfg, res.state_list, table, outdir, suffix)
    if cfg.finite_t:
        write_histogram_states(cfg, res.state_list, table, outdir, suffix)
    save_bath(cfg, bath_array, outdir, suffix, used=True)
    save_bath(cfg, bath_array, outdir, suffix, used=False)
    if res.chi_spin is not None:
        print_chi(cfg, res.chi_spin, "spin", outdir, suffix)
    if res.chi_dens is not None:
        print_chi(cfg, res.chi_dens, "dens", outdir, suffix)
    if res.gf_phonon is not None:
        print_impd(cfg, res.gf_phonon, outdir, suffix)


def read_gf_files(cfg: EDConfig, prefix: str = "impSigma", outdir: str = ".",
                  suffix: str = "", axis: str = "iw") -> np.ndarray:
    """Read back imp{Sigma,G,G0} .ed files (ed_read_impSigma_single,
    ED_IO.f90:500-595). Returns [nspin,nspin,norb,norb,L] complex."""
    L = cfg.lmats if axis == "iw" else cfg.lreal
    out = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb, L),
                   dtype=np.complex128)
    offdiag = cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal"
    for s in range(cfg.nspin):
        for a in range(cfg.norb):
            for b in range(cfg.norb):
                if a != b and not offdiag:
                    continue
                path = os.path.join(
                    outdir, f"{prefix}_l{a + 1}{b + 1}_s{s + 1}"
                    f"_{axis}{suffix}.ed")
                if not os.path.exists(path):
                    continue
                data = np.loadtxt(path)
                n = min(L, data.shape[0])
                out[s, s, a, b, :n] = data[:n, 2] + 1j * data[:n, 1]
    return out
