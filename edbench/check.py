"""Whether what the timed path produced is correct: the plain reference
redoes a sampled iteration from the bath that iteration took, and each
number below is held to the cell's limit (``limits/<cell>.json``).

- ``scan``: sectors scanned by one side only, plus ground-state sectors
  found by one side only (exact: limit 0);
- ``dE``: the widest gap between the two sides' lowest energy of a
  scanned sector;
- ``dG``, ``dSigma``, ``dWeiss``: max |program - reference| over the
  Matsubara grid and the orbitals, over max |reference|, of G(iw),
  Sigma(iw) and the Weiss field;
- ``dFit``: how far the chi2 that the fitted bath reaches on the
  program's Weiss field lies from the chi2 of the reference's own fit
  from the same bath: |chi2(fitted) - chi2(reference fit)| / (1 +
  chi2(reference fit)), widest over the orbitals (the fit is checked by
  itself, on the target the program gave it). Both sides run one
  algorithm from one start to one stopping rule and land on one chi2;
  a fit in lower precision, stopped elsewhere or not run lands off it on
  either side (PERF.md). The fitted parameters themselves are not
  compared: along the chi2's flat directions the fit's path moves by
  ~1e-6 to 1e-5 on rounding alone (PERF.md);
- ``dMix``: the widest gap between the bath handed on and the reference's
  mixing of the fitted bath with the bath taken (exact: limit 0).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .reference import iteration as ref


def problem(config: Dict, traffic: Dict, rec: Dict) -> ref.Problem:
    """The reference's problem for one recorded iteration: the cell's
    model and the bath, scan and mixing state that iteration started
    from."""
    ed = dict(config["ed"])
    ed.update(traffic.get("ed", {}))
    model = config["model"]
    norb, nbath = ed["norb"], ed["nbath"]
    ns = norb * (nbath + 1)
    cf = model.get("crystal_field", [0.0] * norb)
    return ref.Problem(
        model=dict(norb=norb, nbath=nbath, uloc=tuple(ed["uloc"][:norb]),
                   ust=ed.get("ust", 0.0), jh=ed.get("jh", 0.0),
                   xmu=ed.get("xmu", 0.0), hloc=tuple(cf)),
        bath=np.asarray(rec["bath_in"], np.float64),
        sectors=ref.scan_sectors(ns, rec["hint"]),
        beta=ed["beta"], lmats=ed["lmats"], lfit=min(ed["lfit"], ed["lmats"]),
        gf_steps=ed.get("lanc_ngfiter", 200),
        gs_threshold=ed.get("gs_threshold", 1e-9), wband=model["wband"],
        n_energies=model["n_energies"], wmixing=model["wmixing"],
        cg_ftol=ed.get("cg_ftol", 1e-5), cg_niter=ed.get("cg_niter", 500))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _fit_gap(p: ref.Problem, target, fitted: np.ndarray,
                want: np.ndarray) -> float:
    """Widest over the orbitals of |chi2(fitted) - chi2(want)| /
    (1 + chi2(want)), each chi2 of one orbital's bath against target."""
    m = ref.model_of(p)
    got = ref.dmft.unpack_normal(fitted, m.norb, m.nbath)
    ref_ = ref.dmft.unpack_normal(want, m.norb, m.nbath)
    out = []
    for a in range(m.norb):
        f = [ref.dmft.chi2(target[a], b["e"][a], b["v"][a], p.beta, p.lfit,
                           m.xmu, m.hloc[a]) for b in (got, ref_)]
        out.append(abs(f[0] - f[1]) / (1.0 + f[1]))
    return float(max(out))


def numbers(got: Dict, want: ref.Solved, fit_gap: float,
            mixed: np.ndarray) -> Dict[str, float]:
    """The compared numbers of one iteration: `got` is the program's
    record (or the control's, in its place), `want` the reference's solve
    of the same bath, `fit_gap` the fit's number, `mixed` the
    reference's mixing of the fitted bath `got` handed to the mixer."""
    ps, rs = set(got["sectors"]), set(want.energies)
    scan = len(ps ^ rs) + len(set(got["ground"]) ^ set(want.ground))
    common = ps & rs
    de = max((abs(got["sectors"][s] - want.energies[s]) for s in common),
             default=float("inf"))
    out = dict(
        scan=float(scan), dE=float(de), dG=_rel(got["g"], want.g),
        dSigma=_rel(got["sigma"], want.sigma),
        dWeiss=_rel(got["weiss"], want.weiss),
        dMix=float(np.abs(got["bath_out"] - mixed).max()),
        dFit=fit_gap)
    return out


def check_record(config: Dict, traffic: Dict, rec: Dict, seed: int,
                 workers: int = 0, log=None) -> Dict[str, float]:
    """The reference's numbers for one program iteration."""
    p = problem(config, traffic, rec)
    want = ref.solve_iteration(p, seed, np.float64, workers)
    if log is not None:
        log(f"reference: {len(p.sectors)} sectors, ground {want.ground}; "
            f"task seconds {want.seconds}")
    prev = None if rec["first_mix"] else rec["bath_in"]
    target = np.asarray(rec["weiss"])
    fitted, _ = ref.fit_and_mix(p, target, prev)
    return numbers(rec, want, _fit_gap(p, target, rec["fitted"], fitted),
                   ref.dmft.mix(rec["fitted"], prev, p.wmixing))


def control_record(config: Dict, traffic: Dict, rec: Dict, seed: int,
                   dtype=np.float32, workers: int = 0
                   ) -> Dict[str, float]:
    """The control: the reference in `dtype`, put in the program's place
    for the iteration `rec` started, judged as the program is."""
    p = problem(config, traffic, rec)
    want = ref.solve_iteration(p, seed, np.float64, workers)
    low = ref.solve_iteration(p, seed + 1, dtype, workers)
    prev = None if rec["first_mix"] else rec["bath_in"]
    lfit, lmix = ref.fit_and_mix(p, low.weiss, prev, dtype)
    target = low.weiss.astype(np.complex128)
    fitted, _ = ref.fit_and_mix(p, target, prev)
    mixed = ref.dmft.mix(lfit, prev, p.wmixing)
    got = dict(sectors=low.energies, ground=low.ground, g=low.g,
               sigma=low.sigma, weiss=low.weiss, fitted=lfit,
               bath_out=lmix)
    return numbers(got, want, _fit_gap(p, target, lfit, fitted), mixed)


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, list]:
    """{name: [value, limit, ok]}: a number passes at or under its limit;
    a number with no limit fails."""
    out = {}
    for name, v in values.items():
        lim: Optional[float] = limits.get(name)
        ok = lim is not None and np.isfinite(v) and v <= lim
        out[name] = [v, lim, bool(ok)]
    return out
