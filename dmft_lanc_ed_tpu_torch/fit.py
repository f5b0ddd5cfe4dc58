"""Chi^2 bath fitting (port of ``dmft_lanc_ed_tpu/fit.py``; reference
ED_FIT_CHI2.f90 + ED_FIT_CHI2/fitgf_*.f90).

The exact gradient of

    chi2(theta) = (1/Lfit) sum_n |F(iw_n) - F_And(iw_n; theta)|^cg_pow / W_n

comes from torch autograd on complex128 CPU tensors and feeds
``scipy.optimize.minimize`` with the reference's method and option mapping
(L-BFGS-B or CG, cg_grad, cg_stop/cg_ftol). The fit runs on the host
because the JAX package pins it there (``@on_host``): it is a few hundred
tiny evaluations, latency-bound. Weight W_n = 1, n, or w_n per cg_weight;
cg_scheme "delta" fits Delta(z), "weiss" fits G0and(z).

Fit granularity matches the reference dispatch (ED_FIT_CHI2.f90:88-99):
- normal : independent (spin, orbital) fits over (e_k, V_k)       [2 Nbath]
- hybrid : per-spin joint fit over (e_k, V_{a k})                 [(1+Norb) Nbath]
- replica: joint fit over (V_p, lambda_{p m}) with all orbital
  components entering chi2 (fitgf_replica)

The absolute value of the fitted V is taken after the minimization, as in
the reference. With ``outdir`` the fit writes the reference's diagnostic
files, in the JAX package's formats: the appended chi2fit_results records
and the per-channel fit_{weiss,delta} files (target beside fitted
function).
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import minimize as _scipy_minimize

from .bath import Bath, pack_bath, unpack_bath
from .bath_functions import delta_bath, g0and_bath
from .config import EDConfig
from .solver import matsubara_grid


def _cabs_pow(x: torch.Tensor, p: int) -> torch.Tensor:
    """|x|^p for complex x, differentiable at 0 for even p."""
    a2 = x.real ** 2 + x.imag ** 2
    return a2 if p == 2 else a2 ** (p / 2.0)


def _fit_weight(cfg: EDConfig, wm: np.ndarray) -> np.ndarray:
    if cfg.cg_weight == 2:
        return np.arange(1, len(wm) + 1, dtype=np.float64)
    if cfg.cg_weight == 3:
        return wm.copy()
    return np.ones(len(wm))


def chi2_normal(cfg: EDConfig, theta: torch.Tensor, z: torch.Tensor,
                target: torch.Tensor, wgt: torch.Tensor, h_aa: float
                ) -> torch.Tensor:
    """chi2 of one (spin, orbital) normal-bath fit; theta = [e_k, V_k]."""
    ek = theta[:cfg.nbath]
    vk = theta[cfg.nbath:]
    d = (vk[None, :] ** 2 / (z[:, None] - ek[None, :])).sum(-1)
    if cfg.cg_scheme == "weiss":
        d = 1.0 / (z + cfg.xmu - h_aa - d)
    r = _cabs_pow(target - d, cfg.cg_pow)
    return (r / wgt).sum() / z.shape[0]


def chi2_hybrid(cfg: EDConfig, theta: torch.Tensor, z: torch.Tensor,
                target: torch.Tensor, wgt: torch.Tensor, h_ss
                ) -> torch.Tensor:
    """chi2 of one spin's joint hybrid-bath fit; theta = [e_k, V_ak
    (orbital-major)], target [norb, norb, L], h_ss that spin's Hloc block;
    the Weiss scheme inverts G0^-1 per frequency."""
    nb, no = cfg.nbath, cfg.norb
    ek = theta[:nb]
    vk = theta[nb:].reshape(no, nb).to(torch.complex128)
    inv = 1.0 / (z[:, None] - ek[None, :])                 # [L, nb]
    d = torch.einsum("ak,bk,lk->abl", vk, vk, inv)
    if cfg.cg_scheme == "weiss":
        eye = torch.eye(no, dtype=torch.complex128)
        h = torch.as_tensor(h_ss, dtype=torch.complex128)
        ig0 = (z + cfg.xmu)[None, None, :] * eye[:, :, None] \
            - h[:, :, None] - d
        d = torch.linalg.inv(ig0.permute(2, 0, 1)).permute(1, 2, 0)
    r = _cabs_pow(target - d, cfg.cg_pow)
    return (r / wgt[None, None, :]).sum() / z.shape[0]


def chi2_replica(cfg: EDConfig, theta: torch.Tensor, z: torch.Tensor,
                 target: torch.Tensor, wgt: torch.Tensor, hloc, h_basis
                 ) -> torch.Tensor:
    """chi2 of the joint replica-bath fit; theta = [V_p,s (bath-major),
    lambda_p,m (bath-major)], target [nspin, nspin, norb, norb, L], every
    component entering."""
    nb, nspin = cfg.nbath, cfg.nspin
    nsym = np.asarray(h_basis).shape[0]
    bath = Bath(v_rep=theta[:nb * nspin].reshape(nb, nspin),
                lam=theta[nb * nspin:].reshape(nb, nsym))
    if cfg.cg_scheme == "delta":
        d = delta_bath(cfg, bath, z, h_basis)
    else:
        d = g0and_bath(cfg, hloc, bath, z, h_basis)
    r = _cabs_pow(target - d, cfg.cg_pow)
    return (r / wgt).sum() / z.shape[0]


def chi2_fitgf(cfg: EDConfig, target: np.ndarray, bath_array: np.ndarray,
               hloc: np.ndarray, ispin: Optional[int] = None,
               h_basis: Optional[np.ndarray] = None,
               outdir: Optional[str] = None, suffix: str = "") -> np.ndarray:
    """Fit the bath to the Weiss field / hybridization (ed_chi2_fitgf).

    target: [nspin, nspin, norb, norb, Lmats] on the fermionic Matsubara
    grid; h_basis: the replica bath's symmetry basis. Returns the updated
    packed bath array.

    When ``outdir`` is given, writes the reference's fit diagnostics:
    ``chi2fit_results*<suffix>.ed`` (appended chi^2 | iterations per fit,
    fitgf_normal_normal.f90:147-152) and ``fit_{weiss,delta}*<suffix>.ed``
    (target vs fitted function, :186-205). ``suffix`` is the per-site
    ``ed_file_suffix`` analogue (e.g. ``_ineq0001``).
    """
    wm_full = matsubara_grid(cfg)
    lfit = min(cfg.lfit, target.shape[-1], len(wm_full))
    wm = wm_full[:lfit]
    z = torch.as_tensor(1j * wm, dtype=torch.complex128)
    wgt = torch.as_tensor(_fit_weight(cfg, wm), dtype=torch.float64)
    spins = [ispin] if ispin is not None else list(range(cfg.nspin))
    nsym = h_basis.shape[0] if h_basis is not None else None
    bath = unpack_bath(cfg, bath_array, nsym=nsym)
    hloc = np.asarray(hloc, np.float64)
    nb = cfg.nbath
    fit_log: List[Tuple[str, float, int]] = []

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.complex128)

    if cfg.bath_type == "normal":
        e, v = bath.e.copy(), bath.v.copy()
        for s in spins:
            for a in range(cfg.norb):
                tgt = tensor(target[s, s, a, a, :lfit])

                def chi2(theta, tgt=tgt, h_aa=float(hloc[s, s, a, a])):
                    return chi2_normal(cfg, theta, z, tgt, wgt, h_aa)

                theta0 = np.concatenate([e[s, a], v[s, a]])
                theta, chi, nit = _minimize(cfg, chi2, theta0)
                fit_log.append((f"_orb{a + 1}_s{s + 1}{suffix}", chi, nit))
                e[s, a] = theta[:nb]
                v[s, a] = np.abs(theta[nb:])
        new_bath = Bath(e=e, v=v)
    elif cfg.bath_type == "hybrid":
        e, v = bath.e.copy(), bath.v.copy()
        for s in spins:
            tgt = tensor(target[s, s, :, :, :lfit])

            def chi2(theta, tgt=tgt, h_ss=hloc[s, s]):
                return chi2_hybrid(cfg, theta, z, tgt, wgt, h_ss)

            theta0 = np.concatenate([e[s, 0], v[s].reshape(-1)])
            theta, chi, nit = _minimize(cfg, chi2, theta0)
            fit_log.append((f"_ALLorb_s{s + 1}{suffix}", chi, nit))
            e[s, 0] = theta[:nb]
            v[s] = np.abs(theta[nb:].reshape(cfg.norb, nb))
        new_bath = Bath(e=e, v=v)
    else:
        tgt = tensor(target[..., :lfit])

        def chi2(theta):
            return chi2_replica(cfg, theta, z, tgt, wgt, hloc, h_basis)

        theta0 = np.concatenate([bath.v_rep.reshape(-1),
                                 bath.lam.reshape(-1)])
        theta, chi, nit = _minimize(cfg, chi2, theta0)
        fit_log.append((suffix, chi, nit))
        nv = nb * cfg.nspin
        new_bath = Bath(v_rep=np.abs(theta[:nv].reshape(nb, cfg.nspin)),
                        lam=theta[nv:].reshape(nb, -1))
    if outdir is not None:
        for file_sfx, chi, nit in fit_log:
            _write_chi2_results(outdir, file_sfx, chi, nit)
        if cfg.cg_scheme == "delta":
            fgand = delta_bath(cfg, new_bath, z, h_basis)
        else:
            fgand = g0and_bath(cfg, hloc, new_bath, z, h_basis)
        _write_fit_functions(cfg, outdir, suffix, wm,
                             np.asarray(target[..., :lfit]), fgand.numpy(),
                             spins)
    return pack_bath(cfg, new_bath)


def _write_fit_functions(cfg: EDConfig, outdir: str, suffix: str,
                         wm: np.ndarray, fg: np.ndarray, fgand: np.ndarray,
                         spins) -> None:
    """Per-channel fit_{weiss,delta} files, matching the reference's
    per-bath-type suffix conventions (fitgf_normal_normal.f90:186-205,
    fitgf_hybrid_normal.f90:197-217, fitgf_replica.f90:182-207)."""
    if cfg.bath_type == "normal":
        for s in spins:
            for a in range(cfg.norb):
                _write_fit_function(cfg, outdir, f"_orb{a + 1}_s{s + 1}{suffix}",
                                    wm, fg[s, s, a, a], fgand[s, s, a, a])
    elif cfg.bath_type == "hybrid":
        for s in spins:
            for a in range(cfg.norb):
                for b in range(a, cfg.norb):
                    _write_fit_function(cfg, outdir,
                                        f"_l{a + 1}_m{b + 1}{suffix}",
                                        wm, fg[s, s, a, b], fgand[s, s, a, b])
    else:  # replica: every (spin-diagonal) component
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                for b in range(cfg.norb):
                    _write_fit_function(
                        cfg, outdir,
                        f"_l{a + 1}_m{b + 1}_s{s + 1}_r{s + 1}{suffix}",
                        wm, fg[s, s, a, b], fgand[s, s, a, b])


def _write_chi2_results(outdir: str, suffix: str, chi: float,
                        niter: int) -> None:
    """chi2fit_results<suffix>.ed append record (fitgf_normal_normal.f90:147)."""
    with open(os.path.join(outdir, f"chi2fit_results{suffix}.ed"), "a") as fh:
        fh.write(f"{chi:18.9E} {niter:5d}\n")


def _write_fit_function(cfg: EDConfig, outdir: str, suffix: str,
                        wm: np.ndarray, fg_ch: np.ndarray,
                        fgand_ch: np.ndarray) -> None:
    """fit_{weiss,delta}<suffix>.ed: 5F24.15 columns
    (x, Im fg, Im fgand, Re fg, Re fgand) — fitgf_normal_normal.f90:186-205."""
    name = "fit_weiss" if cfg.cg_scheme == "weiss" else "fit_delta"
    with open(os.path.join(outdir, f"{name}{suffix}.ed"), "w") as fh:
        for x, g, ga in zip(wm, fg_ch, fgand_ch):
            fh.write(f"{x:24.15F}{g.imag:24.15F}{ga.imag:24.15F}"
                     f"{g.real:24.15F}{ga.real:24.15F}\n")


def replica_chi2_fitgf(cfg: EDConfig, target: np.ndarray,
                       bath_array: np.ndarray, hloc: np.ndarray,
                       h_basis: np.ndarray) -> np.ndarray:
    """Convenience alias matching the reference's fitgf_replica entry."""
    return chi2_fitgf(cfg, target, bath_array, hloc, h_basis=h_basis)


class _StopWatcher:
    """Reference fmin_cg stopping conditions (CG_STOP,
    ED_INPUT_VARS.f90:196), as a scipy callback:

        C1 = |F_{n-1} - F_n|   < ftol * (1 + F_n)
        C2 = ||x_{n-1} - x_n|| < ftol * (1 + ||x_n||)

    cg_stop = 0 -> C1.AND.C2, 1 -> C1, 2 -> C2."""

    def __init__(self, fun_value, ftol: float, istop: int):
        self.fv = fun_value
        self.ftol = ftol
        self.istop = istop
        self.prev_x: Optional[np.ndarray] = None
        self.prev_f: Optional[float] = None
        self.nit = 0

    def __call__(self, xk, *_):
        xk = np.asarray(xk, dtype=np.float64)
        fk = self.fv(xk)
        self.nit += 1
        stop = False
        if self.prev_x is not None:
            c1 = abs(self.prev_f - fk) < self.ftol * (1.0 + abs(fk))
            c2 = (np.linalg.norm(self.prev_x - xk)
                  < self.ftol * (1.0 + np.linalg.norm(xk)))
            stop = {0: c1 and c2, 1: c1, 2: c2}.get(self.istop, c1 and c2)
        self.prev_x, self.prev_f = xk, fk
        if stop:
            raise StopIteration


def value_and_grad(chi2_fn: Callable, t: np.ndarray) -> Tuple[float,
                                                               np.ndarray]:
    """(chi2, d chi2 / d theta) at t by torch autograd (f64, CPU)."""
    th = torch.tensor(np.asarray(t, np.float64), requires_grad=True)
    val = chi2_fn(th)
    (grad,) = torch.autograd.grad(val, th)
    return float(val.detach()), grad.numpy().astype(np.float64)


@contextmanager
def _one_thread():
    """One intra-op thread for the fit's tensors of a few kilobytes: the
    pool's hand-offs cost more than the work (a replica fit's evaluation
    several times slower at 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _minimize(cfg: EDConfig, chi2_fn: Callable,
              theta0: np.ndarray) -> Tuple[np.ndarray, float, int]:
    """Quasi-Newton descent on the chi2 (the reference's dials:
    cg_method 0 -> L-BFGS-B, 1 -> CG; cg_grad 0 -> exact autograd
    gradient, 1 -> finite differences with step cg_minimize_hh;
    cg_stop / cg_ftol via :class:`_StopWatcher`), on one intra-op
    thread. Returns (theta, chi2, niter)."""
    numeric = cfg.cg_grad != 0

    def fval(t):
        with torch.no_grad():
            return float(chi2_fn(torch.as_tensor(np.asarray(t, np.float64))))

    if numeric:
        fun, jac = fval, None
    else:
        fun, jac = (lambda t: value_and_grad(chi2_fn, t)), True
    watcher = _StopWatcher(fval, cfg.cg_ftol, cfg.cg_stop)
    if cfg.cg_method == 1:
        options = {"maxiter": cfg.cg_niter, "gtol": 1e-12}
        method = "CG"
    else:
        options = {"maxiter": cfg.cg_niter, "ftol": cfg.cg_ftol * 1e-3,
                   "gtol": 1e-12}
        method = "L-BFGS-B"
    if numeric:
        options["eps"] = cfg.cg_minimize_hh
    with _one_thread():
        res = _scipy_minimize(fun, theta0, jac=jac, method=method,
                              callback=watcher, options=options)
        theta = np.asarray(res.x)
        chi = fval(theta)
    nit = int(getattr(res, "nit", watcher.nit) or watcher.nit)
    return theta, chi, nit
