"""Analytic Anderson bath functions Delta(z), G0(z), G0^-1(z), normal bath
(port of ``dmft_lanc_ed_tpu/bath_functions.py``; reference
ED_BATH_FUNCTIONS.f90:25-195).

Functions of (config, hloc, bath, z) in complex128 torch tensors, built
without in-place writes on their inputs, so the chi2 fit differentiates
through them with autograd. The bath's e and v may be numpy arrays or
tensors (requiring grad). All return [nspin, nspin, norb, norb, L]
(reference layout). Hybrid and replica baths are not ported
(ROADMAP A7).
"""
from __future__ import annotations

import torch

from .bath import Bath, _require_normal
from .config import EDConfig

_C128 = torch.complex128


def _f64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _diag_layout(cfg: EDConfig, d: torch.Tensor) -> torch.Tensor:
    """[nspin, norb, L] -> [nspin, nspin, norb, norb, L], spin- and
    orbital-diagonal."""
    nspin, norb = cfg.nspin, cfg.norb
    eye_s = torch.eye(nspin, dtype=_C128, device=d.device)
    eye_o = torch.eye(norb, dtype=_C128, device=d.device)
    return torch.einsum("st,ab,sal->stabl", eye_s, eye_o, d)


def _delta_diag(cfg: EDConfig, bath: Bath, z: torch.Tensor) -> torch.Tensor:
    """Delta_aa(z) = sum_k V_ak^2 / (z - e_ak) as [nspin, norb, L]."""
    e = _f64(bath.e, z.device)[..., None, :]       # [ns, norb, 1, nb]
    v = _f64(bath.v, z.device)[..., None, :]
    return (v * v / (z[None, None, :, None] - e)).sum(-1)


def delta_bath(cfg: EDConfig, bath: Bath, z) -> torch.Tensor:
    """Hybridization function Delta(z) (delta_bath_array)."""
    _require_normal(cfg)
    z = torch.as_tensor(z, dtype=_C128)
    return _diag_layout(cfg, _delta_diag(cfg, bath, z))


def _invg0_diag(cfg: EDConfig, hloc, bath: Bath, z: torch.Tensor
                ) -> torch.Tensor:
    hloc = torch.as_tensor(hloc, dtype=_C128, device=z.device)
    idx = torch.arange(cfg.norb)
    h_aa = torch.stack([hloc[s, s, idx, idx] for s in range(cfg.nspin)])
    return (z + cfg.xmu)[None, None, :] - h_aa[..., None] \
        - _delta_diag(cfg, bath, z)


def invg0_bath(cfg: EDConfig, hloc, bath: Bath, z) -> torch.Tensor:
    """G0^-1(z) = (z + mu) - Hloc - Delta(z)  (invg0_bath_array)."""
    _require_normal(cfg)
    z = torch.as_tensor(z, dtype=_C128)
    return _diag_layout(cfg, _invg0_diag(cfg, hloc, bath, z))


def g0and_bath(cfg: EDConfig, hloc, bath: Bath, z) -> torch.Tensor:
    """Non-interacting impurity GF G0and(z) (g0and_bath_array)."""
    _require_normal(cfg)
    z = torch.as_tensor(z, dtype=_C128)
    return _diag_layout(cfg, 1.0 / _invg0_diag(cfg, hloc, bath, z))
