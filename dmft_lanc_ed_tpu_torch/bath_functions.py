"""Analytic Anderson bath functions Delta(z), G0(z), G0^-1(z) (port of
``dmft_lanc_ed_tpu/bath_functions.py``; reference
ED_BATH_FUNCTIONS.f90:25-195).

Functions of (config, hloc, bath, z) in complex128 torch tensors, built
without in-place writes on their inputs, so the chi2 fit differentiates
through them with autograd. The bath's arrays may be numpy arrays or
tensors (requiring grad). All return [nspin, nspin, norb, norb, L]
(reference layout), spin-diagonal. The normal bath is orbital-diagonal;
the hybrid and replica baths give full orbital blocks, and their G0 is a
per-frequency orbital-matrix inverse (batched ``torch.linalg.inv``).
"""
from __future__ import annotations

import torch

from .bath import Bath
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


def _spin_layout(cfg: EDConfig, d: torch.Tensor) -> torch.Tensor:
    """[nspin, norb, norb, L] -> [nspin, nspin, norb, norb, L],
    spin-diagonal."""
    eye_s = torch.eye(cfg.nspin, dtype=_C128, device=d.device)
    return torch.einsum("st,sabl->stabl", eye_s, d)


def _delta_diag(cfg: EDConfig, bath: Bath, z: torch.Tensor) -> torch.Tensor:
    """Normal bath: Delta_aa(z) = sum_k V_ak^2 / (z - e_ak) as
    [nspin, norb, L]."""
    e = _f64(bath.e, z.device)[..., None, :]       # [ns, norb, 1, nb]
    v = _f64(bath.v, z.device)[..., None, :]
    return (v * v / (z[None, None, :, None] - e)).sum(-1)


def _delta_blocks(cfg: EDConfig, bath: Bath, z: torch.Tensor,
                  h_basis) -> torch.Tensor:
    """Hybrid or replica bath: the spin-diagonal blocks of Delta(z) as
    [nspin, norb, norb, L]."""
    nspin, norb = cfg.nspin, cfg.norb
    if cfg.bath_type == "hybrid":
        # Delta_ab = sum_k V_ak V_bk / (z - e_k)
        e = _f64(bath.e, z.device)[:, 0, :]          # [ns, nb]
        v = _f64(bath.v, z.device).to(_C128)         # [ns, norb, nb]
        inv = 1.0 / (z[None, :, None] - e[:, None, :])   # [ns, L, nb]
        return torch.einsum("sak,sbk,slk->sabl", v, v, inv)
    # replica: Delta = sum_p V_p^2 [(z - H_p)^-1], H_p = lambda_p . basis
    nso = nspin * norb
    basis = _f64(h_basis, z.device)                  # [nsym, ns,ns,no,no]
    hp = torch.einsum("pm,mijkl->pijkl", _f64(bath.lam, z.device), basis)
    nb = hp.shape[0]
    hp_so = hp.permute(0, 1, 3, 2, 4).reshape(nb, nso, nso).to(_C128)
    eye = torch.eye(nso, dtype=_C128, device=z.device)
    inv = torch.linalg.inv(z[:, None, None, None] * eye - hp_so[None])
    inv_nn = inv.reshape(-1, nb, nspin, norb, nspin, norb)
    diag = torch.diagonal(inv_nn, dim1=2, dim2=4)    # [L, nb, no, no, ns]
    w = (_f64(bath.v_rep, z.device) ** 2).to(_C128)  # [nb, ns]
    return torch.einsum("bs,qbkls->sklq", w, diag)


def delta_bath(cfg: EDConfig, bath: Bath, z, h_basis=None) -> torch.Tensor:
    """Hybridization function Delta(z) (delta_bath_array)."""
    z = torch.as_tensor(z, dtype=_C128)
    if cfg.bath_type == "normal":
        return _diag_layout(cfg, _delta_diag(cfg, bath, z))
    return _spin_layout(cfg, _delta_blocks(cfg, bath, z, h_basis))


def _invg0_diag(cfg: EDConfig, hloc, bath: Bath, z: torch.Tensor
                ) -> torch.Tensor:
    hloc = torch.as_tensor(hloc, dtype=_C128, device=z.device)
    idx = torch.arange(cfg.norb)
    h_aa = torch.stack([hloc[s, s, idx, idx] for s in range(cfg.nspin)])
    return (z + cfg.xmu)[None, None, :] - h_aa[..., None] \
        - _delta_diag(cfg, bath, z)


def _invg0_blocks(cfg: EDConfig, hloc, bath: Bath, z: torch.Tensor,
                  h_basis) -> torch.Tensor:
    """Hybrid or replica bath: [nspin, norb, norb, L] blocks of G0^-1."""
    hloc = torch.as_tensor(hloc, dtype=_C128, device=z.device)
    h_ss = torch.stack([hloc[s, s] for s in range(cfg.nspin)])
    eye = torch.eye(cfg.norb, dtype=_C128, device=z.device)
    zmat = (z + cfg.xmu)[None, None, :] * eye[:, :, None]
    return zmat[None] - h_ss[..., None] - _delta_blocks(cfg, bath, z,
                                                        h_basis)


def invg0_bath(cfg: EDConfig, hloc, bath: Bath, z, h_basis=None
               ) -> torch.Tensor:
    """G0^-1(z) = (z + mu) - Hloc - Delta(z)  (invg0_bath_array)."""
    z = torch.as_tensor(z, dtype=_C128)
    if cfg.bath_type == "normal":
        return _diag_layout(cfg, _invg0_diag(cfg, hloc, bath, z))
    return _spin_layout(cfg, _invg0_blocks(cfg, hloc, bath, z, h_basis))


def g0and_bath(cfg: EDConfig, hloc, bath: Bath, z, h_basis=None
               ) -> torch.Tensor:
    """Non-interacting impurity GF G0and(z) (g0and_bath_array)."""
    z = torch.as_tensor(z, dtype=_C128)
    if cfg.bath_type == "normal":
        return _diag_layout(cfg, 1.0 / _invg0_diag(cfg, hloc, bath, z))
    # hybrid/replica: per-frequency norb x norb inverse, spin diagonal
    blk = _invg0_blocks(cfg, hloc, bath, z, h_basis).permute(0, 3, 1, 2)
    return _spin_layout(cfg, torch.linalg.inv(blk).permute(0, 2, 3, 1))
