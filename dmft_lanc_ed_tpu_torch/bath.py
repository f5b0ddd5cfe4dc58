"""Effective-bath layer (port of ``dmft_lanc_ed_tpu/bath.py``).

The bath is a frozen dataclass of host numpy arrays (torch tensors inside
the chi2 fit, which differentiates through them). pack/unpack keep the
exact reference memory layout (set/get_dmft_bath,
ED_BATH/dmft_aux.f90:340-496), so packed baths move unchanged between this
package, the JAX package and restart files.

Bath topologies (bath_type, ED_INPUT_VARS.f90:205):
- normal : Nbath levels per (spin, orbital); e[nspin, norb, nbath], v same.
- hybrid : Nbath shared levels; e[nspin, 1, nbath], v[nspin, norb, nbath].
- replica: Nbath replicas of the impurity local Hamiltonian, each
  parameterized by lambda over a shared symmetry basis; v_rep[nbath, nspin],
  lam[nbath, nsym].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .config import EDConfig
from .hloc import nn2so


@dataclass(frozen=True)
class Bath:
    """Effective bath parameters (one of e/v or lam/v_rep, by bath_type).

    - e: [nspin, norb_e, nbath] bath level energies (norb_e=1 for hybrid)
    - v: [nspin, norb, nbath] hybridization amplitudes
    - lam: [nbath, nsym] replica symmetry-basis coefficients (replica only)
    - v_rep: [nbath, nspin] replica hybridizations (replica only)
    """
    e: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    lam: Optional[np.ndarray] = None
    v_rep: Optional[np.ndarray] = None


# --------------------------------------------------------------------------
# dimensioning (get_bath_dimension, ED_BATH.f90:152-227)
# --------------------------------------------------------------------------
def bath_dimension(cfg: EDConfig, nsym: Optional[int] = None) -> int:
    if cfg.bath_type == "normal":
        return 2 * cfg.nspin * cfg.norb * cfg.nbath
    if cfg.bath_type == "hybrid":
        return cfg.nspin * cfg.nbath + cfg.nspin * cfg.norb * cfg.nbath
    # replica: per bath: [N_dec] + [v per spin] + [lambda(1..nsym)]
    if nsym is None:
        raise ValueError("replica bath_dimension requires nsym")
    return cfg.nbath + cfg.nbath * (cfg.nspin + nsym)


# --------------------------------------------------------------------------
# initialization (init_dmft_bath, ED_BATH/dmft_aux.f90:91-155)
# --------------------------------------------------------------------------
def _levels(nb: int, hw: float) -> np.ndarray:
    """Default level energies spread in [-hw, hw]."""
    e1 = np.zeros(nb)
    if nb > 1:
        e1[0], e1[-1] = -hw, hw
        nh = nb // 2
        if nb % 2 == 0 and nb >= 4:
            de = hw / max(nh - 1, 1)
            e1[nh - 1], e1[nh] = -0.1, 0.1
            for i in range(1, nh - 1):
                e1[i] = -hw + i * de
                e1[nb - 1 - i] = hw - i * de
        elif nb % 2 == 1 and nb >= 3:
            de = hw / nh
            e1[nh] = 0.0
            for i in range(1, nh):
                e1[i] = -hw + i * de
                e1[nb - 1 - i] = hw - i * de
    return e1


def init_bath(cfg: EDConfig, lambda_imp: Optional[np.ndarray] = None,
              h_basis: Optional[np.ndarray] = None) -> Bath:
    """Default bath guess (init_dmft_bath): levels spread in
    [-hwband, hwband], V = max(0.1, 1/sqrt(Nb)); a replica bath starts from
    the impurity's lambda, its diagonal basis elements rescaled per
    replica."""
    nb, norb, nspin = cfg.nbath, cfg.norb, cfg.nspin
    hw = cfg.hwband
    v0 = max(0.1, 1.0 / np.sqrt(nb))
    if cfg.bath_type in ("normal", "hybrid"):
        norb_e = norb if cfg.bath_type == "normal" else 1
        e = np.broadcast_to(_levels(nb, hw), (nspin, norb_e, nb)).copy()
        return Bath(e=e, v=np.full((nspin, norb, nb), v0))
    if lambda_imp is None or h_basis is None:
        raise ValueError("replica init requires lambda_imp and h_basis")
    nsym = len(lambda_imp)
    rescale = np.linspace(hw / nb, hw, nb) if nb > 1 else np.array([0.0])
    lam = np.zeros((nb, nsym))
    for isym in range(nsym):
        # diagonal basis elements scale with the replica index; off-diagonal
        # ones start at the impurity value (init_dmft_bath replica branch)
        bso = nn2so(h_basis[isym], nspin, norb)
        diagonal = np.allclose(bso - np.diag(np.diag(bso)), 0.0)
        for ib in range(nb):
            lam[ib, isym] = (rescale[ib] * lambda_imp[isym] if diagonal
                             else lambda_imp[isym])
    return Bath(lam=lam, v_rep=np.full((nb, nspin), v0))


# --------------------------------------------------------------------------
# pack/unpack: flat user array <-> Bath (set/get_dmft_bath)
# --------------------------------------------------------------------------
def pack_bath(cfg: EDConfig, bath: Bath) -> np.ndarray:
    """Bath -> flat array, exact reference ordering (get_dmft_bath):
    normal/hybrid all e by (spin, orb, k), then all v; replica
    [N_dec] * nbath, then per bath [v per spin, lambda(1..nsym)]."""
    if cfg.bath_type in ("normal", "hybrid"):
        return np.concatenate([np.asarray(bath.e, np.float64).reshape(-1),
                               np.asarray(bath.v, np.float64).reshape(-1)])
    lam = np.asarray(bath.lam, np.float64)
    v = np.asarray(bath.v_rep, np.float64)
    nb, nsym = lam.shape
    parts = [np.full(nb, float(nsym))]
    for ib in range(nb):
        parts.append(v[ib])
        parts.append(lam[ib])
    return np.concatenate(parts)


def unpack_bath(cfg: EDConfig, arr: np.ndarray, nsym: Optional[int] = None
                ) -> Bath:
    """Flat array -> Bath (set_dmft_bath). A replica bath reads N_dec from
    arr[0] and refuses one that differs from `nsym`."""
    arr = np.asarray(arr, dtype=np.float64)
    nb, norb, nspin = cfg.nbath, cfg.norb, cfg.nspin
    if cfg.bath_type == "normal":
        n = nspin * norb * nb
        shape = (nspin, norb, nb)
        return Bath(e=arr[:n].reshape(shape).copy(),
                    v=arr[n:2 * n].reshape(shape).copy())
    if cfg.bath_type == "hybrid":
        ne = nspin * nb
        return Bath(e=arr[:ne].reshape(nspin, 1, nb).copy(),
                    v=arr[ne:ne + nspin * norb * nb].reshape(
                        nspin, norb, nb).copy())
    ndec = int(round(arr[0]))
    if nsym is not None and nsym != ndec:
        raise ValueError(f"replica bath N_dec mismatch: {ndec} vs {nsym}")
    per = arr[nb:nb + nb * (nspin + ndec)].reshape(nb, nspin + ndec)
    return Bath(lam=per[:, nspin:].copy(), v_rep=per[:, :nspin].copy())


def _e_v(cfg: EDConfig, arr: np.ndarray) -> Bath:
    """unpack_bath for the helpers below, which act on the e/v blocks of a
    normal or hybrid bath; a replica bath has none."""
    if cfg.bath_type == "replica":
        raise ValueError("this bath operation acts on e/v blocks; the "
                         "replica bath has none")
    return unpack_bath(cfg, arr)


# --------------------------------------------------------------------------
# user bath symmetrization ops (ED_BATH/user_aux.f90:21-231)
# --------------------------------------------------------------------------
def break_symmetry_bath(cfg: EDConfig, arr: np.ndarray, field: float,
                        sign: float = 1.0) -> np.ndarray:
    """Shift up/dw bath levels by ±sign*field (magnetic seed)."""
    bath = _e_v(cfg, arr)
    e = bath.e.copy()
    e[0] += sign * field
    if cfg.nspin == 2:
        e[1] -= sign * field
    return pack_bath(cfg, Bath(e=e, v=bath.v))


def spin_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    if cfg.nspin == 1:
        return arr
    bath = _e_v(cfg, arr)
    e, v = bath.e.copy(), bath.v.copy()
    e[1] = e[0]
    v[1] = v[0]
    return pack_bath(cfg, Bath(e=e, v=v))


def orb_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Average bath over orbitals (orb_symmetrize_bath)."""
    bath = _e_v(cfg, arr)
    e = np.broadcast_to(bath.e.mean(axis=1, keepdims=True), bath.e.shape)
    v = np.broadcast_to(bath.v.mean(axis=1, keepdims=True), bath.v.shape)
    return pack_bath(cfg, Bath(e=e.copy(), v=v.copy()))


def orb_equality_bath(cfg: EDConfig, arr: np.ndarray, iorb: int = 0
                      ) -> np.ndarray:
    """Copy orbital iorb's bath onto every orbital (orb_equality_bath)."""
    bath = _e_v(cfg, arr)
    e, v = bath.e.copy(), bath.v.copy()
    if cfg.bath_type == "normal":
        e[:] = e[:, iorb:iorb + 1, :]
    v[:] = v[:, iorb:iorb + 1, :]
    return pack_bath(cfg, Bath(e=e, v=v))


def ph_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Particle-hole symmetrize bath levels (ph_symmetrize_bath)."""
    bath = _e_v(cfg, arr)
    e, v = bath.e.copy(), bath.v.copy()
    nb = cfg.nbath
    for i in range(nb // 2):
        e[..., nb - 1 - i] = -e[..., i]
        v[..., nb - 1 - i] = v[..., i]
    if nb % 2 == 1:
        e[..., nb // 2] = 0.0
    return pack_bath(cfg, Bath(e=e, v=v))


def ph_trans_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Particle-hole transform the bath: e_k -> -e_k, order reversed."""
    bath = _e_v(cfg, arr)
    return pack_bath(cfg, Bath(e=-bath.e[..., ::-1].copy(),
                               v=bath.v[..., ::-1].copy()))


def get_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str
                       ) -> np.ndarray:
    """Extract the 'e' or 'v' block as [nspin, norb (1 for a hybrid e),
    nbath]."""
    bath = _e_v(cfg, arr)
    if itype == "e":
        return bath.e.copy()
    if itype == "v":
        return bath.v.copy()
    raise ValueError("itype must be 'e' or 'v'")


def set_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str,
                       value: np.ndarray) -> np.ndarray:
    """Replace the 'e' or 'v' block (set_bath_component)."""
    bath = _e_v(cfg, arr)
    e, v = bath.e.copy(), bath.v.copy()
    if itype == "e":
        e[:] = value
    elif itype == "v":
        v[:] = value
    else:
        raise ValueError("itype must be 'e' or 'v'")
    return pack_bath(cfg, Bath(e=e, v=v))


def copy_bath_component(cfg: EDConfig, arr_from: np.ndarray,
                        arr_to: np.ndarray, itype: str) -> np.ndarray:
    """Copy one component block between packed baths (copy_component)."""
    return set_bath_component(cfg, arr_to, itype,
                              get_bath_component(cfg, arr_from, itype))


def bath_levels(cfg: EDConfig, bath: Bath,
                h_basis: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(bath_diag, diag_hybr, hbath) for the Hamiltonian builder.

    - bath_diag[nspin, norb_e, nbath]: on-site bath energies (diagonal part)
    - diag_hybr[nspin, norb, nbath]: hybridization amplitudes
    - hbath[nspin, nspin, norb, norb, nbath] (replica only): each replica's
      Hamiltonian lambda . h_basis; its off-diagonal part is the
      intra-replica hopping, its diagonal feeds bath_diag.
    """
    if cfg.bath_type in ("normal", "hybrid"):
        return np.asarray(bath.e), np.asarray(bath.v), None
    nspin, norb = cfg.nspin, cfg.norb
    hbath = np.einsum("bs,sijkl->ijklb", np.asarray(bath.lam),
                      np.asarray(h_basis))
    idx = np.arange(norb)
    bath_diag = np.stack([hbath[s, s][idx, idx] for s in range(nspin)])
    v = np.asarray(bath.v_rep)                     # [nbath, nspin]
    diag_hybr = np.broadcast_to(v.T[:, None, :],
                                (nspin, norb, cfg.nbath)).copy()
    return bath_diag, diag_hybr, hbath
