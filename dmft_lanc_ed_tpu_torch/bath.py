"""Effective-bath layer, normal topology (port of ``dmft_lanc_ed_tpu/bath.py``).

The bath is a frozen dataclass of host numpy arrays (torch tensors inside
the chi2 fit, which differentiates through them). pack/unpack keep the
exact reference memory layout (set/get_dmft_bath,
ED_BATH/dmft_aux.f90:340-496), so packed baths move unchanged between this
package, the JAX package and restart files.

Only ``bath_type="normal"`` (Nbath levels per (spin, orbital);
e[nspin, norb, nbath], v the same) is ported; hybrid and replica raise
:class:`NotImplementedError` (ROADMAP A7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .config import EDConfig


def _require_normal(cfg: EDConfig) -> None:
    if cfg.bath_type != "normal":
        raise NotImplementedError(
            f"bath_type={cfg.bath_type!r} is not ported yet (ROADMAP A7); "
            "only the normal bath is")


@dataclass(frozen=True)
class Bath:
    """Normal-bath parameters: e, v [nspin, norb, nbath]."""
    e: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None


def bath_dimension(cfg: EDConfig) -> int:
    _require_normal(cfg)
    return 2 * cfg.nspin * cfg.norb * cfg.nbath


def init_bath(cfg: EDConfig) -> Bath:
    """Default bath guess (init_dmft_bath): levels spread in
    [-hwband, hwband], V = max(0.1, 1/sqrt(Nb))."""
    _require_normal(cfg)
    nb, norb, nspin = cfg.nbath, cfg.norb, cfg.nspin
    hw = cfg.hwband
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
    e = np.broadcast_to(e1, (nspin, norb, nb)).copy()
    v = np.full((nspin, norb, nb), max(0.1, 1.0 / np.sqrt(nb)))
    return Bath(e=e, v=v)


def pack_bath(cfg: EDConfig, bath: Bath) -> np.ndarray:
    """Bath -> flat array, exact reference ordering (get_dmft_bath):
    all e by (spin, orb, k), then all v."""
    _require_normal(cfg)
    return np.concatenate([np.asarray(bath.e, np.float64).reshape(-1),
                           np.asarray(bath.v, np.float64).reshape(-1)])


def unpack_bath(cfg: EDConfig, arr: np.ndarray) -> Bath:
    """Flat array -> Bath (set_dmft_bath)."""
    _require_normal(cfg)
    arr = np.asarray(arr, dtype=np.float64)
    n = cfg.nspin * cfg.norb * cfg.nbath
    shape = (cfg.nspin, cfg.norb, cfg.nbath)
    return Bath(e=arr[:n].reshape(shape).copy(),
                v=arr[n:2 * n].reshape(shape).copy())


# --------------------------------------------------------------------------
# user bath symmetrization ops (ED_BATH/user_aux.f90:21-231)
# --------------------------------------------------------------------------
def break_symmetry_bath(cfg: EDConfig, arr: np.ndarray, field: float,
                        sign: float = 1.0) -> np.ndarray:
    """Shift up/dw bath levels by ±sign*field (magnetic seed)."""
    bath = unpack_bath(cfg, arr)
    e = bath.e.copy()
    e[0] += sign * field
    if cfg.nspin == 2:
        e[1] -= sign * field
    return pack_bath(cfg, Bath(e=e, v=bath.v))


def spin_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    bath = unpack_bath(cfg, arr)
    if cfg.nspin == 1:
        return arr
    e, v = bath.e.copy(), bath.v.copy()
    e[1] = e[0]
    v[1] = v[0]
    return pack_bath(cfg, Bath(e=e, v=v))


def orb_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Average bath over orbitals (orb_symmetrize_bath)."""
    bath = unpack_bath(cfg, arr)
    e = np.broadcast_to(bath.e.mean(axis=1, keepdims=True), bath.e.shape)
    v = np.broadcast_to(bath.v.mean(axis=1, keepdims=True), bath.v.shape)
    return pack_bath(cfg, Bath(e=e.copy(), v=v.copy()))


def orb_equality_bath(cfg: EDConfig, arr: np.ndarray, iorb: int = 0
                      ) -> np.ndarray:
    """Copy orbital iorb's bath onto every orbital (orb_equality_bath)."""
    bath = unpack_bath(cfg, arr)
    e, v = bath.e.copy(), bath.v.copy()
    e[:] = e[:, iorb:iorb + 1, :]
    v[:] = v[:, iorb:iorb + 1, :]
    return pack_bath(cfg, Bath(e=e, v=v))


def ph_symmetrize_bath(cfg: EDConfig, arr: np.ndarray) -> np.ndarray:
    """Particle-hole symmetrize bath levels (ph_symmetrize_bath)."""
    bath = unpack_bath(cfg, arr)
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
    bath = unpack_bath(cfg, arr)
    return pack_bath(cfg, Bath(e=-bath.e[..., ::-1].copy(),
                               v=bath.v[..., ::-1].copy()))


def get_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str
                       ) -> np.ndarray:
    """Extract the 'e' or 'v' block as [nspin, norb, nbath]."""
    bath = unpack_bath(cfg, arr)
    if itype == "e":
        return bath.e.copy()
    if itype == "v":
        return bath.v.copy()
    raise ValueError("itype must be 'e' or 'v'")


def set_bath_component(cfg: EDConfig, arr: np.ndarray, itype: str,
                       value: np.ndarray) -> np.ndarray:
    """Replace the 'e' or 'v' block (set_bath_component)."""
    bath = unpack_bath(cfg, arr)
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
                ) -> Tuple[np.ndarray, np.ndarray, None]:
    """(bath_diag, diag_hybr, hbath) for the Hamiltonian builder: the
    normal bath's level energies [nspin, norb, nbath], its hybridizations
    (same shape), and no replica Hamiltonian."""
    _require_normal(cfg)
    return np.asarray(bath.e), np.asarray(bath.v), None
