"""Tight-binding H(k) builders for the driver models.

Small lattice-layer helpers replacing the DMFT_Tools TB_* routines the
reference drivers use (edn_hm_2b_square.f90, edn_bhz_2d.f90). Host numpy,
copied from ``dmft_lanc_ed_tpu/dmft/hk.py``.
"""
from __future__ import annotations


import numpy as np


def kgrid_2d(nk: int) -> np.ndarray:
    """[nk*nk, 2] uniform BZ grid in (-pi, pi]."""
    k1 = 2.0 * np.pi * (np.arange(nk) / nk) - np.pi
    kx, ky = np.meshgrid(k1, k1, indexing="ij")
    return np.stack([kx.ravel(), ky.ravel()], axis=1)


def hk_square(nk: int, norb: int, t=0.25, eps0=None) -> np.ndarray:
    """Orbital-diagonal square-lattice dispersion -2t(cos kx + cos ky).

    Returns [Nk, norb, norb] (spin-degenerate; embed per spin as needed).
    """
    ks = kgrid_2d(nk)
    t = np.broadcast_to(np.atleast_1d(t), (norb,))
    eps0 = np.zeros(norb) if eps0 is None else np.asarray(eps0)
    disp = -2.0 * t[None, :] * (np.cos(ks[:, 0:1]) + np.cos(ks[:, 1:2]))
    hk = np.zeros((len(ks), norb, norb), dtype=np.complex128)
    idx = np.arange(norb)
    hk[:, idx, idx] = disp + eps0[None, :]
    return hk


def hk_bhz_2d(nk: int, m0: float = 1.0, lam: float = 0.3, t: float = 0.5
              ) -> np.ndarray:
    """BHZ model, [Nk, 4, 4] in the (spin x orbital) basis
    [up-orb1, up-orb2, dw-orb1, dw-orb2] (edn_bhz_2d.f90 conventions):

      h_up(k) = [M - 2t(cos kx + cos ky)] Gamma5
                + lam sin(kx) Gamma1 + lam sin(ky) Gamma2
      h_dw(k) = h_up(-k)^*
    with Gamma5 = sigma_z (orbital), Gamma1/2 the hybridization matrices.
    """
    ks = kgrid_2d(nk)
    sz = np.diag([1.0, -1.0])
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])
    hk = np.zeros((len(ks), 4, 4), dtype=np.complex128)
    for i, (kx, ky) in enumerate(ks):
        mk = m0 - 2.0 * t * (2.0 - np.cos(kx) - np.cos(ky))
        hup = mk * sz + lam * np.sin(kx) * sx + lam * np.sin(ky) * sy
        hdw = (mk * sz + lam * np.sin(-kx) * sx
               + lam * np.sin(-ky) * sy).conj()
        hk[i, :2, :2] = hup
        hk[i, 2:, 2:] = hdw
    return hk


def hk_square_2nn(nk: int, ts: float = 0.25, tsp: float = 0.0) -> np.ndarray:
    """Single-band square lattice with next-nearest hopping
    (edn_hm_square_2nn.f90 hk_model):

        eps(k) = -2 ts (cos kx + cos ky) - 4 tsp cos kx cos ky
    """
    ks = kgrid_2d(nk)
    disp = (-2.0 * ts * (np.cos(ks[:, 0]) + np.cos(ks[:, 1]))
            - 4.0 * tsp * np.cos(ks[:, 0]) * np.cos(ks[:, 1]))
    return disp[:, None, None].astype(np.complex128)


def hk_daghofer(nk: int, alpha: float = 1.0, theta: float = 0.0,
                etanm: float = 0.0) -> np.ndarray:
    """Three-band (xz, yz, xy) model for the iron pnictides
    (Daghofer et al. three-orbital model; edn_hm_daghofer.f90 hk_model).

    Hoppings t1..t8 and the xy crystal field are the published model
    constants; ``alpha`` rescales the xy-band hoppings, ``theta`` shifts the
    xy level, ``etanm`` adds a +-nematic splitting of xz/yz.
    Returns [Nk, 3, 3].
    """
    t1, t2, t3, t4 = 0.02, 0.06, 0.03, -0.01
    t5, t6, t7 = 0.2 * alpha, 0.3 * alpha, -0.2 * alpha
    t8 = -t7 / 2.0
    dxy = 0.4 - theta
    mu_tb = 0.212
    ks = kgrid_2d(nk)
    kx, ky = ks[:, 0], ks[:, 1]
    cx, cy, cxy = np.cos(kx), np.cos(ky), np.cos(kx) * np.cos(ky)
    hk = np.zeros((len(ks), 3, 3), dtype=np.complex128)
    hk[:, 0, 0] = 2 * t2 * cx + 2 * t1 * cy + 4 * t3 * cxy - mu_tb + etanm
    hk[:, 1, 1] = 2 * t1 * cx + 2 * t2 * cy + 4 * t3 * cxy - mu_tb - etanm
    hk[:, 2, 2] = 2 * t5 * (cx + cy) + 4 * t6 * cxy + dxy - mu_tb
    hk[:, 0, 1] = 4 * t4 * np.sin(kx) * np.sin(ky)
    hk[:, 0, 2] = 2j * t7 * np.sin(kx) + 4j * t8 * np.sin(kx) * cy
    hk[:, 1, 2] = 2j * t7 * np.sin(ky) + 4j * t8 * np.sin(ky) * cx
    hk[:, 1, 0] = hk[:, 0, 1]
    hk[:, 2, 0] = hk[:, 0, 2].conj()
    hk[:, 2, 1] = hk[:, 1, 2].conj()
    return hk


def _kron_pauli(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.kron(a, b)


_P0 = np.eye(2, dtype=np.complex128)
_PX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_PY = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_PZ = np.diag([1.0 + 0j, -1.0])


def hk_triang_pxpy(nk: int, vsigma: float = 1.0, vpi: float = -1.0,
                   lam_isb: float = 0.1, lam_soc: float = 0.0) -> np.ndarray:
    """px/py orbitals on the triangular lattice (edn_triang_pxpy.f90
    hk_triang_pxpy): [Nk, 4, 4] in the (orbital tau x spin sigma) basis,

        H(k) = (Vs+Vp)(cx+cy+cxy) tau0 s0
             + sqrt(3)/2 (Vs-Vp)(cxy-cy) taux s0
             + lam_ISB (sx+sy-sxy) tauy s0
             + 1/2 (Vs-Vp)(2cx-cy-cxy) tauz s0
             + lam_SOC tauy sz

    with kx, ky the fractional projections k.a1, k.a2 on the triangular
    lattice vectors (uniform [0, 2pi) sampling covers the BZ exactly).
    """
    g0 = _kron_pauli(_P0, _P0)
    gx = _kron_pauli(_PX, _P0)
    gy = _kron_pauli(_PY, _P0)
    gz = _kron_pauli(_PZ, _P0)
    gs = _kron_pauli(_PY, _PZ)
    ks = kgrid_2d(nk)
    kx, ky = ks[:, 0], ks[:, 1]
    cx, cy, cxy = np.cos(kx), np.cos(ky), np.cos(kx + ky)
    sx, sy, sxy = np.sin(kx), np.sin(ky), np.sin(kx + ky)
    hk = ((vsigma + vpi) * (cx + cy + cxy)[:, None, None] * g0
          + np.sqrt(3.0) / 2.0 * (vsigma - vpi)
          * (cxy - cy)[:, None, None] * gx
          + lam_isb * (sx + sy - sxy)[:, None, None] * gy
          + 0.5 * (vsigma - vpi) * (2 * cx - cy - cxy)[:, None, None] * gz
          + lam_soc * gs[None, :, :] * np.ones((len(ks), 1, 1)))
    # reorder (orb x spin) -> the package's (spin x orb) Nso layout
    perm = np.array([0, 2, 1, 3])
    return hk[:, perm][:, :, perm]


def hk_afm2_square(nk: int, ts: float = 0.25) -> np.ndarray:
    """Two-sublattice square lattice in the reduced (magnetic) BZ
    (edn_hm_square_afm2.f90 hk_model): [Nk, 2, 2] with only the
    inter-sublattice nearest-neighbor hopping

        h_AB(k) = -ts (1 + e^{2i kx} + e^{i(kx+ky)} + e^{i(kx-ky)}).
    """
    ks = kgrid_2d(nk)
    kx, ky = ks[:, 0], ks[:, 1]
    hab = -ts * (1.0 + np.exp(2j * kx) + np.exp(1j * (kx + ky))
                 + np.exp(1j * (kx - ky)))
    hk = np.zeros((len(ks), 2, 2), dtype=np.complex128)
    hk[:, 0, 1] = hab
    hk[:, 1, 0] = hab.conj()
    return hk


def hloc_from_hk(hk: np.ndarray, nspin: int, norb: int) -> np.ndarray:
    """Local Hamiltonian = BZ average, reshaped to [nspin,nspin,norb,norb]."""
    h = hk.mean(axis=0)
    h = np.where(np.abs(h) < 1e-12, 0.0, h)
    if not np.allclose(h.imag, 0.0, atol=1e-10):
        raise ValueError("Hloc has imaginary parts — unsupported (real ED)")
    nso = nspin * norb
    assert h.shape == (nso, nso)
    return h.real.reshape(nspin, norb, nspin, norb).transpose(0, 2, 1, 3)
