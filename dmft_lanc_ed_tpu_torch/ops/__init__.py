"""Sector operators and Krylov solvers of the PyTorch port."""
from .matvec import apply_h, matvec_flat, make_matvec
from .lanczos import lanczos_tridiag, tridiag_eigh, lanczos_ground_state
from .davidson import davidson_ground_state
