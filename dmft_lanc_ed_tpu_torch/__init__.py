"""dmft_lanc_ed_tpu_torch — the PyTorch + CUDA port of dmft_lanc_ed_tpu.

The same Lanczos exact-diagonalization DMFT solver, with the same module
and function names as the JAX package (its reference, which stays beside
it): sector tables and Hamiltonians on the host, sector operators and
Krylov chains on a torch device, the TPU's Pallas chain kernels replaced by
hand-written CUDA for Hopper (``csrc/``, built at first use). This package
never imports jax or dmft_lanc_ed_tpu.

TF32 is switched off for matmuls and convolutions: the mixed-precision
contract (~1e-7 relative per matvec, the GF scan and the ground-state
top-off) needs true f32 products, as the JAX package's
``Precision.HIGHEST`` gave them; TF32 keeps about three decimal digits.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import EDConfig, read_input, save_used_input  # noqa: E402
from .bath import (  # noqa: E402
    Bath, bath_dimension, init_bath, pack_bath, unpack_bath,
    break_symmetry_bath, spin_symmetrize_bath, orb_symmetrize_bath,
    orb_equality_bath, ph_symmetrize_bath, ph_trans_bath,
    get_bath_component, set_bath_component, copy_bath_component,
)
from .sectors import Sector, SectorTable, qn  # noqa: E402
from .hamiltonian import (SectorHamiltonian, build_sector_hamiltonian,  # noqa: E402
                          dense_hamiltonian)
from .hloc import decompose_hloc, h_from_sym  # noqa: E402
from .solver import EDSolver, SolveResult, matsubara_grid, real_grid  # noqa: E402
from .fit import chi2_fitgf  # noqa: E402
from .lattice import LatticeResult, LatticeSolver  # noqa: E402

__version__ = "0.1.0"
