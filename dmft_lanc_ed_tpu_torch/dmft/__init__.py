"""DMFT lattice layer — the DMFT_Tools subset the reference drivers use.

(SURVEY.md §2 native-code obligations: dmft_gloc_matsubara/realaxis,
dmft_self_consistency, check_convergence, dens_bethe, Hk builders,
dmft_kinetic_energy, mixing incl. Broyden, mu search.)
"""
from .bethe import dens_bethe, dens_flat, bethe_bands
from .gloc import gloc_dos, gloc_dos_bipartite, gloc_hk
from .selfcons import self_consistency, weiss_from_gloc, delta_from_gloc
from .convergence import ConvergenceCheck
from .mixing import LinearMixer, BroydenMixer
from .search import DensitySearch
from .kinetic import kinetic_energy_dos, kinetic_energy_hk
