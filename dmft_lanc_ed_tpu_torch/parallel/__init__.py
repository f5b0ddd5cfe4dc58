"""Multi-rank parallelism over ``torch.distributed`` (port of
``dmft_lanc_ed_tpu/parallel``).

The JAX package is single-controller: one process drives a 1-D device
mesh through ``shard_map`` (ppermute halos, psum norms) and the SPMD
partitioner. The port is one process per shard, as the Fortran reference
is one MPI rank per shard (P-ARPACK over the Dw-split, ED_DIAG.f90:151-171):
every rank runs the whole solve, holds only its dw rows of a sharded
sector's vectors, and meets the others in collectives outside the kernels.

- :mod:`.multihost` — the process group (:func:`~.multihost.init_multihost`),
  the rank's card, the lattice-site round robin, and a local launcher of
  ranks (:func:`~.multihost.run_local_ranks`);
- :mod:`.mesh` — the 1-D "dw" group and the only place collectives are
  written (fixed-order all-reduce, row all-gather, halo exchange, the
  dw-row <-> up-column transposes);
- :mod:`.bs_sharded` — the dw-sharded band-sparse matvec, kernel B5, and
  its two-stage ground state;
- :mod:`.production` — the mesh policy and the dw-sharded dense and
  direct operators the solver runs;
- :mod:`.matvec` — the sharded ELL matvec and :class:`ShardedLanczos`, the
  low-level engine and equality oracle.
"""
from .matvec import ShardedLanczos, shard_hamiltonian, sharded_matvec
from .mesh import make_mesh, pad_to_multiple
