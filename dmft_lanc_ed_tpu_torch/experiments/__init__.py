"""The experiment probes of the JAX package (``experiments/``), ported.

- :mod:`.chain_probe` (E1): a K-step power chain in one thread-block
  cluster, the vector in distributed shared memory;
- :mod:`.trim_ab` (E2a, E2b): the zero-tile trim structures of the
  per-call matvec, split-bf16 on the tensor cores;
- :mod:`.chain_breakdown` (E3): the Lanczos chain step's product forms.

They run on no solver path. Each has a ``main(device="cuda")`` and its
kernels in ``csrc/`` (``chain_probe.cu``, ``trim_ab.cu``,
``chain_breakdown.cu``; all three on the split-bf16 ``wgmma`` product of
``bs_panel_tc.cuh``).
"""
