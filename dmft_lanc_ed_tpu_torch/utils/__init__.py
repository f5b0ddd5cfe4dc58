"""Tracing, profiling and counters (port of ``dmft_lanc_ed_tpu/utils``).

The JAX package's ``host_device`` / ``on_host`` pin its small host math to
XLA's CPU backend; here that math is numpy or CPU torch already, so they
have no counterpart.
"""
from .observability import (KernelStats, Timer, kernel_stats, profile_trace,
                            spy_matrix, trace)
