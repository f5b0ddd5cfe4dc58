#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py [--phases 0,1,2,2s,3,3b,4,5,6,7,8,9,10,11,12,13,14,15,16]
                          [--ghost-tol X]

``--ghost-tol`` replaces ``ops.bs_chain._GHOST_TOL`` for the run: phases
4 and 5 then measure, over their band-sparse sectors (phase 5's loop 1:
all 109), whether every chain seed still reaches its eta_target with that
Ritz ghost-cluster tolerance.

Phases (all by default; each raises on failure and the script then exits
nonzero without a result line):

0. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; requires CUDA; TF32 off.
1. build the CUDA kernels from ``dmft_lanc_ed_tpu_torch/csrc`` (one nvcc
   per source, all started together; each one's seconds and warnings are
   printed, and ptxas's C7515, wgmma serialized, fails the phase), while
   the host ARPACK oracles of phases 2-7 and 9-16 run in two spawned
   processes and the two ranks of phases 7 and 15 start up. Phases 2s, 6,
   3's solve, 4 and 5 need no oracle and run before the wait on the
   first; then 3's gate, 2, 3b, 8 and 14 (the phases that time kernels),
   and then 9-13 and 16 beside the ranks' work for 7 and 15.
2. each kernel (B2 tridiag, B3 Chebyshev, B4 batched GF tridiag, B1 the
   per-call matvec, trimmed and whole-window) against its plain PyTorch
   version at the 854k-state (6,6) sector of nbath = 11, with the
   tolerances stated below, and the time per step or call of both. B2 and
   B3 (tensor cores, three-pass split-bf16 products) are held against
   their split plain versions, their distance to the true-f32 plain
   version is printed, and two reruns of each must be bit-identical. B4
   and B1 (tensor cores, six passes over a three-part split): one product
   of each against the f64 product (max|d| / max|H u| <= 1e-6 and <= 2x
   the FP32 product's of cuBLAS, ``_hv_plain`` with TF32 off, all
   printed); B4's chains against its plain version, reruns and a batch
   against each chain alone bit-identical, and the main path's own chain,
   c+_up|GS> in the (7,6) target, against the true-f32 plain version
   (G(iw) 2e-5); B4's row is timed on that chain.
2s. the kernels' time per step or call at shapes of the main path: B2 and
   B3 by CUDA events around back-to-back chains at the sectors (6,6),
   (5,4) and (3,4) of nbath = 11 (924 x 924, 792 x 495 and 220 x 495
   states, padded to 1024 x 1024, 896 x 512 and 256 x 512); B1a and B1b
   at the same sectors, and B5 (one of 2 shards) where the sector shards
   over 2 ranks ((6,6) alone), by graph replay; B4, 200 steps, by events,
   one chain at the GF target (7,6) (924 x 792, padded 1024 x 896), at
   (6,6) and at (3,4), two at (7,6) (the largest batch of phase 16's
   finite-T loops), and four and seven chains at (6,6) (seven: a
   susceptibility's batch in three orbitals, phase 11); each with its
   bound.
   Only the wrappers' public calls are timed, so the script run from a
   checkout of an earlier tree times that tree's kernels.
3. the two-stage ground state of that sector on the card (chain stage 1)
   against host ARPACK (scipy eigsh, tol 1e-13): |dE| <= 1e-10.
3b. the per-call path of that sector, as the JAX package's headline bench
   drives it: normalized power steps of ``chain_step`` (B1a), then the
   two-stage ground state with ``use_chain=False`` (f32 thick restart over
   B1b, then the mixed top-off and f64 polish): |dE| <= 1e-10 vs ARPACK,
   and both B1 forms must launch.
4. ``run_dmft`` of the one-orbital Bethe-lattice Hubbard model at
   nbath = 11, T = 0, one loop, on the card, sectors one by one
   (``ed_backend="pallas"``, ``ed_batch_sectors=False``), the loop's scan
   restricted by the sector hint (``ed_sectors``, shift 1) to the 9
   sectors around (6,6), the largest of the scan, and the 9 around (3,3);
   every chain kernel must launch in it, every chain seed must reach its
   eta_target (``seed_counts``), outputs must be finite, 0 <= dens <= 2,
   and loop 1's Egs must equal phase 3's energy to 1e-9; the chains each
   B4 launch carried are printed.
5. the default configuration: phase 4's ``run_dmft`` with
   ``ed_backend="auto"`` and ``ed_batch_sectors`` left at True (small
   sectors solved in batched buckets), 2 loops (loop 1 the full 169-sector
   scan, loop 2 the restricted scan around loop 1's ground state); at
   least one bucket solved, every chain kernel launched, loop 1's energies
   of phase 4's Krylov sectors equal phase 4's to 1e-9 x max(1, |E|), six
   of them batched here, loop 1's Egs equal phase 3's to 1e-9, outputs
   finite, 0 <= dens <= 2.
6. B5, the dw-sharded matvec, in one process at the 854k sector split over
   n = 2 shards whose halo'd rows are sliced from the whole vector: each
   shard against its plain version (y within 1e-5 x max|y|, panel sums of
   squares 1e-5 relative), the stitched shards against B1b bit for bit,
   and the time per call of both (the kernel by graph replay).
7. two ranks sharing the card (spawned once, at the start, for phases 7
   and 15; gloo transport staged through host memory), the main path: one
   ``EDSolver.solve`` at nbath = 11 with ``mesh_shape=(2,)`` restricted to
   the ground-state sector (6,6) (``ed_sectors``, shift 0), one state. Its
   diag is the 854k sector's dw-sharded two-stage ground state (B5 under
   the f32 thick restart, then the top-off and f64 polish over the sharded
   dense operator): Egs within 1e-9 of phase 3's ARPACK energy and of
   phase 3's solve, G(iw) and Sigma(iw) against the one-rank solve of the
   same bath and sector (gates below), B5 (the diag) and the sharded dense
   GF route (the (7,6) and (5,6) targets) run on both ranks, both ranks'
   results identical. Times are two ranks time-sliced on one card, not a
   multi-card number.
8. the experiment probes E1-E3 (``dmft_lanc_ed_tpu_torch/experiments``),
   which run on no solver path: (a) E1, the power chain in one cluster
   launch of 16 CTAs, at K = 7 and 71, against its six-pass plain version
   and against the f32 chain within the probe's gates (norms 1e-5, vout
   1e-4 relative), reruns
   bit-identical, one launch a call; the time a step at K = 7, the marginal
   step (K = 7 vs 71) and the intercept (the launch and the load of A), a
   step's split by the kernel's clock trace (product, exchange, barrier,
   rest), the cluster's CTAs, shared memory and registers, both bounds
   (six-pass tensor and FP32) and B2's step at the SHAPES of phases 2 and
   2s; (b) E2's five forms (the tile lists in four
   modes, the trim runs) at the 854k sector against the plain version (y
   within 1e-5 x max|y|, panel sums of squares 1e-5 relative) and
   bit-identical to each other; (c) E3's five product forms, m = 96,
   each against its plain version with phase 2's B2 gate (first 16
   alpha/beta within 1e-4 x max(1, |alpha|max)), tileskip bit-identical
   to 3pass (it skips zero tiles only) and bf16pair's first 16 within that
   gate of 3pass's; the time per call or step of every form beside B1's
   and B2's, and the kernel launches per E2 call and E3 step; then the
   main path of this slice, the three probes' ``main()``, with their
   launch counts set to 0 just before and read just after (E3 must run
   two kernel launches a step). Times come from
   ``experiments.timing.device_ms``, which holds the stream while the
   host enqueues, so they are device time without the host's.
9. the hybrid and replica baths with the off-diagonal GF, at 853,776
   states: (a) hybrid10-854k, one ``EDSolver.solve`` of a hybrid bath
   (norb = 2, nbath = 10, off-diagonal hloc) restricted to the sector
   (6,6), one state: Egs against host ARPACK of that sector (1e-10), B2,
   B3 and B4 launched, each B4 launch carrying the 3 chains of its target
   (c+_0, c+_1 and the mixed c+_0 + c+_1), the mixed chain into (7,6)
   through B4 against the true-f32 plain chain (G(iw) 2e-5, phase 2's
   gate), the pole weights of each off-diagonal channel summing to 0 and
   of each diagonal one to 1 (1e-9; an exact identity of any chain),
   G_01 == G_10, Sigma finite; G(iw) within B4's contract (2e-5 x
   max|G|) of the f64 chains from the same state and start vectors (every
   chain through the f64 scan over its target's exact apply,
   ``f64_reference``), and G(w) and Sigma(w), at eps = 0.01 on the solve's
   real grid, through the real-axis gate (``real_axis_check``: at the
   points where the f64 chain has converged, REAL_BARS; over the grid,
   B4's distance and the f64 chain's own spread between 150 and 200 steps
   printed); (b) bhz5-replica, ``models.bhz_2d.run_dmft``
   (norb = 2, nspin = 2, nbath = 5, a replica bath over the 4 symmetries
   of the BHZ hloc, nk = 20) in the default configuration, one loop, its
   scan restricted by the sector hint to the 18 sectors around the ground
   state's pair (5,7) and (7,5): its
   Egs against host ARPACK of the ground-state sector (1e-9), every chain
   seed at its eta_target, B2, B3 and B4 launched, every B4 launch
   carrying more than one chain, the pole-weight identities, 0 <= dens <=
   2, Sigma finite, a finite fitted bath of the replica layout; the
   loop's diag / gf / fit seconds, the launches, steps and chains per B4
   launch, and the (6,6) op's window and B2/B3 tile are printed.
10. the three-orbital Kanamori driver at 853,776 states:
   ``models.multiorb_kanamori.run_dmft`` at its main() model (norb = 3,
   uloc 2.5, ust 1.5, jh 0.5, Jx = Jp = 0, no crystal field) with nbath =
   3, so that the half-filled (6,6) sector holds 924^2 states, T = 0, one
   loop, in the default configuration (``ed_backend="auto"``, batched
   small sectors): the (6,6) sector band-sparse (its ACA-separable
   diagonal; its windows, diagonal rank and trim share printed, the op
   built on the host in phase 1's thread), every sector above
   ``ed_batch_dim_max`` through the chain seed and every seed at its
   eta_target, B2, B3 and B4 launched, at least one bucket solved; the
   lowest (6,6) energy of the solve's ``diag_log`` against host ARPACK of
   that sector at the same initial bath (1e-10); outputs finite, 0 <= dens
   <= 2, the three orbitals' dens and docc equal to 1e-6;
   ``timings["kernel_matvecs"]`` at least the chain steps of the loop;
   then ``io.write_all`` and the loop's fit again with its diagnostic
   files into a temporary directory: ``read_gf_files`` gives back
   Sigma(iw) to 1e-8 (9 decimals written), ``EDSolver.restore`` the fitted
   bath to 1e-11 (12 decimals) and a ``neigen_sector`` equal to the state
   list's per-sector counts. The loop's diag / gf / fit seconds and the
   phase's are printed beside the card's name and power limit.
11. the spin and charge susceptibilities of phase 10's model at 853,776
   states: one ``EDSolver.solve`` at the initial bath with
   ``chispin_flag`` and ``chidens_flag``, restricted to (6,6)
   (``ed_sectors``, shift 0), the default configuration: Egs against
   phase 10's host ARPACK (1e-10); for k states the chains of each B4
   launch are 3k, 3k (the GF), 7k, 7k (each kind: 3 diagonal, 3 mixed, the
   total), every chi chain through B4; orbital 0's and the total channel
   of each kind against the same start vectors through the f64 Lanczos
   scan over the f64-exact band apply: chi(iv_n), n < 64, within 2e-5 x
   max|chi| (B4's GF contract), and the real axis through the real-axis
   gates (phase 9(a)) against f64 chains of 200 and 150 steps, tau
   printed; beta times
   the lowest Ritz value's distance to E of the whole n|psi> chain, by B4
   and by f64, printed (the dE = 0 pole, which the solve stores exactly,
   against the iv_0 cut of 1e-3); the three orbitals' chi_aa equal to
   1e-6 relative, the chi_ab (a != b) to 2e-5 x max|chi_aa| (each is
   (chi_mix - chi_aa - chi_bb) / 2 of three B4 channels: B4's contract),
   chi_ab the same object as chi_ba, chi_aa(iv_0) > 0; ``io.write_all``'s spinChi / densChi files
   (60) read back within their 9 decimals.
12. phonons, Jx/Jp and full ED on the dense path (cuBLAS, no hand
   kernel), each solve restricted to the 9 sectors around the half-filled
   one: (a) holstein7 (norb 1, nbath 7, nph 10, g 0.5, w0 0.8; (4,4) holds
   53,900 states) and (b) kanamori2-jxjp (norb 2, nbath 4, uloc 2, ust 1,
   jh = jx = jp = 0.5; (5,5) holds 63,504), T = 0: the default
   configuration's Egs against host ARPACK of the ground-state sector
   with every sector term (1e-10); an f64 solve with batched buckets
   against one without (|dEgs| 1e-9, dens 1e-8, G(iw) 1e-7: the JAX
   test's gates, test_features.py:test_batched_scan_finite_t_and_phonons;
   the default mixed solve's distance to them printed); holstein7's
   phonon occupations summing to 1 (1e-8) and its displacement GF set;
   (c) full ED (norb 1, nbath 3, beta 10) against the finite-T Krylov
   solve of every state on the card in f64: Egs 1e-9, G(iw) 1e-5, dens
   1e-6, chi(iv) 1e-8. Each part's seconds are printed.
13. the lattice bank at 853,776 states: ``models.hm_2b_afo.run_dmft``, the
   two-band model of tests/test_dmft.py:106 (uloc 1, ust 0.25, sb_field
   0.1, wband (1, 0.5), delta 0) at nbath = 5, T = 0, one loop, two
   inequivalent sites on the card in the default configuration: site B's
   initial bath is site A's spin flip, so host ARPACK of site A's (6,6)
   (built in phase 1's thread) is both sites' oracle: each site's lowest
   (6,6) energy in its ``diag_log`` within 1e-10; mag_A = -mag_B within
   1e-6; dens = 1 within 1e-6; every chain seed at its eta_target; B2, B3
   and B4 launched; both sites on a CUDA device; finite outputs; the
   loop's per-site fit again with its files (suffixes _ineq0001,
   _ineq0002) into a temporary directory. Each site's diag / gf / fit
   seconds are printed beside the card's name and power limit.
14. the ELL, direct and Davidson backends at phase 3's sector: the ELL and
   the direct applies against the f64-exact band apply on 3 random
   vectors (max|d| / max|Hv| <= 1e-12) and their ms an apply (torch ops,
   no kernel row); the f64 Lanczos ground state over each and Davidson
   over ELL against ARPACK (1e-10); then two ``EDSolver.solve`` restricted
   to (6,6), one state: ``ed_sparse_h=False`` (the log must show the
   direct backend) and ``lanc_method="dvdson"`` in the default
   configuration (Davidson over the band-sparse mixed apply, then the f64
   polish), each Egs within 1e-10.
15. sharded2-a10: the two ranks of phase 7, sharing the card over gloo,
   for three parts (torch ops and collectives, no kernel row): (a)
   direct854k-sharded2, phase 3's sector under the
   sharded direct backend: the stitched apply of 2 random vectors against
   the one-card f64 band apply (max|d| / max|Hv| <= 1e-12), pad rows
   exactly 0, each rank's op payload under half the dense hdw's bytes;
   the restricted solve (``ed_sparse_h=F``, (6,6), one state): its
   sharded f64 ground state against phase 3's ARPACK (1e-10), the solve
   against the one-rank solve of phase 14 (Egs 1e-10, G(iw) 1e-9, dens
   1e-10), sharded direct applies in both its diag and its GF; (b)
   jxjp2-854k-sharded2,
   norb 2, nbath 5, uloc 2, ust 1, jh = jx = jp = 0.5 ((6,6) holds 853,776
   states), the default configuration restricted to (6,6), one state: the
   log shows the band-sparse shard path refused and the sharded dense
   backend taken, Egs of the two ranks and of the one-rank solve against
   host ARPACK with every sector term (1e-12: the mixed solve's f64
   polish), G(iw) and Sigma(iw) against the one-rank solve (phase 7's
   gates);
   (c) holstein7-sharded2, phase 12(a)'s model in f64 over the 9 sectors
   around (4,4): the three dim_dw = 70 sectors sharded, the rest batched,
   Egs against phase 12's ARPACK (1e-10), G(iw) and the phonon GF against
   the one-rank solve (1e-9). Each part's seconds, ms an apply and
   collective ms (rows_to_cols + cols_to_rows, or the row all-gather) are
   printed; both ranks' results identical.
16. bethe11-finite-t: phase 5's ``run_dmft`` in the default configuration
   at finite T (beta = 100, the repo's inputED.conf; ten states, two a
   sector, the spin susceptibility), two loops, each loop's scan restricted
   by the sector hint to the 9 sectors around (6,6) (``P16_HINT``; set to
   () by import, all of them): loop 1's k = 2 lowest (6,6) energies against
   host ARPACK at k = 2 (phase 3's oracle; 1e-10); every chain kernel
   launched and every chain seed at its eta_target; each loop's weights
   summing to Z (1e-12), its thermal G(iw) and chi_spin(iv_n), n < 64,
   within B4's contract (2e-5 x max|f|) of the f64 chains from the same
   states and start vectors, and G(w), Sigma(w) and chi_spin(w) through the
   real-axis gate (phase 9(a)); loop 2's starting neigen_sector and
   lanc_nstates_total, the states it solved each sector for and its list's
   capacity equal to ed_post_diag's rule (``post_diag_rule``) applied to
   loop 1's list; each loop's diag, gf, chi and fit seconds; B4's launches
   and its largest batch (two chains, which phase 2s times at (7,6)).

The chain kernels' launches and steps of the kernel line are those of
phases 4, 5, 9, 10, 11, 13, 14 and 16. Each phase's seconds (and the waits on
the host oracles) are printed, a line each, before the kernel table, with
the seconds and calls of the f64 polish (``ops.lanczos.polish_counts``)
in it.

The line before the last is the kernel table as JSON. Each kernel's bound
is the larger of its FP32 operations over 67 TFLOP/s and its bytes, each
input read once and each output written once, over 3.35 TB/s (the
published H100 SXM peaks), both counted over the nonzero 128 x 128 window
tiles of the op (its trim runs), the tiles the product needs; B2, B3, E2
and E3 count their split-bf16 products at the 989 TFLOP/s dense bf16
tensor-core peak (three passes, E3's 1pass one over the same bytes; the
rest FP32), B1, B4, B5 and E1 their six passes there.
A chain kernel's
``launches`` are chain launches and its ``steps`` the steps they ran
(phases 4, 5, 9, 10, 11, 13, 14 and 16 for B2-B4); its ``ms`` is per step. The last line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import multiprocessing

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHAIN_TC_SRC = "dmft_lanc_ed_tpu_torch/csrc/bs_chain_tc.cu"
MATVEC_SRC = "dmft_lanc_ed_tpu_torch/csrc/bs_matvec.cu"
TRIM_SRC = "dmft_lanc_ed_tpu_torch/csrc/trim_ab.cu"
SOURCE = {"tridiag": CHAIN_TC_SRC, "cheb": CHAIN_TC_SRC,
          "gf_tridiag": CHAIN_TC_SRC,
          "matvec_runs": MATVEC_SRC, "matvec_full": MATVEC_SRC,
          "sharded_matvec": MATVEC_SRC,
          "chain_probe": "dmft_lanc_ed_tpu_torch/csrc/chain_probe.cu",
          "trim_tiles": TRIM_SRC, "trim_static_runs": TRIM_SRC,
          "chain_breakdown": "dmft_lanc_ed_tpu_torch/csrc/chain_breakdown.cu"}
REPLACES = {"tridiag": "dmft_lanc_ed_tpu/ops/bs_chain.py:207",
            "cheb": "dmft_lanc_ed_tpu/ops/bs_chain.py:331",
            "gf_tridiag": "dmft_lanc_ed_tpu/ops/bs_chain.py:540",
            "matvec_runs": "dmft_lanc_ed_tpu/ops/blocksparse.py:572",
            "matvec_full": "dmft_lanc_ed_tpu/ops/blocksparse.py:469",
            "sharded_matvec": "dmft_lanc_ed_tpu/parallel/bs_sharded.py:67",
            "chain_probe": "experiments/chain_probe.py:33",
            "trim_tiles": "experiments/trim_ab.py:79",
            "trim_static_runs": "experiments/trim_ab.py:214",
            "chain_breakdown": "experiments/chain_breakdown.py:79"}
NBATH = 11
HALF = (NBATH + 1) // 2   # the half-filled sector (6,6)
DEVICE = "cuda"
# phase 2s: sectors of nbath = 11 whose shapes the main path runs most
SHAPES = ((HALF, HALF), (5, 4), (3, 4))
# ... and for B4: the GF target (7,6) of the ground state (6,6), (6,6) and
# (3,4); 200 steps (the main path's lanc_ngfiter)
GF_SHAPES = ((HALF + 1, HALF), (HALF, HALF), (3, 4))
GF_STEPS = 200
NSHARD = 2                # phases 6 and 7: ranks of the dw split
PEAK_FP32 = 67e12         # FLOP/s, H100 SXM outside the tensor cores
PEAK_BF16 = 989e12        # FLOP/s, H100 SXM tensor cores, dense bf16
PEAK_BYTES = 3.35e12      # bytes/s, H100 SXM HBM3
# phase 7 gates, sharded vs one-rank G(iw) and Sigma(iw). The JAX
# test's 1e-9 and 1e-7 compare two f64 solves; here the one-rank solve runs
# its large GF targets through the chain kernel B4 (f32 vectors, six-pass
# products of f32 fidelity) and the sharded one through the mixed-precision
# dense scan, so G agrees to an f32 chain's ~5e-6 (phase 2 gates B4 on
# c+|GS> at 2e-5 against the true-f32 chain) and Sigma = G0^-1 - G^-1 to
# ~10x that; the gates leave a 4x margin
P7_G_TOL = 2e-5
P7_SIGMA_TOL = 2e-4
# the card's name and power limit as nvidia-smi gives them (phase 0),
# printed beside the phases' seconds
CARD = "card not read"
# seconds of each phase in this run (and of the waits on the host oracles)
PHASE_S = {}
ORACLE_PROCS = 2          # processes of the host ARPACK oracles ...
ORACLE_THREADS = "1"      # ... and the BLAS / torch threads of each


def say(*a):
    print(*a, flush=True)


# seconds and calls of the f64 polish (ops.lanczos.polish_counts) by phase:
# the share of the k = 2 sectors' polish in a phase's seconds (ROADMAP C9)
PHASE_POLISH = {}


@contextlib.contextmanager
def timed(name):
    """Add the seconds of the block to PHASE_S[name], and the f64 polish's
    seconds and calls in it to PHASE_POLISH[name]."""
    from dmft_lanc_ed_tpu_torch.ops.lanczos import polish_counts
    t0 = time.perf_counter()
    p0 = dict(polish_counts)
    try:
        yield
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
        s_, c_ = PHASE_POLISH.get(name, (0.0, 0))
        PHASE_POLISH[name] = (s_ + polish_counts["s"] - p0["s"],
                              c_ + polish_counts["calls"] - p0["calls"])


def cuda_ms(fn, reps=1):
    """Device milliseconds per fn() over `reps` calls after a warm-up, by
    CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(flops, nbytes):
    """(least ms, "operations" or "bytes"): the larger of the FP32
    operations over the card's peak and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_tc(tc_flops, fp32_flops, nbytes):
    """(least ms, "operations" or "bytes") of a split-bf16 kernel: the
    larger of its tensor-core products over the bf16 peak, its FP32
    operations over the FP32 peak, and its bytes over the memory rate."""
    t_ops = max(tc_flops / PEAK_BF16, fp32_flops / PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hop_flops(pop, dw_tiles, up_tiles):
    """Operations of one pass of the hop products of an H_p u over the
    whole padded grid, dw_tiles / up_tiles 128 x 128 window tiles."""
    ddp, dup = pop.padded_shape
    return 2 * 128 * 128 * (dup * dw_tiles + ddp * up_tiles)


def kept_tiles(pop, panels=slice(None)):
    """(dw, up) nonzero 128 x 128 window tiles of the dw panels `panels`
    and of every up panel (the op's trim runs): the tiles an H u over
    those panels' rows needs, whatever the kernel's windows."""
    dw_runs, up_runs = pop.trim_runs
    return tuple(sum(t1 - t0 for runs in rr for t0, t1 in runs)
                 for rr in (dw_runs[panels], up_runs))


def op_bytes(pop, rows, dw_tiles, up_tiles):
    """Bytes of the nonzero slab tiles and of the diagonal factors of
    `rows` rows, f32."""
    dup = pop.padded_shape[1]
    rank = pop.diag_a.shape[1]
    return 4 * (128 * 128 * (dw_tiles + up_tiles) + rows * rank + rank * dup)


def matvec_bound(pop, rows, dw_tiles, up_tiles, vec_bytes):
    """(least ms, bound by) of one B1 call (rows = ddp) or one B5 shard's
    (rows = its rows): six bf16 tensor-core passes over the nonzero window
    tiles its rows need (dw_tiles of its panels, up_tiles of every up
    panel), the diagonal and the epilogue in FP32, and the bytes of those
    tiles' three-part slabs (6 bytes an element), of the diagonal factors
    and of the vectors (vec_bytes)."""
    dup = pop.padded_shape[1]
    rank = pop.diag_a.shape[1]
    hop = 2 * 128 * 128 * (dup * dw_tiles + rows * up_tiles)
    nbytes = (6 * 128 * 128 * (dw_tiles + up_tiles)
              + 4 * (rows * rank + rank * dup) + vec_bytes)
    return bound_tc(6 * hop, (2 * rank + 6) * rows * dup, nbytes)


def chain_bounds(pop, m, kk):
    """(B2's bound per step of an m-step chain, B3's of a kk-step chain),
    each (least ms, bound by): three bf16 tensor-core passes over the
    nonzero window tiles, the diagonal and the recurrence in FP32 (B2 ~12,
    B3 ~8 operations an element), the split slabs (as many bytes as the f32
    slabs) and the start vector once a call."""
    ddp, dup = pop.padded_shape
    rank = pop.diag_a.shape[1]
    tiles = kept_tiles(pop)
    hop = hop_flops(pop, *tiles)
    vec = 4 * ddp * dup
    slabs = op_bytes(pop, ddp, *tiles)
    b2 = bound_tc(3 * hop, (2 * rank + 12) * ddp * dup,
                  (slabs + vec) / m + 8)
    b3 = bound_tc(3 * hop, (2 * rank + 8) * ddp * dup,
                  (slabs + 2 * vec) / kk)
    return b2, b3


def gf_bound(pop, m, nb):
    """(least ms, bound by) of a B4 step of nb chains in an m-step launch:
    six bf16 tensor-core passes over the nonzero window tiles a chain, the
    diagonal and the recurrence in FP32 (~12 operations an element), the
    three-part slabs (6 bytes an element) and the diagonal once a launch,
    each start vector once, alpha and beta out."""
    ddp, dup = pop.padded_shape
    rank = pop.diag_a.shape[1]
    tiles = kept_tiles(pop)
    slabs = 6 * 128 * 128 * sum(tiles) + 4 * rank * (ddp + dup)
    return bound_tc(nb * 6 * hop_flops(pop, *tiles),
                    nb * (2 * rank + 12) * ddp * dup,
                    (slabs + nb * 4 * ddp * dup) / m + 16 * nb)


def oracle_pool():
    """ORACLE_PROCS spawned processes for the host oracles, each limited to
    ORACLE_THREADS threads and run at the lowest priority, so that the
    host-bound phases keep the cores they ask for (and, unlike a thread,
    the oracles hold no GIL of this process)."""
    keys = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: ORACLE_THREADS for k in keys})
    try:
        return multiprocessing.get_context("spawn").Pool(
            ORACLE_PROCS, initializer=os.nice, initargs=(19,))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def hv_f64(pop, u):
    """H_p u in f64 over the f32 operator values the kernels multiply."""
    d = pop.diag_a.double() @ pop.diag_b.double()
    u = u.double()
    return d * u + pop.hdw_p32.double() @ u + u @ pop.hup_p32.double()


def phase0():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    say(smi.stdout.strip())
    # one line a card; the cards of one host share name and limit
    CARD = "; ".join(dict.fromkeys(smi.stdout.strip().splitlines()))
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase1():
    from dmft_lanc_ed_tpu_torch import _kernels
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.lib()
    each = ", ".join(f"{k} {v:.1f} s" for k, v in sorted(
        _kernels.build_seconds.items(), key=lambda kv: -kv[1]))
    say(f"phase 1: built {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s ({each or 'cached'})")
    warned = _kernels.build_warnings
    for src, lines in sorted(warned.items()):
        for ln in lines:
            say(f"  nvcc {src}: {ln}")
    if any("C7515" in ln for lines in warned.values() for ln in lines):
        raise AssertionError("ptxas serialized wgmma (C7515)")


_SECTORS = {}


def sector_854k(sqn=(HALF, HALF)):
    """cfg, sector, host Hamiltonian and the band-sparse op on the card
    (the 854k-state sector (6,6) by default), built once a run."""
    if sqn in _SECTORS:
        return _SECTORS[sqn]
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
    cfg = pt.EDConfig(norb=1, nbath=NBATH, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                    pt.init_bath(cfg))
    t0 = time.perf_counter()
    op = build_blocksparse_op(h, DEVICE)
    say(f"sector {tuple(sqn)}: dim {sec.dim}, padded {op.padded_shape}, "
        f"W_dw {op.pop.w_dw}, W_up {op.pop.w_up}, rank "
        f"{op.pop.diag_a.shape[1]}, op built in "
        f"{time.perf_counter() - t0:.2f} s")
    _SECTORS[sqn] = cfg, sec, h, op
    return _SECTORS[sqn]


def host_ground_state(h, sec, label="", k=1):
    """Host ARPACK ground state of the assembled CSR (bench.py's oracle),
    every sector term in it: the hops and the diagonal, the Jx/Jp tensor
    products sum_t B_t (x) A_t, and with phonons w0 n_ph (x) 1 and
    X_ph (x) E_eph, as scipy.sparse Kronecker products over the sector's
    (phonon, dw, up) index. Returns (E0, its vector, the k lowest
    energies)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    def factor_csr(cols, vals, n):
        rows = np.repeat(np.arange(n), cols.shape[1])
        m = sp.csr_matrix((np.asarray(vals, np.float64).ravel(),
                           (rows, np.asarray(cols).ravel())), shape=(n, n))
        m.eliminate_zeros()
        return m
    t0 = time.perf_counter()
    du, dd = sec.dim_up, sec.dim_dw
    hfull = (sp.kron(sp.identity(dd, format="csr"),
                     factor_csr(h.up_cols, h.up_vals, du))
             + sp.kron(factor_csr(h.dw_cols, h.dw_vals, dd),
                       sp.identity(du, format="csr"))
             + sp.diags(np.asarray(h.diag, np.float64).ravel())).tocsr()
    if h.nd_up_src is not None:
        for t in range(h.nd_up_src.shape[0]):
            hfull = hfull + sp.kron(
                factor_csr(np.asarray(h.nd_dw_src[t])[:, None],
                           np.asarray(h.nd_dw_val[t])[:, None], dd),
                factor_csr(np.asarray(h.nd_up_src[t])[:, None],
                           np.asarray(h.nd_up_val[t])[:, None], du))
    if h.ph_diag is not None:
        dp = len(h.ph_diag)
        hfull = (sp.kron(sp.identity(dp), hfull)
                 + sp.kron(sp.diags(np.asarray(h.ph_diag, np.float64)),
                           sp.identity(dd * du))
                 + sp.kron(sp.csr_matrix(np.asarray(h.eph_x, np.float64)),
                           sp.diags(np.asarray(h.eph_el,
                                               np.float64).ravel())))
    w, v = spl.eigsh(hfull.tocsr(), k=k, which="SA", tol=1e-13)
    order = np.argsort(w)
    w, v = w[order], v[:, order]
    say(f"host ARPACK{label}: E0 = {w[0]:+.12f}"
        + (f", the {k} lowest {[f'{x:+.12f}' for x in w]}" if k > 1 else "")
        + f" ({time.perf_counter() - t0:.1f} s)")
    return float(w[0]), v[:, 0], w


def _tridiag_eigs(al, be):
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    return np.linalg.eigh(t)


# the frequencies on which the GF chains' G(iw) are compared
GF_Z = 1j * np.linspace(0.05, 3.0, 20)


def g_cf(al, be, shift=0.0):
    """G(iw) on GF_Z of a chain's alpha, beta, poles shifted by `shift`."""
    th, s = _tridiag_eigs(al, be)
    return (s[0] ** 2 / (GF_Z[:, None] - (th - shift))).sum(1)


def _gf_chain_vs_plain(op_j, vv, e0, m):
    """B4 on one chain from the natural-order start vv (normalized here)
    in op_j's sector -> (the padded start [1, ddp, dup], G(iw) of the
    kernel, of the six-pass plain version and of the true-f32 plain
    version, poles shifted by e0)."""
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import _hv_plain, to_padded
    vv = vv / np.linalg.norm(vv)
    vp = to_padded(op_j, vv.reshape(1, op_j.dim_dw, op_j.dim_up))
    gs = []
    for al, be in (bc.gf_tridiag_call(op_j, vp, m),
                   bc.gf_tridiag_batch_plain(op_j.pop, vp, m),
                   bc.tridiag_chain_plain(op_j.pop, vp, m, hv=_hv_plain)):
        gs.append(g_cf(al[0].cpu().numpy(), be[0].cpu().numpy(), e0))
    return (vp, *gs)


def _physical_gf_chain(v_gs, e0, m):
    """B4 on the main path's own chain: c^+_up |GS> in the (HALF+1, HALF)
    target sector -> (its op, and _gf_chain_vs_plain's results)."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.gf import apply_op
    cfg, sec_j, _, op_j = sector_854k((HALF + 1, HALF))
    sec_i = pt.SectorTable(cfg).sector(pt.qn(HALF, HALF))
    vv = apply_op(cfg, sec_i, sec_j, v_gs, 0, 0, True)
    return (op_j, *_gf_chain_vs_plain(op_j, vv, e0, m))


def phase2(op, e0, v_gs):
    """Each chain kernel against its plain version on the same inputs."""
    import torch
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import (_hv_plain,
                                                        from_padded,
                                                        to_padded)
    pop = op.pop
    rng = np.random.default_rng(2024)

    def start(n):
        """n normalized random starts, permuted padded f32 on the card."""
        v = rng.standard_normal((n, op.dim_dw, op.dim_up))
        v /= np.linalg.norm(v.reshape(n, -1), axis=1)[:, None, None]
        return to_padded(op, v)
    rows = []

    # B2 (tensor cores, split-bf16 products) against its split plain
    # version: m = 96, first 16 alpha/beta within 1e-4 * max(1, |alpha|max);
    # extreme Ritz values within 1e-4 * span. Both sides run the same
    # product form, so they differ by summation order only; the distance to
    # the true-f32 plain version is what the product form costs (printed).
    m = 96
    v0 = start(1)[0]
    al_k, be_k = bc.tridiag_call(op, v0, m)
    al_r, be_r = bc.tridiag_call(op, v0, m)
    if not (torch.equal(al_k, al_r) and torch.equal(be_k, be_r)):
        raise AssertionError("two runs of B2 on one input differ")
    al_p, be_p = bc.tridiag_chain_plain(pop, v0[None], m)
    al_f, be_f = bc.tridiag_chain_plain(pop, v0[None], m, hv=_hv_plain)
    al_k, be_k = al_k.cpu().numpy(), be_k.cpu().numpy()
    al_p, be_p = al_p[0].cpu().numpy(), be_p[0].cpu().numpy()
    al_f, be_f = al_f[0].cpu().numpy(), be_f[0].cpu().numpy()
    scale = max(1.0, np.abs(al_p).max())
    err = max(np.abs(al_k[:16] - al_p[:16]).max(),
              np.abs(be_k[:16] - be_p[:16]).max())
    err_f = max(np.abs(al_k[:16] - al_f[:16]).max(),
                np.abs(be_k[:16] - be_f[:16]).max())
    th_k, _ = _tridiag_eigs(al_k, be_k)
    th_p, s_p = _tridiag_eigs(al_p, be_p)
    th_f, _ = _tridiag_eigs(al_f, be_f)
    span = th_p[-1] - th_p[0]
    ritz_err = max(abs(th_k[0] - th_p[0]), abs(th_k[-1] - th_p[-1]))
    ritz_f = max(abs(th_k[0] - th_f[0]), abs(th_k[-1] - th_f[-1]))
    say(f"B2 tridiag m={m}: max|d alpha,beta|[:16] = {err:.3e} "
        f"(tol {1e-4 * scale:.3e}); extreme Ritz diff {ritz_err:.3e} "
        f"(tol {1e-4 * span:.3e}); reruns bit-identical; vs the f32 plain "
        f"version: alpha,beta[:16] {err_f:.3e}, extreme Ritz {ritz_f:.3e}")
    if not (err <= 1e-4 * scale and ritz_err <= 1e-4 * span):
        raise AssertionError("B2 kernel disagrees with its plain version")
    b2, b3 = chain_bounds(pop, m, bc._bucket_k(128))
    ms_k = device_ms(lambda: bc.tridiag_call(op, v0, m), 1, 3) / m
    ms_p = cuda_ms(lambda: bc.tridiag_chain_plain(pop, v0[None], m)) / m
    rows.append(("tridiag", err, ms_k, ms_p, *b2))

    # B3: m = 128 with a filter window from the B2 Ritz bounds; filtered
    # vectors' relative difference <= 1e-3, ground-state overlaps to 1e-4
    # the window ground_state_seed would take: cut inside the gap to the
    # first Ritz value outside the theta_0 ghost cluster
    distinct = th_p[th_p > th_p[0] + bc._GHOST_TOL * span]
    gap = distinct[0] - th_p[0]
    b = th_p[-1] + 1e-3 * span
    cut = th_p[0] + 0.35 * gap
    c, e = 0.5 * (b + cut), 0.5 * (b - cut)
    kk = bc._bucket_k(128)
    c32, ie32 = float(np.float32(c)), float(np.float32(1.0 / e))
    vk, nk = bc.cheb_call(op, v0, kk, c32, ie32)
    vr, nr = bc.cheb_call(op, v0, kk, c32, ie32)
    if not (torch.equal(vk, vr) and torch.equal(nk, nr)):
        raise AssertionError("two runs of B3 on one input differ")
    vp, npn = bc.cheb_chain_plain(pop, v0, kk, c32, ie32)
    vf, nf = bc.cheb_chain_plain(pop, v0, kk, c32, ie32, hv=_hv_plain)
    vk = vk / nk.float()
    vp = vp / npn.float()
    vf = vf / nf.float()
    rel = float(torch.linalg.vector_norm(vk - vp)
                / torch.linalg.vector_norm(vp))
    rel_f = float(torch.linalg.vector_norm(vk - vf)
                  / torch.linalg.vector_norm(vf))
    gs = torch.as_tensor(v_gs, device=DEVICE)

    def overlap(vpad):
        vn = from_padded(op, vpad, torch.float64).reshape(-1)
        return abs(float(vn @ gs) / float(torch.linalg.vector_norm(vn)))
    ov_k, ov_p = overlap(vk), overlap(vp)
    say(f"B3 cheb m={kk}: rel diff {rel:.3e} (tol 1e-3); GS overlap "
        f"kernel {ov_k:.8f} plain {ov_p:.8f} (start "
        f"{overlap(v0):.3e}, tol 1e-4); reruns bit-identical; vs the f32 "
        f"plain version: rel diff {rel_f:.3e}, GS overlap {overlap(vf):.8f}")
    if not (rel <= 1e-3 and abs(ov_k - ov_p) <= 1e-4):
        raise AssertionError("B3 kernel disagrees with its plain version")
    vdiff = float((vk - vp).abs().max())
    ms_k = device_ms(lambda: bc.cheb_call(op, v0, kk, c, 1.0 / e), 1, 3) / kk
    ms_p = cuda_ms(lambda: bc.cheb_chain_plain(pop, v0, kk, c, 1.0 / e)) / kk
    rows.append(("cheb", vdiff, ms_k, ms_p, *b3))

    # B4 and B1 (tensor cores, six passes over a three-part split).
    # (a) The per-matvec contract: one product of B4's kernel and one of
    # B1b (scale 1) against the f64 product of the same u over the same f32
    # operator values, beside the FP32 product of cuBLAS (``_hv_plain``,
    # dense padded f32 factors, TF32 off) and B2/B3's three-pass product
    # (one B3 step with c = 0, e = 1) on the same vector: max|d| / max|H u|
    # <= 1e-6 and <= 2x the FP32 product's. Three-part fidelity shows as
    # ~1e-7; two-part as ~1e-5.
    from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
    u = start(1)[0]
    ref = hv_f64(pop, u)
    top = float(ref.abs().max())

    def rel(y):
        return float((y.double() - ref).abs().max()) / top
    e6 = rel(bc._run_hv_tc(pop, u))
    e1 = rel(bs._matvec_padded(op, u, 1.0, trim=False)[0])
    e32 = rel(_hv_plain(pop, u))
    e3 = rel(bc._run_cheb_tc(pop, u, 1, 0.0, 1.0)[0])
    say(f"product vs f64: B4 six-pass {e6:.3e}, B1b six-pass {e1:.3e}, "
        f"FP32 cuBLAS (_hv_plain) {e32:.3e}, three-pass (B3) {e3:.3e} of "
        f"max|H u| {top:.3e} (six-pass: tol 1e-6 and <= 2x FP32 = "
        f"{2 * e32:.3e})")
    if not (e6 <= 1e-6 and e6 <= 2 * e32):
        raise AssertionError("B4's product misses the per-matvec contract")
    if not (e1 <= 1e-6 and e1 <= 2 * e32):
        raise AssertionError("B1's product misses the per-matvec contract")
    # (b) 4 chains, m = 200 (the main path's lanc_ngfiter), against the
    # six-pass plain version: the first 8 alpha/beta within 5e-5 * scale,
    # and the continued-fraction G(iw) on 20 points within 2e-5 from each
    # chain's first 24 steps — the chain length of the reference's contract
    # (test_bs_chain.py:109-139). Past a few dozen steps a chain without
    # reorthogonalization has lost orthogonality, and two f32 summation
    # orders then diverge in the unconverged interior of a random start's
    # spectrum: the G of all 200 steps is printed, not gated. Two reruns,
    # and the batch against each chain run alone, bit-identical.
    m, nb, m_g = GF_STEPS, 4, 24
    vb = start(nb)
    al_k, be_k = bc.gf_tridiag_call(op, vb, m)
    al_r, be_r = bc.gf_tridiag_call(op, vb, m)
    if not (torch.equal(al_k, al_r) and torch.equal(be_k, be_r)):
        raise AssertionError("two runs of B4 on one input differ")
    for i in range(nb):
        al_1, be_1 = bc.gf_tridiag_call(op, vb[i:i + 1].contiguous(), m)
        if not (torch.equal(al_1[0], al_k[i]) and torch.equal(be_1[0],
                                                               be_k[i])):
            raise AssertionError(f"B4 chain {i} alone differs from the batch")
    al_p, be_p = bc.gf_tridiag_batch_plain(pop, vb, m)
    al_k, be_k = al_k.cpu().numpy(), be_k.cpu().numpy()
    al_p, be_p = al_p.cpu().numpy(), be_p.cpu().numpy()
    err_ab = err_g = err_g200 = 0.0
    for i in range(nb):
        scale = max(1.0, np.abs(al_p[i]).max())
        err_ab = max(err_ab, max(np.abs(al_k[i, :8] - al_p[i, :8]).max(),
                                 np.abs(be_k[i, :8] - be_p[i, :8]).max())
                     / scale)
        err_g = max(err_g, np.abs(g_cf(al_k[i, :m_g], be_k[i, :m_g])
                                  - g_cf(al_p[i, :m_g], be_p[i, :m_g])).max())
        err_g200 = max(err_g200, np.abs(g_cf(al_k[i], be_k[i])
                                        - g_cf(al_p[i], be_p[i])).max())
    say(f"B4 gf_tridiag {nb} chains m={m}: max|d alpha,beta|[:8]/scale = "
        f"{err_ab:.3e} (tol 5e-5); max|dG(iw)| from {m_g} steps = "
        f"{err_g:.3e} (tol 2e-5); from all {m} steps {err_g200:.3e} "
        f"(random starts, not gated); reruns and each chain alone "
        f"bit-identical")
    if not (err_ab <= 5e-5 and err_g <= 2e-5):
        raise AssertionError("B4 kernel disagrees with its plain version")
    # (c) the main path's own chain: c^+_up |GS> into the (7,6) sector, its
    # G(iw) with poles shifted by E0 as the solver forms them, against the
    # true-f32 plain version (2e-5, the f32 GF contract) and, printed, the
    # six-pass plain version; B4's row is timed on this chain
    op_j, vp, g_k, g_6, g_f = _physical_gf_chain(v_gs, e0, m)
    d_f = float(np.abs(g_k - g_f).max())
    say(f"B4 on c+|GS> in ({HALF + 1},{HALF}) padded {op_j.padded_shape}, "
        f"m={m}: max|dG(iw)| vs the true-f32 plain version {d_f:.3e} (tol "
        f"2e-5), vs the six-pass plain version "
        f"{float(np.abs(g_k - g_6).max()):.3e}, max|G| "
        f"{float(np.abs(g_f).max()):.3e}")
    if not d_f <= 2e-5:
        raise AssertionError("B4 on c+|GS> misses the f32 GF contract")
    ms_k = device_ms(lambda: bc.gf_tridiag_call(op_j, vp, m), 1, 3) / m
    ms_p = cuda_ms(lambda: bc.gf_tridiag_batch_plain(op_j.pop, vp, m)) / m
    rows.append(("gf_tridiag", err_ab, ms_k, ms_p, *gf_bound(op_j.pop, m, 1)))
    rows += phase2_b1(op, start(1)[0])
    for name, _, ms_k, ms_p, b_ms, b_by in rows:
        say(f"  {name:11s} per step or call: kernel {ms_k:.4f} ms, plain "
            f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def phase2_b1(op, v):
    """B1, trimmed (B1a) and whole-window (B1b), against its plain version:
    y within 1e-5 * max|y| and per-panel sums of squares within 1e-5
    relative (six-pass products summed in other orders); trimmed ==
    whole-window exactly (the trim skips exact-zero stages only); pad
    rows and columns exactly 0; chain_step's rsqrt within 1e-6 relative of
    1 / |y|. Timed by graph replay."""
    import torch
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
    pop = op.pop
    scale = 0.37
    y_p, ss_p = bs.matvec_bs_padded_plain(pop, v, scale)
    ymax = float(y_p.abs().max())
    out = {}
    for name, trim in (("matvec_runs", True), ("matvec_full", False)):
        y_k, ss_k = bs._matvec_padded(op, v, scale, trim=trim)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        ss_rel = float(((ss_k.double() - ss_p.double()).abs()
                        / ss_p.double().abs().clamp(min=1e-300)).max())
        pad_ok = bool(torch.all(y_k[op.dim_dw:] == 0)) and \
            bool(torch.all(y_k[:, op.dim_up:] == 0))
        say(f"B1 {name}: max|dy| = {err:.3e} (tol {1e-5 * ymax:.3e}); "
            f"max panel ss rel diff {ss_rel:.3e} (tol 1e-5); pad exactly 0: "
            f"{pad_ok}")
        if not (err <= 1e-5 * ymax and ss_rel <= 1e-5 and pad_ok):
            raise AssertionError(f"B1 {name} disagrees with its plain version")
        out[name] = (y_k, err)
    d_trim = float((out["matvec_runs"][0] - out["matvec_full"][0]).abs().max())
    say(f"B1 trimmed vs whole-window: max|d| = {d_trim!r} (must be 0); "
        f"zero tiles skipped {100 * bs.trim_share(pop):.1f}%")
    if d_trim != 0.0:
        raise AssertionError("B1 trimmed and whole-window outputs differ")
    y, r = bs.chain_step(op, v, torch.ones((), device=v.device))
    nrm = float(y.double().norm())
    r_err = abs(float(r) - 1.0 / nrm) * nrm
    say(f"B1 chain_step: rsqrt {float(r):.9e} vs 1/|y| {1.0 / nrm:.9e}, "
        f"rel diff {r_err:.3e} (tol 1e-6)")
    if not r_err <= 1e-6:
        raise AssertionError("chain_step's normalization is off")
    ms_p = device_ms(lambda: bs.matvec_bs_padded_plain(pop, v, scale), 10)
    rows = []
    for name, trim in (("matvec_runs", True), ("matvec_full", False)):
        ms_k = device_ms(lambda: bs._matvec_padded(op, v, scale, trim=trim),
                         50)
        rows.append((name, out[name][1], ms_k, ms_p, *b1_bound(op)))
    say("  B1 per call at each tile width (the launcher's first): "
        + tile_times(lambda t: bs._matvec_padded(op, v, scale, tile=t),
                     op.padded_shape[0], op.padded_shape[1]))
    return rows


def tile_times(call, rows, dup):
    """'64 x BN: ms' by graph replay of call(BN) for the launcher's tile
    width of a rows x dup grid, then the other one."""
    from dmft_lanc_ed_tpu_torch import _kernels
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    mine = _kernels.lib().bs_matvec_tile(rows, dup)
    return ", ".join(f"64 x {t}: {device_ms(lambda: call(t), 50):.4f} ms"
                     for t in (mine, 160 - mine))


def b1_bound(op):
    """B1's bound: both forms compute the same y, from the nonzero tiles;
    v in, y and the panel sums out."""
    pop = op.pop
    ddp, dup = pop.padded_shape
    return matvec_bound(pop, ddp, *kept_tiles(pop),
                        8 * ddp * dup + 4 * (ddp // 128))


def b5_bound(op, sh):
    """A B5 shard's bound: its own panels' nonzero dw tiles and every up
    panel's; v_loc and v_ext in, y and the panel sums out."""
    pop = op.pop
    dup = pop.padded_shape[1]
    tiles = kept_tiles(pop, slice(sh.rank * sh.local // 128,
                                  (sh.rank + 1) * sh.local // 128))
    return matvec_bound(pop, sh.local, *tiles,
                        4 * (2 * sh.local + sh.ext) * dup
                        + 4 * (sh.local // 128))


def phase2s():
    """The kernels' time per step or call at SHAPES and GF_SHAPES (module
    docstring); returns B2's ms a step at each of SHAPES. The chains by CUDA events around three back-to-back chains
    (an earlier tree's B4 wrapper fills its state from the host, which a
    CUDA graph cannot capture, and every step here takes the card longer
    than the host takes to enqueue it); B1 and B5, a call of tens of us, by
    graph replay."""
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.parallel import bs_sharded as bsh
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import to_padded

    def starts(op, n):
        v = np.random.default_rng(5).standard_normal((n, op.dim_dw,
                                                      op.dim_up))
        v /= np.linalg.norm(v.reshape(n, -1), axis=1)[:, None, None]
        return to_padded(op, v)
    m, kk = 96, bc._bucket_k(128)
    b2_steps = {}
    for sqn in SHAPES:
        op = sector_854k(sqn)[3]
        v0 = starts(op, 1)[0]
        # any window inside the spectrum times the filter
        ms2 = cuda_ms(lambda: bc.tridiag_call(op, v0, m), 3) / m
        ms3 = cuda_ms(lambda: bc.cheb_call(op, v0, kk, 0.3, 0.2), 3) / kk
        b2, b3 = chain_bounds(op.pop, m, kk)
        b2_steps[sqn] = ms2
        say(f"  shape {tuple(sqn)} padded {op.padded_shape}: B2 {ms2:.4f} ms "
            f"a step (bound {b2[0]:.4f} ms, {b2[1]}), B3 {ms3:.4f} ms a step "
            f"(bound {b3[0]:.4f} ms, {b3[1]})")
        ms1 = [device_ms(lambda: bs._matvec_padded(op, v0, 1.0, trim=t), 50)
               for t in (True, False)]
        b1 = b1_bound(op)
        if bsh.bs_shard_applicable(op, NSHARD):
            sh = bsh.shard_bs_op(op, NSHARD, 0, DEVICE)
            v_loc, v_ext = bsh.shard_rows(v0, sh)
            ms5 = device_ms(lambda: bsh._local_call(sh, v_loc, v_ext), 50)
            b5 = b5_bound(op, sh)
            b5_text = (f"B5 {ms5:.4f} ms (one of {NSHARD} shards; bound "
                       f"{b5[0]:.4f} ms, {b5[1]})")
        else:
            b5_text = f"B5 n/a (the sector does not shard over {NSHARD})"
        say(f"  shape {tuple(sqn)} padded {op.padded_shape}: B1a "
            f"{ms1[0]:.4f} ms, B1b {ms1[1]:.4f} ms a call (bound "
            f"{b1[0]:.4f} ms, {b1[1]}); {b5_text}")
    m = GF_STEPS
    # two chains at (7,6): the largest batch of phase 16's finite-T loops
    # (two states of one sector send their c+ chains to one target)
    for sqn, nb in [(q, 1) for q in GF_SHAPES] + [((HALF + 1, HALF), 2),
                                                  ((HALF, HALF), 4),
                                                  ((HALF, HALF), 7)]:
        op = sector_854k(sqn)[3]
        vb = starts(op, nb)
        ms4 = cuda_ms(lambda: bc.gf_tridiag_call(op, vb, m), 3) / m
        b4 = gf_bound(op.pop, m, nb)
        say(f"  shape {tuple(sqn)} padded {op.padded_shape}: B4 {nb} "
            f"chain{'s' if nb > 1 else ''} {ms4:.4f} ms a step (bound "
            f"{b4[0]:.4f} ms, {b4[1]})")
    return b2_steps


def phase3(cfg, sec, op):
    """The two-stage ground state of the sector: (energy, seconds). Its
    gate against ARPACK (phase3_gate) waits for the oracle, so phases 4
    and 5 can run first."""
    import torch
    from dmft_lanc_ed_tpu_torch.diag import _blocksparse_ground_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evals, evecs = _blocksparse_ground_state(cfg, op, sec.dim, 1, ncv=48)
    torch.cuda.synchronize()
    if not np.all(np.isfinite(evecs)):
        raise AssertionError("two-stage ground state not finite")
    return float(evals[0]), time.perf_counter() - t0


def phase3_gate(e_gs, dt, e0):
    de = abs(e_gs - e0)
    say(f"phase 3: two-stage Egs = {e_gs:+.12f}, |dE| vs ARPACK = "
        f"{de:.3e} (gate 1e-10), {dt:.2f} s")
    if not de <= 1e-10:
        raise AssertionError("two-stage ground state misses the gate")


def phase3b(cfg, sec, op, e0):
    """The per-call path: power steps through chain_step (B1a), then the
    two-stage solve without the chain (B1b under the f32 thick restart)."""
    import torch
    from dmft_lanc_ed_tpu_torch.diag import _blocksparse_ground_state
    from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
    from dmft_lanc_ed_tpu_torch.ops import lanczos as lz
    v = np.random.default_rng(7).standard_normal((op.dim_dw, op.dim_up))
    vp = bs.to_padded(op, v / np.linalg.norm(v))
    bs.reset_launch_counts()
    lz.restart_counts["ground_state"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inv = torch.ones((), device=DEVICE)
    steps = 64
    for _ in range(steps):
        vp, inv = bs.chain_step(op, vp, inv)
    torch.cuda.synchronize()
    t_pow = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = _blocksparse_ground_state(cfg, op, sec.dim, 1, ncv=48,
                                             use_chain=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(bs.launch_counts)
    restarts = lz.restart_counts["ground_state"]
    de = abs(float(evals[0]) - e0)
    say(f"phase 3b: {steps} chain_step power steps in {t_pow:.3f} s; "
        f"per-call two-stage Egs = {evals[0]:+.12f}, |dE| vs ARPACK = "
        f"{de:.3e} (gate 1e-10), {dt:.2f} s, {restarts} thick restarts "
        f"(f32 stage 1 and top-off); launches {counts}")
    if not (de <= 1e-10 and np.all(np.isfinite(evecs))
            and np.isfinite(float(inv))):
        raise AssertionError("per-call two-stage ground state misses the "
                             "gate")
    if any(n <= 0 for n in counts.values()):
        raise AssertionError(f"a B1 kernel never launched: {counts}")
    return counts, dt


def _dmft_cfg(nloop, **kw):
    """Phases 4 and 5's DMFT configuration: nbath = 11, T = 0."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(norb=1, nbath=NBATH, uloc=(2.0,), beta=100.0,
                       lmats=1024, lfit=256, lreal=64, nloop=nloop,
                       ed_sectors=True, **kw)


def _run_loop(name, cfg, e_gs):
    """run_dmft on the card with the chain launch counts reset just
    before; checks launches, finite outputs, dens range and loop 1's Egs
    against phase 3. Returns (result, (chain launch counts, chain step
    counts), seconds)."""
    from dmft_lanc_ed_tpu_torch.models.hm_bethe import run_dmft
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_dmft(cfg, device=DEVICE, verbose=False)
    dt = time.perf_counter() - t0
    counts, steps = dict(bc.launch_counts), dict(bc.step_counts)
    seeds = dict(bc.seed_counts)
    chains = list(bc.chains_per_launch["gf_tridiag"])
    say(f"{name}: run_dmft nbath={NBATH}, {res.iterations} loops in "
        f"{dt:.1f} s; launches {counts}, steps {steps}, chain seeds {seeds}, "
        f"chains of each B4 launch {chains}")
    for ent in res.history:
        say(f"  loop {ent['iloop']}: diag {ent['diag']:.2f} s, gf "
            f"{ent['gf']:.2f} s, fit {ent['fit']:.2f} s, Egs "
            f"{ent['egs']:+.12f}, dens {ent['dens']}, docc {ent['docc']}, "
            f"gf routing {ent['routing'][0]} via chain kernel, "
            f"{ent['routing'][1]} via scan")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"a chain kernel never launched: {counts}")
    if seeds["missed"] > 0 or seeds["reached"] <= 0:
        raise AssertionError(f"a chain seed missed its eta_target (its sector "
                             f"took the full top-off): {seeds}")
    outs = [res.sigma_mats, res.sigma_real, res.g_mats, res.weiss, res.bath,
            res.dens, res.docc]
    if not all(np.all(np.isfinite(x)) for x in outs):
        raise AssertionError("non-finite DMFT output")
    if not np.all((res.dens >= 0) & (res.dens <= 2)):
        raise AssertionError(f"dens out of range: {res.dens}")
    egs1 = res.history[0]["egs"]
    if e_gs is None:
        say("  loop 1 Egs not checked (phase 3 not run)")
    else:
        say(f"  loop 1 Egs {egs1:+.12f} vs phase 3 {e_gs:+.12f}: "
            f"|d| = {abs(egs1 - e_gs):.3e} (tol 1e-9)")
        if not abs(egs1 - e_gs) <= 1e-9:
            raise AssertionError("loop 1 ground state differs from phase 3")
    return res, (counts, steps), dt


@contextlib.contextmanager
def sector_hint(module, hints):
    """Every EDSolver that `module` builds starts with the sector hint
    `hints` (the restriction that a restart or an earlier loop sets under
    ``ed_sectors``, shift ``cfg.ed_sectors_shift``): the first loop of its
    driver scans the sectors around `hints` alone. Yields the list of its
    solves, each (the neigen_sector and lanc_nstates_total it started
    from, its SolveResult, the packed bath it took, the solver)."""
    base = module.EDSolver
    solves = []

    class Hinted(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.diag_state.sector_hint = list(hints)

        def solve(self, bath):
            ctl = self.diag_state
            start = (dict(ctl.neigen_sector), ctl.lanc_nstates_total)
            res = super().solve(bath)
            solves.append((start, res, np.asarray(bath).copy(), self))
            return res
    module.EDSolver = Hinted
    try:
        yield solves
    finally:
        module.EDSolver = base


# phase 4's sector hint: the 9 sectors around (6,6), the largest of the
# scan, and the 9 around (3,3), six of which phase 5 solves in its buckets
P4_HINT = ((HALF, HALF), (3, 3))


def _dim(q):
    """States of the nbath = 11 sector q of one orbital."""
    from math import comb
    return comb(NBATH + 1, q[0][0]) * comb(NBATH + 1, q[1][0])


def phase4(e_gs):
    """Sectors one by one, through the band-sparse backend, loop 1
    restricted by the sector hint to the sectors around P4_HINT."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.models import hm_bethe
    with sector_hint(hm_bethe, [pt.qn(*q) for q in P4_HINT]):
        return _run_loop(f"phase 4 (the sectors around {list(P4_HINT)})",
                         _dmft_cfg(1, ed_backend="pallas",
                                   ed_batch_sectors=False), e_gs)


def phase5(e_gs, serial):
    """The default configuration (ed_backend="auto", batched small
    sectors); loop 1's Krylov sectors of phase 4's scan against its serial
    solves (`serial`, phase 4's run) of the same bath (both loops start
    from init_bath)."""
    from dmft_lanc_ed_tpu_torch.ops import batched as bt
    cfg = _dmft_cfg(2)
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 5 must run the default configuration")
    bt.reset_bucket_counts()
    res, counts, dt = _run_loop("phase 5", cfg, e_gs)
    buckets = dict(bt.bucket_counts)
    say(f"  batched: {buckets}")
    if buckets["buckets"] <= 0:
        raise AssertionError("no batched bucket was solved")
    if serial is None:
        say("  sector energies not checked (phase 4 not run)")
        return counts, dt
    ref = {q: (e, k) for q, e, k in serial.history[0]["diag_log"]}
    log5 = {q: (e, k) for q, e, k in res.history[0]["diag_log"]}
    if not set(ref) <= set(log5):
        raise AssertionError("phase 5 did not scan phase 4's sectors")
    worst, n_kry, n_bat = 0.0, 0, 0
    for q, (e_ref, k_ref) in ref.items():
        e, krylov = log5[q]
        if krylov != k_ref or len(e) != len(e_ref):
            raise AssertionError(f"sector {q}: solve kind or count differs")
        if not krylov:
            continue
        n_kry += 1
        n_bat += _dim(q) <= cfg.ed_batch_dim_max
        e, e_ref = np.asarray(e), np.asarray(e_ref)
        worst = max(worst, float((np.abs(e - e_ref)
                                  / np.maximum(1.0, np.abs(e_ref))).max()))
    say(f"  loop 1, {n_kry} Krylov sectors of phase 4, {n_bat} of them in "
        f"buckets here: max |dE| / max(1, |E|) vs phase 4 = {worst:.3e} "
        f"(tol 1e-9)")
    if not (worst <= 1e-9 and n_bat > 0):
        raise AssertionError("batched sector energies differ from the "
                             "serial ones, or none was batched")
    return counts, dt


def phase6(op):
    """B5 on NSHARD shards of the 854k sector, the halo'd rows sliced from
    one whole vector: each shard against its plain version, the stitched
    shards against B1b (whole windows, scale 1) bit for bit."""
    import torch
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
    from dmft_lanc_ed_tpu_torch.parallel import bs_sharded as bsh
    v = np.random.default_rng(11).standard_normal((op.dim_dw, op.dim_up))
    vp = bs.to_padded(op, v / np.linalg.norm(v))
    shards = [bsh.shard_bs_op(op, NSHARD, d, DEVICE) for d in range(NSHARD)]
    rows = [bsh.shard_rows(vp, sh) for sh in shards]
    y_b1, ss_b1 = bs._matvec_padded(op, vp, 1.0, trim=False)
    ys, sss, err = [], [], 0.0
    for d, (sh, (v_loc, v_ext)) in enumerate(zip(shards, rows)):
        y_k, ss_k = bsh._local_call(sh, v_loc, v_ext)
        y_p, ss_p = bsh._local_call_plain(sh, v_loc, v_ext)
        torch.cuda.synchronize()
        e = float((y_k - y_p).abs().max())
        ymax = float(y_p.abs().max())
        ss_rel = float(((ss_k.double() - ss_p.double()).abs()
                        / ss_p.double().abs().clamp(min=1e-300)).max())
        say(f"B5 shard {d}/{NSHARD} ({sh.local} rows, halo {sh.halo}, window "
            f"starts {sh.t_tiles.tolist()}): max|dy| = {e:.3e} (tol "
            f"{1e-5 * ymax:.3e}); max panel ss rel diff {ss_rel:.3e} (tol "
            f"1e-5); sum y^2 = {float(ss_k.double().sum())!r}")
        if not (e <= 1e-5 * ymax and ss_rel <= 1e-5):
            raise AssertionError(f"B5 shard {d} disagrees with its plain "
                                 "version")
        err = max(err, e)
        ys.append(y_k)
        sss.append(ss_k)
    same = torch.equal(torch.cat(ys), y_b1) and torch.equal(torch.cat(sss),
                                                             ss_b1)
    total = sum(float(t.double().sum()) for t in sss)
    say(f"B5 stitched vs B1b: bit-identical {same}; sum y^2 over shards "
        f"{total!r}, B1b {float(ss_b1.double().sum())!r}")
    if not same:
        raise AssertionError("stitched B5 differs from B1b")
    sh, (v_loc, v_ext) = shards[0], rows[0]
    ms_k = device_ms(lambda: bsh._local_call(sh, v_loc, v_ext), 50)
    ms_p = device_ms(lambda: bsh._local_call_plain(sh, v_loc, v_ext), 10)
    b_ms, b_by = b5_bound(op, sh)
    say(f"  sharded_matvec per call (one shard): kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}); at each tile width "
        f"(the launcher's first): "
        + tile_times(lambda t: bsh._local_call(sh, v_loc, v_ext, tile=t),
                     sh.local, sh.dup))
    return [("sharded_matvec", err, ms_k, ms_p, b_ms, b_by)]


def phase8(op, earlier, b2_steps):
    """The experiment probes E1-E3: each kernel against its plain version
    (launches not counted), then the probes' entry points, the main path
    of this slice, with their launch counts set to 0 just before and read
    just after. `earlier`: the kernel rows of phases 2 and 6, and
    `b2_steps`: phase 2s's B2 ms a step by shape, printed beside the
    probes' times."""
    import torch
    from dmft_lanc_ed_tpu_torch.experiments import chain_breakdown as cb
    from dmft_lanc_ed_tpu_torch.experiments import chain_probe as cp
    from dmft_lanc_ed_tpu_torch.experiments import trim_ab as ta
    from dmft_lanc_ed_tpu_torch.experiments.timing import device_ms
    pop = op.pop
    ddp, dup = pop.padded_shape
    rank = pop.diag_a.shape[1]
    tiles = kept_tiles(pop)
    hop = hop_flops(pop, *tiles)
    prior = {r[0]: r[2] for r in earlier}
    rows = []

    # (a) E1: the probe's gates, kernel against its plain version and
    # against the f32 chain; reruns bit-identical, one launch a call
    v0, a = cp.probe_inputs(DEVICE)
    n, kk = cp.N, cp.K
    for k in (kk, 71):
        l0 = cp.launch_counts["chain_probe"]
        n_k, v_k = cp.chain(v0, a, k)
        n_r, v_r = cp.chain(v0, a, k)
        launches = cp.launch_counts["chain_probe"] - l0
        n_p, v_p = cp.chain_plain(v0, a, k)
        torch.cuda.synchronize()
        same = torch.equal(n_k, n_r) and torch.equal(v_k, v_r)
        d_p = (float((n_k - n_p).abs().max() / n_p.abs().max()),
               float((v_k - v_p).abs().max() / v_p.abs().max()))
        n_f, v_f = cp.reference(v0.cpu().numpy(), a.cpu().numpy(), k)
        d_f = (float(np.abs(n_k.cpu().numpy().ravel() - n_f).max()
                     / np.abs(n_f).max()),
               float(np.abs(v_k.cpu().numpy() - v_f).max()
                     / np.abs(v_f).max()))
        say(f"E1 chain_probe N={n} K={k}: norms / vout rel diff vs plain "
            f"{d_p[0]:.3e} / {d_p[1]:.3e}, vs the f32 chain {d_f[0]:.3e} / "
            f"{d_f[1]:.3e} (tol 1e-5 / 1e-4); reruns bit-identical: {same}; "
            f"launches a call {launches / 2:g}")
        if not (max(d_p[0], d_f[0]) <= 1e-5 and max(d_p[1], d_f[1])
                <= 1e-4):
            raise AssertionError("E1 kernel disagrees with its plain "
                                 "version or the f32 chain")
        if not (same and launches == 2):
            raise AssertionError("E1 reruns differ or a call is not one "
                                 "launch")
        if k == kk:
            err_v = float((v_k - v_p).abs().max())
    ms_k = device_ms(lambda: cp.chain(v0, a), 200, 3) / kk
    # the marginal step, without the launch and the load of A: K = 7 vs
    # 71; the intercept: the launch and the load of A
    ms_71 = device_ms(lambda: cp.chain(v0, a, 71), 50, 3)
    marginal = (ms_71 - kk * ms_k) / (71 - kk)
    icpt = kk * (ms_k - marginal)
    ms_p = device_ms(lambda: cp.chain_plain(v0, a), 50, 3) / kk
    # a step: six bf16 tensor-core passes (or one FP32 product), ~10 FP32
    # operations an element of y (scale, square, split); A and v0 in once,
    # vout and the norms out once a call
    step = 2 * n * n * 128
    nbytes = (4 * n * n + 8 * n * 128 + 4 * kk) / kk
    b_tc = bound_tc(6 * step, 10 * n * 128, nbytes)
    b_32 = bound(step, nbytes)
    b2 = ", ".join(f"{tuple(q)} {1e3 * b2_steps[q]:.2f}" for q in SHAPES
                   if q in b2_steps) or "n/a (phase 2s not run)"
    g = cp.geometry()
    say(f"  E1 (a cluster of {g['ctas']} CTAs of 64 x {cp.BN}, "
        f"{g['smem_dynamic'] / 1024:.1f} KB dynamic + {g['smem_static']} B "
        f"static shared memory and {g['registers']} registers a thread, "
        f"{g['clusters']} such clusters at once): {1e3 * ms_k:.3f} us a step "
        f"at K = {kk}, marginal step {1e3 * marginal:.3f} us (K = {kk} vs "
        f"71), intercept {1e3 * icpt:.3f} us (launch + load of A)")
    ph = cp.step_phases(v0, a, 71)
    say(f"  E1 a step by the kernel's clock trace (K = 71, "
        f"{ph['step_clocks']:.0f} clocks), as shares of the marginal step: "
        + ", ".join(f"{k} {1e3 * marginal * ph[k]:.3f} us ({100 * ph[k]:.1f} "
                    "%)" for k in ("product", "epilogue", "barrier", "rest")))
    say(f"  E1 plain {1e3 * ms_p:.3f} us a step; bound {1e3 * b_tc[0]:.3f} us "
        f"six-pass tensor ({b_tc[1]}), {1e3 * b_32[0]:.3f} us FP32 "
        f"({b_32[1]}); B2 a step, us: {b2} (phase 2s, events), (6, 6) "
        f"{1e3 * prior.get('tridiag', float('nan')):.2f} (phase 2, graph "
        "replay)")
    rows.append(("chain_probe", err_v, ms_k, ms_p, *b_tc))

    # the CUDA kernels a probe's calls launched, as its launcher counts them
    def kernels(mod):
        return sum(mod.kernel_launches.values())

    def per(n0, mod, calls):
        return f"{(kernels(mod) - n0) / calls:g}"

    # (b) E2: the five forms against plain and against each other
    v = ta.random_start(op, 13)
    scale = 0.37
    y_p, ss_p = ta.matvec_plain(op, v, scale)
    ymax = float(y_p.abs().max())
    forms = [(m, ta.make_variant(op, m)) for m in ta.MODES] \
        + [("static_runs", ta.make_static_runs(op))]
    outs = {}
    for name, call in forms:
        n0 = kernels(ta)
        y_k, ss_k = call(v, scale)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        ss_rel = float(((ss_k.double() - ss_p.double()).abs()
                        / ss_p.double().abs().clamp(min=1e-300)).max())
        say(f"E2 {name}: max|dy| = {err:.3e} (tol {1e-5 * ymax:.3e}); max "
            f"panel ss rel diff {ss_rel:.3e} (tol 1e-5); kernel launches a "
            f"call {per(n0, ta, 1)}")
        if not (err <= 1e-5 * ymax and ss_rel <= 1e-5):
            raise AssertionError(f"E2 {name} disagrees with its plain version")
        outs[name] = (y_k, ss_k, err)
    y0, ss0, _ = outs["untrimmed"]
    same = all(torch.equal(y, y0) and torch.equal(ss, ss0)
               for y, ss, _ in outs.values())
    say(f"E2 five forms bit-identical: {same}")
    if not same:
        raise AssertionError("E2's forms differ")
    ms_p = device_ms(lambda: ta.matvec_plain(op, v, scale), 20, 3)
    # the split v and the epilogue in FP32; v in, y and ss out, the op once
    b_e2 = bound_tc(3 * hop, (2 * rank + 7) * ddp * dup,
                    op_bytes(pop, ddp, *tiles) + 8 * ddp * dup
                    + 4 * (ddp // 128))
    times = {name: device_ms(lambda: call(v, scale), 50, 3)
             for name, call in forms}
    say("  E2 per call: " + ", ".join(f"{k} {t:.4f} ms"
                                      for k, t in times.items())
        + f"; plain {ms_p:.4f} ms; bound {b_e2[0]:.4f} ms ({b_e2[1]}); B1a "
        f"{prior.get('matvec_runs', float('nan')):.4f} ms, B1b "
        f"{prior.get('matvec_full', float('nan')):.4f} ms (six-pass "
        f"wgmma)")
    rows.append(("trim_tiles", outs["untrimmed"][2], times["untrimmed"], ms_p,
                 *b_e2))
    rows.append(("trim_static_runs", outs["static_runs"][2],
                 times["static_runs"], ms_p, *b_e2))

    # (c) E3: the five product forms against their plain versions
    m = 96
    v0 = ta.random_start(op, 17)
    vec = 4 * ddp * dup
    e3, coeffs = {}, {}
    for mode in cb.MODES:
        call = cb.make_variant(op, mode)
        n0 = kernels(cb)
        al_k, be_k = call(v0, m)
        launches = per(n0, cb, m)
        al_p, be_p = cb.chain_plain(op, v0, m, mode)
        al_k, be_k = al_k.cpu().numpy(), be_k.cpu().numpy()
        al_p, be_p = al_p.cpu().numpy(), be_p.cpu().numpy()
        coeffs[mode] = (al_k, be_k)
        sc = max(1.0, np.abs(al_p).max())
        err = max(np.abs(al_k[:16] - al_p[:16]).max(),
                  np.abs(be_k[:16] - be_p[:16]).max())
        # 1pass stages both parts of every tile, as 3pass does: the same
        # bytes, a third of the tensor-core passes
        passes = 1 if mode == "1pass" else 3
        b = bound_tc(passes * hop, (2 * rank + 12) * ddp * dup,
                     (op_bytes(pop, ddp, *tiles) + vec) / m + 8)
        ms = device_ms(lambda: call(v0, m), 1, 3) / m
        e3[mode] = (float(err), ms, b)
        say(f"E3 {mode} m={m}: max|d alpha,beta|[:16] = {err:.3e} (tol "
            f"{1e-4 * sc:.3e}); per step {1e3 * ms:.2f} us, bound "
            f"{1e3 * b[0]:.2f} us ({b[1]}); kernel launches a step "
            f"{launches}")
        if not err <= 1e-4 * sc:
            raise AssertionError(f"E3 {mode} disagrees with its plain version")
    al3, be3 = coeffs["3pass"]
    skip_same = all(np.array_equal(x, y)
                    for x, y in zip(coeffs["tileskip"], coeffs["3pass"]))
    d_pair = max(np.abs(coeffs["bf16pair"][0][:16] - al3[:16]).max(),
                 np.abs(coeffs["bf16pair"][1][:16] - be3[:16]).max())
    sc3 = max(1.0, np.abs(al3).max())
    say(f"E3 tileskip vs 3pass bit-identical: {skip_same}; bf16pair vs "
        f"3pass max|d alpha,beta|[:16] = {d_pair:.3e} (tol "
        f"{1e-4 * sc3:.3e})")
    if not (skip_same and d_pair <= 1e-4 * sc3):
        raise AssertionError("E3's tileskip or bf16pair strays from 3pass")
    ms_p = device_ms(lambda: cb.chain_plain(op, v0, m, "3pass"), 1, 2) / m
    say(f"  E3 per step: plain 3pass {ms_p:.4f} ms; B2 (wgmma, 2 launches) "
        f"{prior.get('tridiag', float('nan')):.4f} ms")
    err3, ms3, b3 = e3["3pass"]
    rows.append(("chain_breakdown", err3, ms3, ms_p, *b3))

    # the main path of this slice: the probes' entry points
    for mod in (cp, ta, cb):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    cp.main(DEVICE)
    ta.main(DEVICE, op=op)
    cb.main(DEVICE, op=op)
    counts = {**cp.launch_counts, **ta.launch_counts, **cb.launch_counts}
    steps = {**cp.step_counts, **cb.step_counts}
    e3_kernels = kernels(cb)
    say(f"phase 8: the probes' main() in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}, chain steps {steps}; E3 kernel launches "
        f"{e3_kernels}, a step {per(0, cb, steps['chain_breakdown'])}; E2 "
        f"kernel launches {kernels(ta)}")
    if any(c <= 0 for c in counts.values()):
        raise AssertionError(f"a probe kernel never launched: {counts}")
    if e3_kernels != 2 * steps["chain_breakdown"]:
        raise AssertionError("E3 is not two kernel launches a step")
    return rows, counts, steps


def _p7_cfg(**kw):
    """Phase 7: nbath = 11, T = 0, the sector (6,6) alone, one state,
    cut from the 9 sectors within 1 of (6,6) to keep the script's time."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(norb=1, nbath=NBATH, uloc=(2.0,), beta=100.0,
                       lmats=1024, lreal=64, ed_backend="pallas",
                       ed_sectors=True, ed_sectors_shift=0,
                       lanc_nstates_sector=1, **kw)


def _p7_solve(cfg, device, sqn=(HALF, HALF)):
    """One solve from init_bath, restricted around `sqn` -> (result,
    seconds)."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    solver = pt.EDSolver(cfg, device=device)
    solver.diag_state.sector_hint = [pt.qn(*sqn)]
    t0 = time.perf_counter()
    res = solver.solve(solver.init_bath())
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase7_rank(rank):
    """One of NSHARD ranks sharing the card: the restricted sharded solve
    (its diag is the 854k sector's dw-sharded two-stage ground state: B5
    under the f32 thick restart, then the top-off and f64 polish over the
    sharded dense operator), launch counts set to 0 just before and read
    just after."""
    from dmft_lanc_ed_tpu_torch.parallel import bs_sharded as bsh
    from dmft_lanc_ed_tpu_torch.parallel import production as prod
    from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
    from dmft_lanc_ed_tpu_torch.parallel.multihost import rank_device
    dev = rank_device(DEVICE)
    mesh = make_mesh(NSHARD, dev)
    bsh.reset_launch_counts()
    prod.reset_apply_counts()
    res, t_b = _p7_solve(_p7_cfg(mesh_shape=(NSHARD,)), dev)
    return dict(transport=mesh.transport, device=str(dev), t_b=t_b,
                egs=res.state_list.emin, g_mats=res.g_mats,
                sigma_mats=res.sigma_mats, timings=res.timings,
                routing=res.gf.routing,
                sectors=[q for q, _, _ in res.state_list.diag_log],
                b5_b=bsh.launch_counts["sharded_matvec"],
                dense_b=prod.apply_counts["dense_sharded"],
                gf_b=prod.apply_counts["gf_chains"])


def sharded_rank(rank, go):
    """One of the NSHARD ranks of phases 7 and 15, spawned once for both
    while the phases before them run: it waits for the file `go`, then
    runs phase7_rank's and phase15_rank's work for the phases it names
    (none: the script stopped early)."""
    while not os.path.exists(go):
        time.sleep(0.05)
    with open(go) as fh:
        parts = fh.read().split()
    out = {}
    if "7" in parts:
        out["7"] = phase7_rank(rank)
    if "15" in parts:
        out["15"] = phase15_rank(rank)
    return out


def spawn_ranks(go):
    """Spawn the NSHARD ranks of phases 7 and 15 in the background; they
    start their work when `go` appears (release_ranks). Returns the
    thread pool that waits on them and their pending outputs."""
    from concurrent.futures import ThreadPoolExecutor
    from dmft_lanc_ed_tpu_torch.parallel.multihost import run_local_ranks
    waiter = ThreadPoolExecutor(1)
    return waiter, waiter.submit(run_local_ranks, sharded_rank, NSHARD,
                                 args=(go,), device=DEVICE, timeout=1200)


def release_ranks(go, parts):
    """Name the phases the waiting ranks run (none stops them)."""
    with open(go + ".tmp", "w") as fh:
        fh.write(" ".join(sorted(parts)))
    os.replace(go + ".tmp", go)


def sharded_ranks(pending, parts, t0):
    """Wait for the ranks released at `t0` for the phases in `parts` (7,
    15); each phase's outputs, rank by rank."""
    out = pending.result()
    say(f"phases {' and '.join(sorted(parts, key=int))}: {NSHARD} ranks "
        f"(spawned at the start), {time.perf_counter() - t0:.1f} s from "
        f"their release ({CARD})")
    return {p: [o[p] for o in out] for p in parts}


def ranks_on(out):
    """The ranks' devices and transport, and what their times are."""
    devs = sorted({o["device"] for o in out})
    shared = ("time-sliced on one card, not a multi-card number"
              if len(devs) == 1 else "one card a rank")
    return f"{NSHARD} ranks on {devs}, transport {out[0]['transport']} " \
           f"({shared})"


def phase7(e0, e_gs, out):
    """The NSHARD ranks' phase7_rank outputs `out` against phase 3's
    energies and the one-rank solve of the same bath and sectors."""
    r0 = out[0]
    say(f"phase 7: {ranks_on(out)}")
    ref_e = e0 if e_gs is None else e_gs
    for r, o in enumerate(out):
        say(f"  rank {r}: Egs {o['egs']:+.12f}, |dE| vs ARPACK "
            f"{abs(o['egs'] - e0):.3e} (gate 1e-9), in {o['t_b']:.2f} s "
            f"(diag {o['timings']['diag']:.2f} s, gf "
            f"{o['timings']['gf']:.2f} s), B5 launches {o['b5_b']}, sharded "
            f"dense applies {o['dense_b']} (diag top-off and GF), sharded GF "
            f"chains {o['gf_b']}, gf routing {o['routing']}")
        if not (abs(o["egs"] - e0) <= 1e-9 and o["b5_b"] > 0
                and o["gf_b"] > 0):
            raise AssertionError(f"rank {r}: the sharded solve misses ARPACK "
                                 "or skipped B5 or the sharded dense GF "
                                 "route")
    for o in out[1:]:
        if not (o["egs"] == r0["egs"]
                and np.array_equal(o["g_mats"], r0["g_mats"])):
            raise AssertionError("the ranks' results differ")
    ref, t_ref = _p7_solve(_p7_cfg(), DEVICE)
    d_g = float(np.abs(r0["g_mats"] - ref.g_mats).max())
    d_s = float(np.abs(r0["sigma_mats"] - ref.sigma_mats).max())
    say(f"  one-rank solve {t_ref:.2f} s, Egs {ref.state_list.emin:+.12f}"
        f", sectors {len(r0['sectors'])}; sharded vs one-rank: max|dG(iw)| "
        f"{d_g:.3e}, max|dSigma(iw)| {d_s:.3e} (max|G| "
        f"{float(np.abs(ref.g_mats).max()):.3e}, max|Sigma| "
        f"{float(np.abs(ref.sigma_mats).max()):.3e})")
    say(f"  Egs vs phase 3 {ref_e:+.12f}: |d| = "
        f"{abs(r0['egs'] - ref_e):.3e} (tol 1e-9)")
    if not abs(r0["egs"] - ref_e) <= 1e-9:
        raise AssertionError("the sharded solve's Egs differs from phase 3")
    if not (d_g <= P7_G_TOL and d_s <= P7_SIGMA_TOL):
        raise AssertionError("the sharded solve's G or Sigma differs from "
                             "the one-rank solve")
    # the main path's launches, both ranks
    return {"sharded_matvec": sum(o["b5_b"] for o in out)}


# phase 9: the hybrid and replica baths at the 854k sector
P9_HLOC = ((0.0, 0.15), (0.15, 0.1))
BHZ = dict(nk=20, m0=1.0, lam=0.3, t=0.5)   # the driver's own defaults
# loop 1's ground state of bhz5-replica lies in (5,7) and (7,5) (measured
# on an H100 by this phase): its ARPACK runs beside the build, another
# sector's after the loop
P9B_GS = (HALF - 1, HALF + 1)
# 9(b)'s loop 1 scans the sectors around the ground state's pair alone
P9B_HINT = (P9B_GS, P9B_GS[::-1])
P9_POLE_TOL = 1e-9


def _p9a_model():
    """(cfg, hloc) of hybrid10-854k: a hybrid bath, nbath = 10, the off-
    diagonal hloc, restricted to the sector (6,6) and one state."""
    import dmft_lanc_ed_tpu_torch as pt
    cfg = pt.EDConfig(norb=2, nbath=10, bath_type="hybrid", uloc=(2.0, 2.0),
                      ust=1.0, jh=0.5, beta=100.0, lmats=1024, lreal=64,
                      ed_backend="pallas", ed_sectors=True,
                      ed_sectors_shift=0, lanc_nstates_sector=1)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = P9_HLOC
    return cfg, hloc


def _p9b_model():
    """(cfg, hloc, h_basis, lambda_imp) of bhz5-replica: the BHZ driver's
    replica bath at nbath = 5 in the default configuration, one loop."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.dmft.hk import hk_bhz_2d, hloc_from_hk
    cfg = pt.EDConfig(norb=2, nspin=2, nbath=5, bath_type="replica",
                      uloc=(2.0, 2.0), ust=1.0, jh=0.5, beta=100.0,
                      lmats=1024, lfit=256, lreal=64, nloop=1,
                      ed_sectors=True)
    hloc = hloc_from_hk(hk_bhz_2d(BHZ["nk"], m0=BHZ["m0"], lam=BHZ["lam"],
                                  t=BHZ["t"]), 2, 2)
    basis, lam = pt.decompose_hloc(cfg, hloc)
    return cfg, hloc, basis, lam


def _sector_h(cfg, hloc, bath, sqn, h_basis=None):
    import dmft_lanc_ed_tpu_torch as pt
    sec = pt.SectorTable(cfg).sector(sqn)
    return pt.build_sector_hamiltonian(cfg, sec, hloc, bath,
                                       h_basis=h_basis), sec


def phase9_oracles():
    """Phase 9's host side, run in phase 1's thread: ARPACK of the hybrid
    (6,6) sector and of the BHZ P9B_GS sector at their initial baths (the
    baths the solves take), and the BHZ (6,6) op's padded shape and
    windows, built on the host."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
    out = {}
    cfg, hloc = _p9a_model()
    h, sec = _sector_h(cfg, hloc, pt.init_bath(cfg), pt.qn(HALF, HALF))
    out["hybrid"] = host_ground_state(h, sec, " hybrid10 (6,6)")[0]
    cfg, hloc, basis, lam = _p9b_model()
    bath = pt.init_bath(cfg, lam, basis)
    h, sec = _sector_h(cfg, hloc, bath, pt.qn(*P9B_GS), basis)
    out["bhz"] = host_ground_state(h, sec, f" bhz5 {P9B_GS}")[0]
    h, _ = _sector_h(cfg, hloc, bath, pt.qn(HALF, HALF), basis)
    pop = build_blocksparse_op(h, "cpu").pop
    out["bhz_op"] = (pop.padded_shape, pop.w_dw, pop.w_up)
    return out


def _pole_sums(gf):
    """(max |sum of weights - 1| over the diagonal channels, max |sum| over
    the off-diagonal ones, the off-diagonal channels)."""
    diag = [abs(gp.weights.sum() - 1.0) for (s, a, b), gp
            in gf.channels.items() if a == b]
    off = [abs(gp.weights.sum()) for (s, a, b), gp in gf.channels.items()
           if a != b]
    return max(diag), max(off, default=np.inf), len(off)


def _chain_counts():
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    return (dict(bc.launch_counts), dict(bc.step_counts),
            dict(bc.seed_counts), list(bc.chains_per_launch["gf_tridiag"]))


# the real axis at eps = 0.01 of the B4 route against the f64 chain from
# the same states and start vectors (ROADMAP C13). A chain with f32
# products places each converged pole within ~1e-7 x |E| of its f64
# position, which moves G(w) by max|G| x dp / eps next to the pole, and
# Sigma = G0^-1 - G^-1 by dG / |G|^2 where |G| is small. Where the chain
# has not converged (the interior of an 854k-state sector's spectrum after
# 200 steps), neither chain is G: the f64 chain itself moves by up to 1.15
# x max|G| between 150 and 200 steps there, and the two chains, parted
# once orthogonality is lost, carry other unconverged poles. So the real
# axis is gated where the f64 chain has converged (its 150- and 200-step
# values within REAL_CONVERGED of max|f|, at least an eighth of the grid):
# B4 within REAL_BARS of max|f| of the f64 chain there. Over the whole
# grid B4's distance and the f64 chain's own spread are printed, not gated:
# where the f64 chain has not converged it is no reference. Measured on
# the H100 (PERF.md section 2): at the converged points G 1.6e-3 to
# 4.2e-3, Sigma 7.4e-5 to 1.1e-2, chi 7.3e-6 to 2.2e-3. The bars leave
# about 2x.
REAL_CONVERGED = 1e-3
REAL_BARS = {"G": 1e-2, "Sigma": 2.5e-2, "chi": 5e-3}


def f64_reference(solver, packed, state_list, kinds=(), steps=None):
    """The GF (GFData) and the susceptibilities `kinds` ("spin", "dens")
    of `state_list` from the same states and start vectors as the
    solve's, every chain through the f64 Lanczos scan over its target's
    f64-exact apply (no B4), `steps` steps (the solve's lanc_ngfiter by
    default): {"gf": GFData, kind: ChiSet}."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import chi as pchi
    from dmft_lanc_ed_tpu_torch import gf as pgf
    from dmft_lanc_ed_tpu_torch.ops.factory import exact_apply

    class F64(pgf.HCache):
        def _build(self, sec):
            op, _ = super()._build(sec)
            return op, exact_apply(op)
    cfg = solver.cfg.replace(ed_gf_chain_min_dim=1 << 62,
                             lanc_ngfiter=steps or solver.cfg.lanc_ngfiter)
    nsym = None if solver.h_basis is None else solver.h_basis.shape[0]
    cache = F64(cfg, solver.table, solver.hloc,
                pt.unpack_bath(cfg, packed, nsym=nsym), device=DEVICE,
                h_basis=solver.h_basis)
    out = {"gf": pgf.build_gf_normal(cfg, solver.table, cache, state_list)}
    for kind in kinds:
        out[kind] = getattr(pchi, f"build_chi_{kind}")(
            cfg, solver.table, cache, state_list)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def real_axis_check(name, got, want, want_short, bar):
    """Whether B4's values `got` on the real grid (the last axis) are
    within `bar` of the f64 chain's `want` where that chain has converged
    against its shorter chain's `want_short`, relative to max|want|
    (module comment at REAL_BARS); prints that distance, the converged
    points, and B4's distance and the f64 chain's spread over the grid."""
    axes = tuple(range(np.ndim(want) - 1))
    scale = float(np.abs(want).max())
    d = np.abs(got - want).max(axis=axes) / scale
    spread = np.abs(want_short - want).max(axis=axes) / scale
    conv = spread <= REAL_CONVERGED
    d_conv = float(d[conv].max()) if conv.any() else 0.0
    ok = conv.sum() >= len(conv) // 8 and d_conv <= bar
    say(f"    {name}(w): {int(conv.sum())}/{len(conv)} points converged, "
        f"B4 there {d_conv:.3e} (gate {bar:g}); over the grid "
        f"{float(d.max()):.3e}, the f64 chain's own 150 vs 200 steps "
        f"{float(spread.max()):.3e} (printed)")
    return ok


def real_axis_gates(label, solver, packed, res, kinds=()):
    """The solve's G(iw) within B4's contract (2e-5 x max|G|) and its
    G(w) and Sigma(w) through real_axis_check, against f64_reference's
    chains of the solve's length and of three quarters of it; with
    `kinds`, the total channel of each kind too: chi(iv_n), n < P11_NIV,
    at B4's contract and chi(w) through real_axis_check. Returns the two
    references."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.gf import build_sigma
    from dmft_lanc_ed_tpu_torch.solver import (bosonic_grid, matsubara_grid,
                                               real_grid)
    cfg = solver.cfg
    t0 = time.perf_counter()
    refs = [f64_reference(solver, packed, res.state_list, kinds, steps)
            for steps in (None, 3 * cfg.lanc_ngfiter // 4)]
    nsym = None if solver.h_basis is None else solver.h_basis.shape[0]
    bath = pt.unpack_bath(cfg, packed, nsym=nsym)
    zr, wr = real_grid(cfg) + 1j * cfg.eps, real_grid(cfg)
    g_iw = refs[0]["gf"].evaluate(cfg, 1j * matsubara_grid(cfg))
    d_iw = {"G(iw)": (_rel(res.g_mats, g_iw), 2e-5)}
    real = [build_sigma(cfg, solver.hloc, bath, r["gf"], zr, solver.h_basis)
            for r in refs]
    vm = bosonic_grid(cfg)
    for kind in kinds:
        a, b = getattr(res, f"chi_{kind}")[(-1, -1)], refs[0][kind][(-1, -1)]
        iv_a, iv_b = a.matsubara(cfg.beta, vm), b.matsubara(cfg.beta, vm)
        d_iw[f"chi_{kind}(iv)"] = (float(np.abs(iv_a - iv_b)[:P11_NIV].max()
                                         / np.abs(iv_b).max()), P11_CHI_TOL)
    say(f"  {label} vs the f64 chains from the same states "
        f"({2 * (1 + len(kinds))} f64 builds in "
        f"{time.perf_counter() - t0:.2f} s; of max|f|; eps = {cfg.eps:g}, "
        f"{len(wr)} real points): " + ", ".join(
            f"{k} {v:.3e} (gate {b:g})" for k, (v, b) in d_iw.items()))
    ok = all(v <= b for v, b in d_iw.values())
    ok &= real_axis_check("G", res.g_real, real[0][1], real[1][1],
                          REAL_BARS["G"])
    ok &= real_axis_check("Sigma", res.sigma_real, real[0][0], real[1][0],
                          REAL_BARS["Sigma"])
    for kind in kinds:
        w = [r[kind][(-1, -1)].realaxis(cfg.beta, wr, cfg.eps) for r in refs]
        ok &= real_axis_check(
            f"chi_{kind}", getattr(res, f"chi_{kind}")[(-1, -1)].realaxis(
                cfg.beta, wr, cfg.eps), w[0], w[1], REAL_BARS["chi"])
    if not ok:
        raise AssertionError(f"{label}: a gate against the f64 chains "
                             "fails")
    return refs


def phase9a(e_ref):
    """hybrid10-854k: one restricted solve, gated against host ARPACK,
    then its mixed chain against the true-f32 plain chain."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.gf import HCache, apply_op
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    cfg, hloc = _p9a_model()
    solver = pt.EDSolver(cfg, hloc, device=DEVICE)
    solver.diag_state.sector_hint = [pt.qn(HALF, HALF)]
    packed = solver.init_bath()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(packed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, steps, seeds, chains = _chain_counts()
    st = res.state_list.states[0]
    de = abs(res.state_list.emin - e_ref)
    d_diag, d_off, n_off = _pole_sums(res.gf)
    sym = np.array_equal(res.g_mats[0, 0, 0, 1], res.g_mats[0, 0, 1, 0])
    say(f"phase 9(a) hybrid10-854k: sector {st.qn}, Egs "
        f"{res.state_list.emin:+.12f}, |dE| vs ARPACK {de:.3e} (gate "
        f"1e-10); {dt:.2f} s (diag {res.timings['diag']:.2f} s, gf "
        f"{res.timings['gf']:.2f} s); launches {counts}, steps {steps}, "
        f"chain seeds {seeds}, chains of each B4 launch {chains}, gf "
        f"routing {res.gf.routing}; pole-weight sums: diagonal |1 - sum| "
        f"{d_diag:.3e}, {n_off} off-diagonal |sum| {d_off:.3e} (tol "
        f"{P9_POLE_TOL:g}); G_01 == G_10: {sym}; max|G_01(iw)| "
        f"{float(np.abs(res.g_mats[0, 0, 0, 1]).max()):.3e}")
    if not de <= 1e-10:
        raise AssertionError("hybrid10-854k misses the ARPACK energy")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"a chain kernel never launched: {counts}")
    if not (chains and all(c == 3 for c in chains)):
        raise AssertionError(f"B4 launches did not carry 3 chains: {chains}")
    if not (d_diag <= P9_POLE_TOL and d_off <= P9_POLE_TOL and n_off == 2):
        raise AssertionError("the pole-weight identities fail")
    if not (sym and np.all(np.isfinite(res.sigma_mats))
            and np.all(np.isfinite(res.sigma_real))):
        raise AssertionError("G_01 != G_10 or Sigma not finite")
    # the mixed chain (c+_0 + c+_1)|GS> into (7,6) against the f32 chain
    table = solver.table
    jqn = table.cdg_sector(st.qn, 0, 0)
    sec_i, sec_j = table.sector(st.qn), table.sector(jqn)
    bath = pt.unpack_bath(cfg, packed)
    op_j, _ = HCache(cfg, table, hloc, bath, device=DEVICE)(jqn)
    vv = (apply_op(cfg, sec_i, sec_j, st.vec, 0, 0, True)
          + apply_op(cfg, sec_i, sec_j, st.vec, 1, 0, True))
    _, g_k, g_6, g_f = _gf_chain_vs_plain(op_j, vv, st.e, cfg.lanc_ngfiter)
    d_f = float(np.abs(g_k - g_f).max())
    say(f"  B4 on (c+_0 + c+_1)|GS> in {jqn} padded {op_j.padded_shape}, "
        f"m={cfg.lanc_ngfiter}: max|dG(iw)| vs the true-f32 plain version "
        f"{d_f:.3e} (tol 2e-5), vs the six-pass plain version "
        f"{float(np.abs(g_k - g_6).max()):.3e}, max|G| "
        f"{float(np.abs(g_f).max()):.3e}")
    if not d_f <= 2e-5:
        raise AssertionError("B4 on the mixed chain misses the f32 GF "
                             "contract")
    real_axis_gates("hybrid10-854k", solver, packed, res)
    return counts, steps, dt


def phase9b(oracle):
    """bhz5-replica: the BHZ driver's loop 1 in the default configuration,
    gated against host ARPACK of its ground-state sector."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import _kernels
    from dmft_lanc_ed_tpu_torch.models import bhz_2d
    cfg, hloc, basis, lam = _p9b_model()
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 9(b) must run the default configuration")
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    with sector_hint(bhz_2d, [pt.qn(*q) for q in P9B_HINT]):
        res = bhz_2d.run_dmft(cfg, device=DEVICE, verbose=False, **BHZ)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, steps, seeds, chains = _chain_counts()
    ent = res.history[0]
    states = ent["state_list"].states
    gs = min(states, key=lambda s: s.e)
    init = pt.pack_bath(cfg, pt.init_bath(cfg, lam, basis))
    if ent["bath"].tobytes() != init.tobytes():
        raise AssertionError("loop 1 did not start from init_bath")
    if any(s.qn == pt.qn(*P9B_GS) for s in states):
        sqn, e_ref = pt.qn(*P9B_GS), oracle["bhz"]
    else:
        sqn = gs.qn
        h, sec = _sector_h(cfg, hloc, pt.unpack_bath(cfg, init, len(lam)),
                           sqn, basis)
        e_ref = host_ground_state(h, sec, f" bhz5 {sqn}")[0]
    de = abs(ent["egs"] - e_ref)
    d_diag, d_off, n_off = _pole_sums(ent["gf_data"])
    (ddp, dup), w_dw, w_up = oracle["bhz_op"]
    tile = _kernels.lib().bs_chain_tc_tile(ddp, dup, 1, 2)
    say(f"phase 9(b) bhz5-replica: run_dmft nbath={cfg.nbath} nk="
        f"{BHZ['nk']}, {len(basis)} symmetries, 1 loop in {dt:.1f} s: diag "
        f"{ent['diag']:.2f} s, gf {ent['gf']:.2f} s, fit {ent['fit']:.2f} "
        f"s; {len(states)} states in {sorted({s.qn for s in states})}, Egs "
        f"{ent['egs']:+.12f}, sector {sqn} ARPACK {e_ref:+.12f}, |dE| "
        f"{de:.3e} (gate 1e-9); dens {ent['dens']}")
    say(f"  launches {counts}, steps {steps}, chain seeds {seeds}, chains "
        f"of each B4 launch {chains}, gf routing {ent['routing']}; "
        f"pole-weight sums: diagonal |1 - sum| {d_diag:.3e}, {n_off} "
        f"off-diagonal |sum| {d_off:.3e} (tol {P9_POLE_TOL:g}); (6,6) "
        f"padded {ddp} x {dup}, window W_dw {w_dw}, W_up {w_up}, B2/B3 "
        f"tile 64 x {tile}")
    if not de <= 1e-9:
        raise AssertionError("bhz5-replica misses the ARPACK energy")
    if seeds["missed"] > 0 or seeds["reached"] <= 0:
        raise AssertionError(f"a chain seed missed its eta_target: {seeds}")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"a chain kernel never launched: {counts}")
    if not (chains and min(chains) > 1):
        raise AssertionError(f"a B4 launch carried one chain: {chains}")
    if not (d_diag <= P9_POLE_TOL and d_off <= P9_POLE_TOL and n_off == 4):
        raise AssertionError("the pole-weight identities fail")
    if not np.all((res.dens >= 0) & (res.dens <= 2)):
        raise AssertionError(f"dens out of range: {res.dens}")
    if not (np.all(np.isfinite(res.sigma_mats))
            and np.all(np.isfinite(res.sigma_real))):
        raise AssertionError("Sigma not finite")
    if not (len(res.bath) == pt.bath_dimension(cfg, len(basis))
            and np.all(np.isfinite(res.bath))):
        raise AssertionError("the replica fit returned a bad bath")
    return counts, steps, dt


# phase 10: the three-orbital Kanamori driver at the 854k sector
P10_NBATH = 3             # Ns = 3 x (1 + 3) = 12: (6,6) holds 853,776 states


def _p10_model():
    """(cfg, hloc) of kanamori3-854k: multiorb_kanamori's main() model (norb
    3, uloc 2.5, ust 1.5, jh 0.5, Jx = Jp = 0, no crystal field) at nbath =
    3, T = 0, one loop, in the default configuration."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.models.multiorb_kanamori import DEFAULTS
    cfg = pt.EDConfig(nbath=P10_NBATH, beta=100.0, lmats=1024, lfit=256,
                      lreal=64, nloop=1, **DEFAULTS)
    return cfg, np.zeros((1, 1, cfg.norb, cfg.norb))


def phase10_oracle():
    """Phase 10's host side, run in phase 1's thread: ARPACK of the (6,6)
    sector at the initial bath (the bath loop 1 takes), and that sector's
    band-sparse op built on the host: applicability, padded shape,
    windows, diagonal rank and trim share."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import (
        blocksparse_applicable, build_blocksparse_op, trim_share)
    cfg, hloc = _p10_model()
    h, sec = _sector_h(cfg, hloc, pt.init_bath(cfg), pt.qn(HALF, HALF))
    e0 = host_ground_state(h, sec, " kanamori3 (6,6)")[0]
    pop = build_blocksparse_op(h, "cpu").pop
    return dict(e0=e0, dim=sec.dim, applicable=blocksparse_applicable(h),
                shape=pop.padded_shape, w_dw=pop.w_dw, w_up=pop.w_up,
                rank=pop.diag_a.shape[1], trim=trim_share(pop))


def phase10(oracle):
    """kanamori3-854k: multiorb_kanamori.run_dmft's loop 1 in the default
    configuration, gated against host ARPACK of (6,6); then write_all and
    the fit's diagnostic files into a temporary directory, read back and
    restored."""
    import tempfile
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import _kernels
    from dmft_lanc_ed_tpu_torch import io as edio
    from dmft_lanc_ed_tpu_torch.fit import chi2_fitgf
    from dmft_lanc_ed_tpu_torch.models import multiorb_kanamori
    from dmft_lanc_ed_tpu_torch.ops import batched as bt
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    cfg, hloc = _p10_model()
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 10 must run the default configuration")
    t_all = time.perf_counter()
    bc.reset_launch_counts()
    bt.reset_bucket_counts()
    t0 = time.perf_counter()
    res = multiorb_kanamori.run_dmft(cfg, device=DEVICE, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, steps, seeds, chains = _chain_counts()
    buckets = dict(bt.bucket_counts)
    ent = res.history[0]
    r1 = ent["result"]
    table = pt.SectorTable(cfg)
    log66 = [e for q, e, _ in ent["diag_log"] if q == pt.qn(HALF, HALF)]
    e66 = float(np.min(log66[0])) if log66 else float("nan")
    de = abs(e66 - oracle["e0"])
    large = [q for q, _, k in ent["diag_log"]
             if k and table.dim(q) > cfg.ed_batch_dim_max]
    states = r1.state_list.states
    mv = ent["timings"]["kernel_matvecs"]
    n_steps = sum(steps.values())
    (ddp, dup) = oracle["shape"]
    tile = _kernels.lib().bs_chain_tc_tile(ddp, dup, 1, 2)
    say(f"phase 10 kanamori3-854k: multiorb_kanamori.run_dmft norb=3 "
        f"nbath={cfg.nbath}, 1 loop in {dt:.1f} s ({CARD}): diag "
        f"{ent['diag']:.2f} s, gf {ent['gf']:.2f} s, fit {ent['fit']:.2f} "
        f"s; {len(states)} states in {sorted({s.qn for s in states})}, Egs "
        f"{ent['egs']:+.12f}; (6,6) dim {oracle['dim']} lowest "
        f"{e66:+.12f}, ARPACK {oracle['e0']:+.12f}, |dE| {de:.3e} (gate "
        f"1e-10)")
    say(f"  (6,6) band-sparse: applicable {oracle['applicable']}, padded "
        f"{ddp} x {dup}, window W_dw {oracle['w_dw']}, W_up "
        f"{oracle['w_up']}, diagonal rank {oracle['rank']}, trim share "
        f"{oracle['trim']:.3f}, B2/B3 tile 64 x {tile}")
    say(f"  launches {counts}, steps {steps}, chain seeds {seeds} over "
        f"{len(large)} band-sparse sectors, chains of each B4 launch "
        f"{chains}, gf routing {ent['routing']}, batched {buckets}; "
        f"kernel_matvecs {mv} (chain steps {n_steps}), kernel_nnz_applied "
        f"{ent['timings']['kernel_nnz_applied']}; dens {ent['dens']}, docc "
        f"{ent['docc']}")
    if not oracle["applicable"]:
        raise AssertionError("the (6,6) sector is not band-sparse")
    if not de <= 1e-10:
        raise AssertionError("kanamori3-854k (6,6) misses the ARPACK energy")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"a chain kernel never launched: {counts}")
    if seeds["missed"] > 0 or seeds["reached"] < len(large):
        raise AssertionError(f"a large sector missed the chain seed or its "
                             f"eta_target: {seeds}, {len(large)} sectors")
    if buckets["buckets"] <= 0:
        raise AssertionError("no batched bucket was solved")
    if not (ent["routing"][0] > 0 and chains):
        raise AssertionError("no GF chain ran through B4")
    if not mv >= n_steps > 0:
        raise AssertionError("kernel_matvecs below the chain steps")
    dens, docc = np.asarray(ent["dens"]), np.asarray(ent["docc"])
    if not np.all((dens >= 0) & (dens <= 2)):
        raise AssertionError(f"dens out of range: {dens}")
    if not (np.ptp(dens) <= 1e-6 and np.ptp(docc) <= 1e-6):
        raise AssertionError("the degenerate orbitals' dens/docc differ")
    outs = [res.sigma_mats, res.sigma_real, res.g_mats, res.weiss, res.bath]
    if not all(np.all(np.isfinite(x)) for x in outs):
        raise AssertionError("non-finite DMFT output")
    # the files: write_all and the loop's fit again with its diagnostics
    with tempfile.TemporaryDirectory() as d:
        edio.write_all(cfg, r1, res.bath, outdir=d)
        refit = chi2_fitgf(cfg, res.weiss, ent["bath"], hloc, outdir=d)
        names = sorted(os.listdir(d))
        back = edio.read_gf_files(cfg, "impSigma", outdir=d)
        d_sig = float(np.abs(back - r1.sigma_mats).max())
        solver = pt.EDSolver(cfg, hloc, device=DEVICE)
        bath_r = solver.restore(d)
        d_bath = float(np.abs(bath_r - res.bath).max())
        per_sector = {}
        for st in states:
            per_sector[st.qn] = per_sector.get(st.qn, 0) + 1
    fit_files = [n for n in names if n.startswith(("fit_weiss",
                                                   "chi2fit_results"))]
    say(f"  files: {len(names)} written ({len(fit_files)} of the fit); "
        f"impSigma read back max|d| {d_sig:.3e} (tol 1e-8, 9 decimals); "
        f"restored bath max|d| {d_bath:.3e} (tol 1e-11, 12 decimals); "
        f"neigen_sector {solver.diag_state.neigen_sector}; the refit equals "
        f"the loop's bath: {refit.tobytes() == res.bath.tobytes()}")
    if len(fit_files) != 2 * cfg.norb:
        raise AssertionError(f"the fit's diagnostic files: {fit_files}")
    if not (d_sig <= 1e-8 and d_bath <= 1e-11):
        raise AssertionError("the written files do not read back")
    if solver.diag_state.neigen_sector != per_sector:
        raise AssertionError("restore's neigen_sector differs from the "
                             "state list")
    say(f"phase 10: {time.perf_counter() - t_all:.1f} s ({CARD})")
    return counts, steps, dt


# phase 11: spin and charge susceptibilities of kanamori3 at the 854k sector
P11_NIV = 64              # the Matsubara points the f64-chain gate reads
P11_CHI_TOL = 2e-5        # x max|chi|: B4's GF contract (PERF.md section 2)


def _p11_model():
    """(cfg, hloc) of kanamori3-chi-854k: phase 10's model with both
    susceptibilities, one solve restricted to the (6,6) sector."""
    cfg, hloc = _p10_model()
    return cfg.replace(chispin_flag=True, chidens_flag=True,
                       ed_sectors=True, ed_sectors_shift=0), hloc


def _lowest_ritz_beta_de(cfg, op, st, table, m):
    """beta * (lowest Ritz value - E_psi) of the WHOLE start vector n|psi>
    (orbital 0 and the total, no exact pole taken out), from B4 and from
    the f64 chain: the dE = 0 pole's distance to the iv_0 cut 1e-3."""
    import torch
    from dmft_lanc_ed_tpu_torch import chi as pchi
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import matvec_bs_exact_flat
    from dmft_lanc_ed_tpu_torch.ops.lanczos import (lanczos_tridiag_batched,
                                                    tridiag_eigh)
    sec = table.sector(st.qn)
    n_op = pchi._n_op(cfg)
    vs = np.stack([pchi._diag_op_excite(sec, st.vec, n_op(sec, 0)),
                   pchi._diag_op_excite(sec, st.vec, sum(
                       n_op(sec, a) for a in range(cfg.norb)))])
    vs /= np.linalg.norm(vs, axis=1)[:, None]
    chains = {"B4": bc.gf_tridiag_batch(op, vs, m),
              "f64": lanczos_tridiag_batched(
                  op, torch.as_tensor(vs, device=op.device), m,
                  matvec_bs_exact_flat)}
    return {name: [cfg.beta * (tridiag_eigh(a, b)[0][0] - st.e)
                   for a, b in zip(*ab)] for name, ab in chains.items()}


def phase11(oracle):
    """kanamori3-chi-854k: one solve of phase 10's model restricted to
    (6,6) with both susceptibilities; every chi chain through B4 at 7 a
    launch, gated against an f64 chain from the same start vectors."""
    import tempfile
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import chi as pchi
    from dmft_lanc_ed_tpu_torch import io as edio
    from dmft_lanc_ed_tpu_torch.gf import HCache
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.solver import (bosonic_grid, real_grid,
                                               tau_grid)
    cfg, hloc = _p11_model()
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 11 must run the default configuration")
    t_all = time.perf_counter()
    solver = pt.EDSolver(cfg, hloc, device=DEVICE)
    solver.diag_state.sector_hint = [pt.qn(HALF, HALF)]
    packed = solver.init_bath()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(packed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, steps, seeds, chains = _chain_counts()
    states = res.state_list.states
    k = len(states)
    de = abs(res.state_list.emin - oracle["e0"])
    routing = dict(pchi.routing)
    say(f"phase 11 kanamori3-chi-854k: one solve at (6,6) in {dt:.2f} s "
        f"({CARD}): diag {res.timings['diag']:.2f} s, gf "
        f"{res.timings['gf']:.2f} s, chi {res.timings['chi']:.2f} s; {k} "
        f"state(s) in {sorted({s.qn for s in states})}, Egs "
        f"{res.state_list.emin:+.12f}, ARPACK {oracle['e0']:+.12f}, |dE| "
        f"{de:.3e} (gate 1e-10)")
    say(f"  launches {counts}, steps {steps}, chain seeds {seeds}, chains "
        f"of each B4 launch {chains}, gf routing {res.gf.routing}, chi "
        f"routing {routing}")
    if not de <= 1e-10:
        raise AssertionError("kanamori3-chi-854k misses the ARPACK energy")
    if sorted(chains) != sorted([3 * k, 3 * k, 7 * k, 7 * k]):
        raise AssertionError(f"B4 launches carried {chains}, not 3k, 3k, "
                             f"7k, 7k for k = {k}")
    if not (routing["spin"] == routing["dens"] == (7 * k, 0)):
        raise AssertionError(f"a chi chain missed B4: {routing}")
    # the f64 chains from the same start vectors: the GF and the total
    # channel of each kind through real_axis_gates, orbital 0's here
    table = solver.table
    op, _ = HCache(cfg, table, hloc, pt.unpack_bath(cfg, packed),
                   device=DEVICE)(pt.qn(HALF, HALF))
    refs = real_axis_gates("kanamori3-chi-854k", solver, packed, res,
                           ("spin", "dens"))
    vm, tau, wr = bosonic_grid(cfg), tau_grid(cfg), real_grid(cfg)
    worst, real_ok = 0.0, True
    for kind in ("spin", "dens"):
        a = getattr(res, f"chi_{kind}")[(0, 0)]
        b = refs[0][kind][(0, 0)]
        iv_a, iv_b = a.matsubara(cfg.beta, vm), b.matsubara(cfg.beta, vm)
        d_iv = float(np.abs(iv_a - iv_b)[:P11_NIV].max())
        scale = float(np.abs(iv_b).max())
        d_tau = float(np.abs(a.imtime(tau) - b.imtime(tau)).max())
        worst = max(worst, d_iv / scale)
        say(f"  chi_{kind}(0, 0) vs the f64 chain: max|d| iv (n < "
            f"{P11_NIV}) {d_iv:.3e} (gate {P11_CHI_TOL:g} x max|chi| = "
            f"{P11_CHI_TOL * scale:.3e}), tau {d_tau:.3e}; chi(iv_0) "
            f"{iv_a[0]:+.9f}")
        real_ok &= real_axis_check(
            f"chi_{kind}(0, 0)", a.realaxis(cfg.beta, wr, cfg.eps),
            b.realaxis(cfg.beta, wr, cfg.eps),
            refs[1][kind][(0, 0)].realaxis(cfg.beta, wr, cfg.eps),
            REAL_BARS["chi"])
    if not worst <= P11_CHI_TOL:
        raise AssertionError("chi misses B4's contract against the f64 "
                             "chain")
    if not real_ok:
        raise AssertionError("chi(w) misses its real-axis gates against "
                             "the f64 chains")
    bde = _lowest_ritz_beta_de(cfg, op, states[0], table,
                               min(table.dim(pt.qn(HALF, HALF)),
                                   cfg.lanc_ngfiter))
    say(f"  the whole n|psi> chain (orbital 0, total): beta * (lowest "
        f"Ritz - E) B4 {['%.3e' % x for x in bde['B4']]}, f64 "
        f"{['%.3e' % x for x in bde['f64']]} (iv_0 cut 1e-3; the solve "
        f"stores that pole exactly)")
    # the degenerate orbitals, chi_ab == chi_ba, chi(iv_0) > 0
    for kind in ("spin", "dens"):
        chis = getattr(res, f"chi_{kind}")
        dia = [chis[(a, a)].matsubara(cfg.beta, vm) for a in range(3)]
        mix = [chis[(a, b)].matsubara(cfg.beta, vm)
               for a in range(3) for b in range(a + 1, 3)]
        s_d = float(np.abs(dia[0]).max())
        r_d = max(float(np.abs(x - dia[0]).max()) for x in dia) / s_d
        # chi_ab = (chi_mix - chi_aa - chi_bb) / 2 cancels: its spread is
        # held to B4's contract on the scale of the channels it comes from
        r_m = max(float(np.abs(x - mix[0]).max()) for x in mix) / s_d
        sym = all(np.array_equal(chis[(a, b)].matsubara(cfg.beta, vm),
                                 chis[(b, a)].matsubara(cfg.beta, vm))
                  for a in range(3) for b in range(3))
        say(f"  chi_{kind}: diagonal channels agree to {r_d:.2e} (gate "
            f"1e-6), mixed to {r_m:.2e} (gate {P11_CHI_TOL:g}) of "
            f"max|chi_aa|, chi_ab == chi_ba: {sym}, "
            f"chi_aa(iv_0) {[round(float(x[0]), 9) for x in dia]}, "
            f"chi_ab(iv_0) {[round(float(x[0]), 9) for x in mix]}")
        if not (r_d <= 1e-6 and r_m <= P11_CHI_TOL and sym):
            raise AssertionError(f"chi_{kind}: the degenerate orbitals "
                                 "differ")
        if not all(x[0] > 0 for x in dia):
            raise AssertionError(f"chi_{kind}(iv_0) <= 0 on the diagonal")
    with tempfile.TemporaryDirectory() as d:
        edio.write_all(cfg, res, packed, outdir=d)
        names = sorted(n for n in os.listdir(d) if "Chi_" in n)
        d_file = 0.0
        for kind in ("spin", "dens"):
            for key, chi in getattr(res, f"chi_{kind}").items():
                lbl = "tot" if key[0] < 0 else f"{key[0] + 1}{key[1] + 1}"
                for grid, x, f in (
                        ("iv", vm, chi.matsubara(cfg.beta, vm)),
                        ("tau", tau, chi.imtime(tau)),
                        ("realw", wr, chi.realaxis(cfg.beta, wr, cfg.eps))):
                    back = np.loadtxt(os.path.join(
                        d, f"{kind}Chi_l{lbl}_{grid}.ed"))
                    got = back[:, 1] if back.shape[1] == 2 else \
                        back[:, 2] + 1j * back[:, 1]
                    d_file = max(d_file, float(np.abs(back[:, 0] - x).max()),
                                 float(np.abs(got - f).max()))
    want = 2 * 3 * (cfg.norb ** 2 + 1)
    say(f"  files: {len(names)} spinChi/densChi files (want {want}), read "
        f"back max|d| {d_file:.3e} (tol 1e-9, 9 decimals)")
    if not (len(names) == want and d_file <= 1e-9):
        raise AssertionError("the chi files do not read back")
    say(f"phase 11: {time.perf_counter() - t_all:.1f} s ({CARD})")
    return counts, steps, dt


# phase 12: phonons, Jx/Jp and full ED on the dense path (cuBLAS)
P12_MODELS = {
    # a Holstein impurity: (4,4) holds 4,900 x 11 = 53,900 states
    "holstein7": (dict(norb=1, nbath=7, uloc=(2.0,), nph=10, g_ph=(0.5,),
                       w0_ph=0.8), (4, 4)),
    # two orbitals with spin exchange and pair hopping: (5,5) holds 63,504
    "kanamori2-jxjp": (dict(norb=2, nbath=4, uloc=(2.0, 2.0), ust=1.0,
                            jh=0.5, jx=0.5, jp=0.5), (5, 5)),
}
# each solve restricted to the 9 sectors around the half-filled one
P12_GRID = dict(beta=100.0, lmats=1024, lreal=64, ed_sectors=True)
# full ED against the Krylov solve (test_solver.py / test_chi.py models)
P12_FULL = dict(norb=1, nbath=3, uloc=(2.0,), beta=10.0, lmats=256,
                lreal=64, ed_finite_temp=True, lanc_nstates_total=4096,
                chispin_flag=True, chidens_flag=True)


def phase12_oracles(names=tuple(P12_MODELS)):
    """Phase 12's host side, run in phase 1's thread: ARPACK of each
    model's half-filled sector at the initial bath, every sector term in
    the assembled CSR."""
    import dmft_lanc_ed_tpu_torch as pt
    out = {}
    for name in names:
        model, sqn = P12_MODELS[name]
        cfg = pt.EDConfig(**model, **P12_GRID)
        h, sec = _sector_h(cfg, np.zeros((1, 1, cfg.norb, cfg.norb)),
                           pt.init_bath(cfg), pt.qn(*sqn))
        out[name] = host_ground_state(h, sec, f" {name} {sqn}")[0]
    return out


def _p12_solve(cfg, sqn):
    """One solve restricted to the sectors around `sqn`: (result, s,
    batched bucket counts)."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.ops import batched as bt
    solver = pt.EDSolver(cfg, np.zeros((1, 1, cfg.norb, cfg.norb)),
                         device=DEVICE)
    solver.diag_state.sector_hint = [pt.qn(*sqn)]
    bt.reset_bucket_counts()
    t0 = time.perf_counter()
    res = solver.solve(solver.init_bath())
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(bt.bucket_counts)


def phase12(oracles):
    """(a) holstein7 and (b) kanamori2-jxjp: the default configuration
    against host ARPACK; batched against serial, both f64; (c) full ED
    against the Krylov solve on the card."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import chi as pchi
    t_all = time.perf_counter()
    for part, (name, (model, sqn)) in zip("ab", P12_MODELS.items()):
        t_p = time.perf_counter()
        cfg = pt.EDConfig(**model, **P12_GRID)
        if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
            raise AssertionError("phase 12 must run the default "
                                 "configuration")
        res, dt, bk = _p12_solve(cfg, sqn)
        gs = res.state_list.states[0]
        if gs.qn == pt.qn(*sqn):
            e_ref = oracles[name]
        else:
            h, sec = _sector_h(cfg, np.zeros((1, 1, cfg.norb, cfg.norb)),
                               pt.init_bath(cfg), gs.qn)
            e_ref = host_ground_state(h, sec, f" {name} {gs.qn}")[0]
        de = abs(res.state_list.emin - e_ref)
        f64 = dict(ed_precision="f64")
        rb, dt_b, bk_b = _p12_solve(cfg.replace(**f64), sqn)
        _ONE_RANK[name] = rb, dt_b
        rs, dt_s, bk_s = _p12_solve(cfg.replace(ed_batch_sectors=False,
                                                **f64), sqn)
        d_e = abs(rb.state_list.emin - rs.state_list.emin)
        d_n = float(np.abs(rb.observables.dens - rs.observables.dens).max())
        d_g = float(np.abs(rb.g_mats - rs.g_mats).max())
        m_n = float(np.abs(res.observables.dens - rs.observables.dens).max())
        m_g = float(np.abs(res.g_mats - rs.g_mats).max())
        say(f"phase 12({part}) {name}: {len(res.state_list.states)} "
            f"state(s) in {sorted({s.qn for s in res.state_list.states})}, "
            f"ground-state sector dim {pt.SectorTable(cfg).dim(gs.qn)}; the "
            f"default configuration (mixed, batched) in {dt:.2f} s: Egs "
            f"{res.state_list.emin:+.12f}, host ARPACK {e_ref:+.12f}, |dE| "
            f"{de:.3e} (gate 1e-10), buckets {bk}")
        say(f"  f64 batched ({dt_b:.2f} s, buckets {bk_b}) vs f64 serial "
            f"({dt_s:.2f} s, buckets {bk_s}): |dEgs| {d_e:.3e} (gate 1e-9), "
            f"dens {d_n:.3e} (1e-8), G(iw) {d_g:.3e} (1e-7); the default "
            f"(mixed) vs f64 serial, printed: dens {m_n:.3e}, G(iw) "
            f"{m_g:.3e}")
        if not de <= 1e-10:
            raise AssertionError(f"{name} misses the ARPACK energy")
        if not (bk["buckets"] > 0 and bk_b["buckets"] > 0
                and bk_s["buckets"] == 0):
            raise AssertionError(f"{name}: buckets {bk}, {bk_b}, {bk_s}")
        if not (d_e <= 1e-9 and d_n <= 1e-8 and d_g <= 1e-7):
            raise AssertionError(f"{name}: batched differs from serial")
        if not all(np.all(np.isfinite(x)) for x in (
                res.sigma_mats, res.g_mats, rb.g_mats)):
            raise AssertionError(f"{name}: non-finite output")
        if "holstein" in name:
            occ = res.observables.ph_occ
            ph = res.gf_phonon
            d_occ = abs(float(occ.sum()) - 1.0)
            say(f"  phonons: sum ph_occ - 1 = {d_occ:.3e} (tol 1e-8), "
                f"<x> {res.observables.x_ph:+.6f}, D(iv_0) "
                f"{-ph.matsubara(cfg.beta, np.zeros(1))[0]:+.6f}, phonon "
                f"chain routing {pchi.routing.get('phonon')}")
            if not (d_occ <= 1e-8 and ph is not None and len(ph.peso)):
                raise AssertionError("holstein7: phonon observables")
        say(f"  phase 12({part}): {time.perf_counter() - t_p:.1f} s")
    # (c) full ED against the Krylov solve on the card
    t_p = time.perf_counter()
    cfg_f = pt.EDConfig(ed_diag_type="full", **P12_FULL)
    cfg_l = pt.EDConfig(lanc_nstates_sector=4096, lanc_dim_threshold=4096,
                        ed_precision="f64", **P12_FULL)
    bath = pt.EDSolver(cfg_f, device=DEVICE).init_bath()
    rf = pt.EDSolver(cfg_f, device=DEVICE).solve(bath)
    rl = pt.EDSolver(cfg_l, device=DEVICE).solve(bath)
    d_e = abs(rf.state_list.emin - rl.state_list.emin)
    d_g = float(np.abs(rf.g_mats - rl.g_mats).max())
    d_n = float(np.abs(rf.observables.dens - rl.observables.dens).max())
    vm = np.pi / cfg_f.beta * 2 * np.arange(cfg_f.lmats)
    d_chi = max(float(np.abs(getattr(rf, k)[c].matsubara(cfg_f.beta, vm)
                             - getattr(rl, k)[c].matsubara(cfg_f.beta, vm)
                             ).max())
                for k in ("chi_spin", "chi_dens") for c in getattr(rf, k))
    say(f"phase 12(c) full ED: {rf.state_list.size} states (all "
        f"{4 ** cfg_f.ns}) vs the Krylov solve on the card "
        f"({rl.state_list.size} states, f64): |dEgs| {d_e:.3e} (gate 1e-9), "
        f"G(iw) {d_g:.3e} (1e-5), dens {d_n:.3e} (1e-6), chi(iv) "
        f"{d_chi:.3e} (1e-8); {time.perf_counter() - t_p:.1f} s")
    if not (rf.state_list.size == 4 ** cfg_f.ns and d_e <= 1e-9
            and d_g <= 1e-5 and d_n <= 1e-6 and d_chi <= 1e-8):
        raise AssertionError("full ED differs from the Krylov solve")
    say(f"phase 12: {time.perf_counter() - t_all:.1f} s ({CARD})")


# phase 13: the lattice bank, the two-sublattice AFO driver at the 854k sector
P13_NBATH = 5             # Ns = 2 x (1 + 5) = 12: (6,6) holds 853,776 states
P13_DIALS = dict(wband=(1.0, 0.5), delta=0.0)   # tests/test_dmft.py:106


def _p13_model():
    """cfg of afo2-854k: the JAX test's two-band AFO model (uloc 1, ust
    0.25, sb_field 0.1) at nbath = 5, T = 0, one loop, in the default
    configuration."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(norb=2, nspin=2, nbath=P13_NBATH, uloc=(1.0, 1.0),
                       ust=0.25, sb_field=0.1, beta=100.0, lmats=1024,
                       lfit=256, lreal=64, nloop=1)


def _p13_bath_a(cfg):
    """Site A's initial packed bath: init_bath staggered by +sb_field (site
    B's is its spin flip, sign -1)."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.break_symmetry_bath(cfg, pt.pack_bath(cfg, pt.init_bath(cfg)),
                                  cfg.sb_field, sign=1.0)


def phase13_oracle():
    """Phase 13's host side, run in phase 1's thread: ARPACK of site A's
    (6,6) sector at its initial bath. The spin flip maps (6,6) onto itself
    and site A's bath onto site B's, so it is both sites' oracle."""
    import dmft_lanc_ed_tpu_torch as pt
    cfg = _p13_model()
    h, sec = _sector_h(cfg, np.zeros((2, 2, 2, 2)),
                       pt.unpack_bath(cfg, _p13_bath_a(cfg)),
                       pt.qn(HALF, HALF))
    return dict(e0=host_ground_state(h, sec, " afo2 site A (6,6)")[0],
                dim=sec.dim)


def phase13(oracle):
    """afo2-854k: hm_2b_afo.run_dmft's loop 1, two inequivalent sites on
    the card, gated against host ARPACK of (6,6); then the loop's per-site
    fit again with its files into a temporary directory."""
    import tempfile
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.models import hm_2b_afo
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    cfg = _p13_model()
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 13 must run the default configuration")
    t_all = time.perf_counter()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    res = hm_2b_afo.run_dmft(cfg, device=DEVICE, verbose=False, **P13_DIALS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, steps, seeds, chains = _chain_counts()
    ent = res.history[0]
    table = pt.SectorTable(cfg)
    bath_a = _p13_bath_a(cfg)
    bath_b = pt.break_symmetry_bath(cfg, pt.pack_bath(cfg, pt.init_bath(
        cfg)), cfg.sb_field, sign=-1.0)
    large, des = 0, []
    say(f"phase 13 afo2-854k: hm_2b_afo.run_dmft norb=2 nbath={cfg.nbath}, "
        f"2 sites, 1 loop in {dt:.1f} s ({CARD}); (6,6) dim "
        f"{oracle['dim']}, ARPACK {oracle['e0']:+.12f}")
    for i, site in enumerate(ent["sites"]):
        log66 = [e for q, e, _ in site["diag_log"] if q == pt.qn(HALF, HALF)]
        e66 = float(np.min(log66[0])) if log66 else float("nan")
        des.append(abs(e66 - oracle["e0"]))
        large += sum(1 for q, _, k in site["diag_log"]
                     if k and table.dim(q) > cfg.ed_batch_dim_max)
        say(f"  site {'AB'[i]} on {site['device']}: diag {site['diag']:.2f} "
            f"s, gf {site['gf']:.2f} s, fit {site['fit']:.2f} s; Egs "
            f"{site['egs']:+.12f}, (6,6) lowest {e66:+.12f}, |dE| "
            f"{des[-1]:.3e} (gate 1e-10); dens {site['dens']}, mag "
            f"{ent['mag'][i]}")
    say(f"  launches {counts}, steps {steps}, chain seeds {seeds} over "
        f"{large} band-sparse sectors, chains of each B4 launch {chains}")
    if not (ent["bath"][0].tobytes() == bath_a.tobytes()
            and ent["bath"][1].tobytes() == bath_b.tobytes()):
        raise AssertionError("loop 1 did not start from the staggered seed")
    if not max(des) <= 1e-10:
        raise AssertionError("a site's (6,6) misses the ARPACK energy")
    if any(not s["device"].startswith("cuda") for s in ent["sites"]):
        raise AssertionError("a site was not solved on the card")
    if any(counts.get(k, 0) <= 0 for k in ("tridiag", "cheb", "gf_tridiag")):
        raise AssertionError(f"a chain kernel never launched: {counts}")
    if seeds["missed"] > 0 or seeds["reached"] < large:
        raise AssertionError(f"a large sector missed the chain seed or its "
                             f"eta_target: {seeds}, {large} sectors")
    mag, dens = np.asarray(ent["mag"]), np.asarray(ent["dens"])
    if not np.abs(mag[0] + mag[1]).max() <= 1e-6:
        raise AssertionError(f"mag_A != -mag_B: {mag}")
    if not np.abs(dens - 1.0).max() <= 1e-6:
        raise AssertionError(f"not half filled: {dens}")
    outs = [res.sigma_mats, res.sigma_real, res.g_mats, res.weiss, res.bath]
    if not all(np.all(np.isfinite(x)) for x in outs):
        raise AssertionError("non-finite DMFT output")
    # the loop's per-site fit again, with its files
    bank = pt.LatticeSolver(cfg, 2, hloc=np.zeros((2, 2, 2, 2, 2)),
                            device=DEVICE)
    with tempfile.TemporaryDirectory() as d:
        refit = bank.fit_baths(res.weiss, ent["bath"], outdir=d)
        names = sorted(os.listdir(d))
    per_site = [[n for n in names if n.endswith(f"_ineq{i:04d}.ed")]
                for i in (1, 2)]
    say(f"  files: {len(names)} written, {[len(p) for p in per_site]} with "
        f"_ineq0001 / _ineq0002; the refit equals the loop's bath: "
        f"{refit.tobytes() == res.bath.tobytes()}")
    if not all(per_site):
        raise AssertionError(f"the per-site fit files: {names}")
    say(f"phase 13: {time.perf_counter() - t_all:.1f} s ({CARD})")
    return counts, steps, dt


# phase 14: the stored, direct and Davidson backends at the 854k sector
P14_VECS = 3
# one-rank solves that phase 15 shares: phase 14's (ed_sparse_h=F at (6,6))
# for 15(a), phase 12's f64 batched ones (holstein7) for 15(c)
_ONE_RANK = {}


def _p14_cfg(**kw):
    """A solve of phase 3's model restricted to (6,6), one state."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(norb=1, nbath=NBATH, uloc=(2.0,), beta=100.0,
                       lmats=1024, lreal=64, ed_sectors=True,
                       ed_sectors_shift=0, lanc_nstates_sector=1, **kw)


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase14(cfg, sec, h, op, e0):
    """backends854k: the ELL and direct applies against the f64-exact band
    apply, their f64 Lanczos and the Davidson ground states against host
    ARPACK, then two restricted solves: ed_sparse_h=F (the direct backend)
    and lanc_method="dvdson" in the default configuration."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import (matvec_bs_exact_flat,
                                                        matvec_bs_flat)
    from dmft_lanc_ed_tpu_torch.ops.davidson import (davidson_ground_state,
                                                     op_diag_flat)
    from dmft_lanc_ed_tpu_torch.ops.direct import (build_direct_op,
                                                   matvec_direct_flat)
    from dmft_lanc_ed_tpu_torch.ops.lanczos import lanczos_ground_state
    from dmft_lanc_ed_tpu_torch.ops.matvec import ell_op, matvec_flat
    t_all = time.perf_counter()
    dim = sec.dim
    eop = ell_op(h, DEVICE)
    dop = build_direct_op(cfg, sec, np.zeros((1, 1, 1, 1)),
                          pt.init_bath(cfg), DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    x = torch.randn((P14_VECS, dim), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    y_ref = torch.stack([matvec_bs_exact_flat(op, xi) for xi in x])
    scale = float(y_ref.abs().max())
    rows = []
    for name, o, apply in (("ELL", eop, matvec_flat),
                           ("direct", dop, matvec_direct_flat)):
        rel = float((apply(o, x) - y_ref).abs().max()) / scale
        ms = cuda_ms(lambda: apply(o, x[0]), reps=10)
        rows.append((name, o, apply, rel, ms))
        say(f"phase 14 backends854k {name}: {P14_VECS} vectors, max|d| / "
            f"max|Hv| {rel:.3e} (gate 1e-12); {ms:.3f} ms an apply "
            f"({CARD}); nnz {o.nnz}")
    if not all(r[3] <= 1e-12 for r in rows):
        raise AssertionError("an apply differs from the f64 band apply")
    solves = []
    for name, o, apply, _, _ in rows:
        t0 = time.perf_counter()
        ev, _ = lanczos_ground_state(o, apply, dim, 1, ncv=48, tol=1e-12)
        solves.append((f"Lanczos over {name}", float(ev[0]),
                       time.perf_counter() - t0))
    t0 = time.perf_counter()
    ev, _ = davidson_ground_state(eop, matvec_flat, dim, 1,
                                  op_diag_flat(eop), ncv=48, tol=1e-12)
    solves.append(("Davidson over ELL", float(ev[0]),
                   time.perf_counter() - t0))
    for name, e, dt in solves:
        say(f"  {name}: E0 {e:+.12f}, |dE| vs ARPACK {abs(e - e0):.3e} "
            f"(gate 1e-10), {dt:.2f} s")
    if not all(abs(e - e0) <= 1e-10 for _, e, _ in solves):
        raise AssertionError("a backend's ground state misses ARPACK")
    del eop, dop, x, y_ref
    # the main path: EDSolver.solve with ed_sparse_h=F, then dvdson
    handler = _LogLines()
    logger = logging.getLogger("dmft_lanc_ed_tpu_torch")
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    dav_applies = []
    dav = pdiag.davidson_ground_state

    def counted(op_, apply_, *a, **k):
        dav_applies.append(apply_)
        return dav(op_, apply_, *a, **k)
    pdiag.davidson_ground_state = counted
    bc.reset_launch_counts()
    try:
        r_dir, t_dir = _p7_solve(_p14_cfg(ed_sparse_h=False), DEVICE)
        _ONE_RANK["direct"] = r_dir, t_dir
        r_dav, t_dav = _p7_solve(_p14_cfg(lanc_method="dvdson"), DEVICE)
    finally:
        pdiag.davidson_ground_state = dav
        logger.removeHandler(handler)
        logger.setLevel(level)
    counts, steps, _, chains = _chain_counts()
    took_direct = any("direct (matrix-free) backend" in ln
                      for ln in handler.lines)
    for name, r, dt in (("ed_sparse_h=F", r_dir, t_dir),
                        ("lanc_method=dvdson", r_dav, t_dav)):
        say(f"  EDSolver.solve {name} at (6,6): Egs {r.state_list.emin:+.12f}"
            f", |dE| {abs(r.state_list.emin - e0):.3e} (gate 1e-10), {dt:.2f} "
            f"s (diag {r.timings['diag']:.2f}, gf {r.timings['gf']:.2f}); "
            f"dens {r.observables.dens}")
    say(f"  the direct backend taken: {took_direct}; Davidson over "
        f"{[f.__name__ for f in dav_applies]}; launches {counts}, steps "
        f"{steps}, chains of each B4 launch {chains}")
    if not (abs(r_dir.state_list.emin - e0) <= 1e-10
            and abs(r_dav.state_list.emin - e0) <= 1e-10):
        raise AssertionError("a restricted solve misses the ARPACK energy")
    if not took_direct:
        raise AssertionError("ed_sparse_h=F did not take the direct backend")
    if dav_applies != [matvec_bs_flat]:
        raise AssertionError("dvdson did not run over the band-sparse apply")
    for r in (r_dir, r_dav):
        if not (np.all(np.isfinite(r.g_mats))
                and np.all(np.isfinite(r.sigma_mats))):
            raise AssertionError("non-finite solve output")
    say(f"phase 14: {time.perf_counter() - t_all:.1f} s ({CARD})")
    return counts, steps


# phase 15: sharded direct, Jx/Jp and phonon sectors over two ranks
# jxjp2-854k: phase 12(b)'s couplings at nbath = 5, (6,6) holding 853,776
P15_JXJP = dict(norb=2, nbath=5, uloc=(2.0, 2.0), ust=1.0, jh=0.5, jx=0.5,
                jp=0.5)
P15_VECS = 2              # random vectors of the apply check
P15_REPS = 5              # applies and transposes a timing
P15_SEED = 15
# (b)'s energy gate, one rank and two: the mixed solve's f64 polish runs
# until its residual or its values settle (ops/lanczos.refine_eigenpairs)
P15_JXJP_TOL = 1e-12


def wall_ms(fn, reps):
    """Host milliseconds per fn() over `reps` calls after a warm-up, the
    card synchronized around them (a gloo collective stages through host
    memory, so events would time the host anyway)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _p15_cfg(model, **kw):
    """A solve of `model` restricted to (6,6), one state."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(**model, beta=100.0, lmats=1024, lreal=64,
                       ed_sectors=True, ed_sectors_shift=0,
                       lanc_nstates_sector=1, **kw)


def _p15c_cfg(**kw):
    """holstein7-sharded2: phase 12(a)'s model and grid in f64."""
    import dmft_lanc_ed_tpu_torch as pt
    return pt.EDConfig(**P12_MODELS["holstein7"][0], **P12_GRID,
                       ed_precision="f64", **kw)


def phase15_oracles(holstein):
    """Phase 15's host side, run in phase 1's thread: ARPACK of jxjp2's
    (6,6) at the initial bath with every sector term, and of holstein7's
    (4,4) unless phase 12's oracles hold it."""
    import dmft_lanc_ed_tpu_torch as pt
    cfg = _p15_cfg(P15_JXJP)
    h, sec = _sector_h(cfg, np.zeros((1, 1, 2, 2)), pt.init_bath(cfg),
                       pt.qn(HALF, HALF))
    out = dict(jxjp=host_ground_state(h, sec, " jxjp2 (6,6)")[0],
               dim=sec.dim)
    if holstein:
        out.update(phase12_oracles(("holstein7",)))
    return out


def phase15_ref(op):
    """The one-card f64-exact band apply of P15_VECS random vectors at
    phase 3's sector: 15(a)'s reference, made while `op` lives."""
    import torch
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import matvec_bs_exact_flat
    x = np.random.default_rng(P15_SEED).standard_normal((P15_VECS, op.dim))
    xt = torch.as_tensor(x, device=DEVICE)
    return torch.stack([matvec_bs_exact_flat(op, xi) for xi in xt]
                       ).cpu().numpy()


def _p15_result(res, t, counts, after_diag):
    """What a rank returns of one solve."""
    return dict(t=t, egs=res.state_list.emin, g_mats=res.g_mats,
                sigma_mats=res.sigma_mats, dens=res.observables.dens,
                timings=res.timings, counts=dict(counts),
                diag_counts=dict(after_diag))


def phase15_rank(rank):
    """One of NSHARD ranks sharing the card: (a) the sharded direct apply
    and the restricted solve at phase 3's sector; (b) the
    restricted default solve of jxjp2-854k; (c) holstein7's f64 solve
    over the 9 sectors around (4,4); with the applies' and the
    collectives' ms."""
    import torch
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch import diag as pdiag
    from dmft_lanc_ed_tpu_torch import solver as psolver
    from dmft_lanc_ed_tpu_torch.ops import batched as bt
    from dmft_lanc_ed_tpu_torch.ops.direct import build_direct_op
    from dmft_lanc_ed_tpu_torch.parallel import production as prod
    from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
    from dmft_lanc_ed_tpu_torch.parallel.multihost import rank_device
    from dmft_lanc_ed_tpu_torch.solver import bosonic_grid
    dev = rank_device(DEVICE)
    mesh = make_mesh(NSHARD, dev)
    out = dict(device=str(dev), transport=mesh.transport)
    handler = _LogLines()
    logger = logging.getLogger("dmft_lanc_ed_tpu_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    # the apply counts when the diag ends (the rest are the GF's), and
    # the sharded operators the diag builds
    after_diag, built = {}, []
    diagonalize, shard = psolver.diagonalize_impurity, pdiag.shard_sector_op

    def counted(*a, **k):
        states = diagonalize(*a, **k)
        after_diag.update(prod.apply_counts)
        return states

    def kept(*a, **k):
        built.append(shard(*a, **k))
        return built[-1]
    psolver.diagonalize_impurity = counted
    pdiag.shard_sector_op = kept

    # (a) direct854k-sharded2
    t_a = time.perf_counter()
    cfg = _p14_cfg(ed_sparse_h=False, mesh_shape=(NSHARD,))
    sec = pt.SectorTable(cfg).sector(pt.qn(HALF, HALF))
    sop = prod.shard_direct_op(build_direct_op(
        cfg, sec, np.zeros((1, 1, 1, 1)), pt.init_bath(cfg), "cpu"), mesh,
        cfg)
    x = np.random.default_rng(P15_SEED).standard_normal((P15_VECS, sec.dim))
    xp = sop.pad_flat_batch(x)
    y = sop.exact_nd(sop, xp)
    rows = sop.local_shape[-2]
    pad = torch.arange(rank * rows, (rank + 1) * rows) >= sop.dim_dw
    y_full = sop.unpad_gather(y)
    blk = xp[:1]
    out["a"] = dict(
        y=y_full if rank == 0 else None, payload=sop.op.nbytes,
        dim_dw=sec.dim_dw,
        pad_rows=int(pad.sum()),
        pad_max=float(y[..., pad.to(dev), :].abs().max()) if pad.any()
        else 0.0,
        ms_apply=wall_ms(lambda: sop.exact_nd(sop, xp[0]), P15_REPS),
        ms_coll=wall_ms(lambda: mesh.cols_to_rows(mesh.rows_to_cols(blk),
                                                  blk.shape[-1]),
                        P15_REPS))
    del sop, xp, y
    prod.reset_apply_counts()
    after_diag.clear()
    res, t = _p7_solve(cfg, dev)
    out["a"].update(solve=_p15_result(res, t, prod.apply_counts, after_diag),
                    t_all=time.perf_counter() - t_a)
    # (b) jxjp2-854k-sharded2, the default configuration
    t_b = time.perf_counter()
    cfg = _p15_cfg(P15_JXJP, mesh_shape=(NSHARD,))
    prod.reset_apply_counts()
    after_diag.clear()
    handler.lines.clear()
    res, t = _p7_solve(cfg, dev)
    out["b"] = dict(solve=_p15_result(res, t, prod.apply_counts, after_diag),
                    lines=[ln for ln in handler.lines
                           if "sharded" in ln and "backend" in ln])
    sop = built[-1]                          # the diag's, at (6,6)
    v = sop.pad_flat(np.random.default_rng(P15_SEED).standard_normal(
        sop.dim))
    v32 = v.float()
    out["b"].update(
        apply=sop.apply_nd.__name__,
        ms_apply=wall_ms(lambda: sop.apply_nd(sop, v), P15_REPS),
        ms_coll=wall_ms(lambda: mesh.allgather_rows(v32), P15_REPS),
        t_all=time.perf_counter() - t_b)
    del sop, v, v32
    built.clear()
    # (c) holstein7-sharded2, f64, the 9 sectors around (4,4)
    t_c = time.perf_counter()
    cfg = _p15c_cfg(mesh_shape=(NSHARD,))
    prod.reset_apply_counts()
    after_diag.clear()
    handler.lines.clear()
    bt.reset_bucket_counts()
    res, t = _p7_solve(cfg, dev, P12_MODELS["holstein7"][1])
    out["c"] = dict(solve=_p15_result(res, t, prod.apply_counts, after_diag),
                    buckets=dict(bt.bucket_counts),
                    gs_qn=res.state_list.states[0].qn,
                    gf_phonon=res.gf_phonon.matsubara(cfg.beta,
                                                      bosonic_grid(cfg)),
                    lines=[ln for ln in handler.lines
                           if "sharded" in ln and "backend" in ln],
                    t_all=time.perf_counter() - t_c)
    psolver.diagonalize_impurity = diagonalize
    pdiag.shard_sector_op = shard
    logger.removeHandler(handler)
    return out


def phase15(e0, ref_y, oracles, out):
    """sharded2-a10: the NSHARD ranks' phase15_rank outputs `out` against
    phase 3's ARPACK energy and the one-card band apply (`ref_y`,
    phase15_ref), the host ARPACK oracles and the one-rank solves."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.solver import bosonic_grid
    r0 = out[0]
    say(f"phase 15 sharded2-a10: {ranks_on(out)}, ranks' parts "
        f"{sum(r0[p]['t_all'] for p in 'abc'):.1f} s ({CARD})")

    def same(part):
        return all(o[part]["solve"]["egs"] == r0[part]["solve"]["egs"]
                   and np.array_equal(o[part]["solve"]["g_mats"],
                                      r0[part]["solve"]["g_mats"])
                   for o in out[1:])

    def counts(s, key):
        d = s["diag_counts"].get(key, 0)
        return d, s["counts"][key] - d

    # (a) direct854k-sharded2
    a = r0["a"]
    scale = float(np.abs(ref_y).max())
    rel = float(np.abs(a["y"] - ref_y).max()) / scale
    hdw = a["dim_dw"] ** 2 * 8
    one = _ONE_RANK.get("direct")
    if one is None:
        one = _p7_solve(_p14_cfg(ed_sparse_h=False), DEVICE)
    ref, t_ref = one
    s = a["solve"]
    d_e = abs(s["egs"] - ref.state_list.emin)
    d_g = float(np.abs(s["g_mats"] - ref.g_mats).max())
    d_n = float(np.abs(s["dens"] - ref.observables.dens).max())
    dg_a, gf_a = counts(s, "direct_sharded")
    say(f"  (a) direct854k-sharded2: {P15_VECS} vectors, stitched apply vs "
        f"the one-card f64 band apply max|d| / max|Hv| {rel:.3e} (gate "
        f"1e-12), pad rows {[o['a']['pad_rows'] for o in out]} max|y| "
        f"{max(o['a']['pad_max'] for o in out):.1e} (gate 0); payload a "
        f"rank {[o['a']['payload'] for o in out]} B vs the dense hdw's "
        f"{hdw} B; {a['ms_apply']:.3f} ms an apply, rows_to_cols + "
        f"cols_to_rows {a['ms_coll']:.3f} ms ({CARD})")
    say(f"  (a) restricted solve: the sharded f64 ground state "
        f"{s['egs']:+.12f}, |dE| vs phase 3's ARPACK {abs(s['egs'] - e0):.3e} "
        f"(gate 1e-10); {s['t']:.2f} s (diag {s['timings']['diag']:.2f}, gf "
        f"{s['timings']['gf']:.2f}) vs one rank {t_ref:.2f} s: |dEgs| "
        f"{d_e:.3e} (1e-10), G(iw) {d_g:.3e} (1e-9), dens {d_n:.3e} "
        f"(1e-10); direct_sharded applies diag {dg_a}, gf {gf_a}; part "
        f"{a['t_all']:.1f} s")
    if not (rel <= 1e-12 and all(o["a"]["pad_max"] == 0.0 for o in out)):
        raise AssertionError("the sharded direct apply differs")
    if not all(o["a"]["payload"] < hdw / 2 for o in out):
        raise AssertionError("the sharded direct op outgrew half of hdw")
    if not abs(s["egs"] - e0) <= 1e-10:
        raise AssertionError("the sharded direct ground state misses ARPACK")
    if not (d_e <= 1e-10 and d_g <= 1e-9 and d_n <= 1e-10):
        raise AssertionError("the sharded direct solve differs from one rank")
    if not (dg_a > 0 and gf_a > 0 and same("a")):
        raise AssertionError("(a): no sharded direct applies in the diag or "
                             "GF, or the ranks differ")
    # (b) jxjp2-854k-sharded2
    b = r0["b"]
    s = b["solve"]
    ref, t_ref = _p7_solve(_p15_cfg(P15_JXJP), DEVICE)
    de = abs(s["egs"] - oracles["jxjp"])
    de_one = abs(ref.state_list.emin - oracles["jxjp"])
    d_g = float(np.abs(s["g_mats"] - ref.g_mats).max())
    d_s = float(np.abs(s["sigma_mats"] - ref.sigma_mats).max())
    dg_b, gf_b = counts(s, "dense_sharded")
    refused = [ln for ln in b["lines"] if "band-sparse shard path "
               "unavailable" in ln and ln.endswith("sharded dense backend")]
    say(f"  (b) jxjp2-854k-sharded2 ((6,6) {oracles['dim']} states): Egs "
        f"{s['egs']:+.12f}, host ARPACK {oracles['jxjp']:+.12f}, |dE| "
        f"{de:.3e}, the one-rank solve's {de_one:.3e} (gate "
        f"{P15_JXJP_TOL:g}); {s['t']:.2f} s "
        f"(diag {s['timings']['diag']:.2f}, gf {s['timings']['gf']:.2f}) vs one "
        f"rank {t_ref:.2f} s: G(iw) {d_g:.3e} (2e-5), Sigma(iw) {d_s:.3e} "
        f"(2e-4); dense_sharded applies diag {dg_b}, gf {gf_b}; "
        f"{b['apply']} {b['ms_apply']:.3f} ms an apply, all-gather of the "
        f"f32 rows {b['ms_coll']:.3f} ms ({CARD}); part {b['t_all']:.1f} s")
    say(f"  (b) log: {b['lines'][:1]}")
    if not refused:
        raise AssertionError("(b) did not log the band-sparse shard path "
                             "refused and the sharded dense backend")
    if not (de <= P15_JXJP_TOL and de_one <= P15_JXJP_TOL):
        raise AssertionError("(b) misses the ARPACK energy")
    if not (d_g <= P7_G_TOL and d_s <= P7_SIGMA_TOL):
        raise AssertionError("(b) differs from the one-rank solve")
    if not (dg_b > 0 and gf_b > 0 and same("b")):
        raise AssertionError("(b): no sharded dense applies in the diag or "
                             "GF, or the ranks differ")
    # (c) holstein7-sharded2
    c = r0["c"]
    s = c["solve"]
    name, (model, sqn) = "holstein7", P12_MODELS["holstein7"]
    if c["gs_qn"] == pt.qn(*sqn):
        e_ref = oracles["holstein7"]
    else:
        cfg = _p15c_cfg()
        h, sec = _sector_h(cfg, np.zeros((1, 1, 1, 1)), pt.init_bath(cfg),
                           c["gs_qn"])
        e_ref = host_ground_state(h, sec, f" {name} {c['gs_qn']}")[0]
    cfg = _p15c_cfg()
    ref, t_ref = _ONE_RANK.get(name) or _p7_solve(cfg, DEVICE, sqn)
    de = abs(s["egs"] - e_ref)
    d_g = float(np.abs(s["g_mats"] - ref.g_mats).max())
    d_ph = float(np.abs(c["gf_phonon"] - ref.gf_phonon.matsubara(
        cfg.beta, bosonic_grid(cfg))).max())
    sharded = sorted({ln.split(":")[0] for ln in c["lines"]})
    say(f"  (c) holstein7-sharded2: Egs {s['egs']:+.12f} in {c['gs_qn']}, "
        f"host ARPACK {e_ref:+.12f}, |dE| {de:.3e} (gate 1e-10); "
        f"{s['t']:.2f} s (diag {s['timings']['diag']:.2f}, gf "
        f"{s['timings']['gf']:.2f}) vs one rank {t_ref:.2f} s: G(iw) "
        f"{d_g:.3e} (1e-9), gf_phonon {d_ph:.3e} (1e-9); sharded sectors "
        f"{sharded}, buckets {c['buckets']}, dense_sharded applies "
        f"{s['counts']['dense_sharded']}; part {c['t_all']:.1f} s")
    if not (de <= 1e-10 and d_g <= 1e-9 and d_ph <= 1e-9):
        raise AssertionError("(c) misses ARPACK or the one-rank solve")
    if not (len(sharded) == 3 and c["buckets"]["buckets"] > 0
            and s["counts"]["dense_sharded"] > 0 and same("c")):
        raise AssertionError("(c): not the three dim_dw = 70 sectors "
                             "sharded and the rest batched, or the ranks "
                             "differ")


# phase 16: finite-T Lanczos on the band-sparse route, bethe11-finite-t:
# phase 5's model and configuration at finite T, beta = 100 (the repo's
# inputED.conf), ten states, two a sector, the spin susceptibility, two
# loops, each loop's scan restricted by the sector hint to the 9 sectors
# around (6,6) (627,264 to 853,776 states each)
P16_HINT = ((HALF, HALF),)
P16_KW = dict(ed_finite_temp=True, lanc_nstates_total=10, chispin_flag=True)
P16_K = 2                 # (6,6)'s states in loop 1: lanc_nstates_sector


def post_diag_rule(cfg, state_list, total):
    """ed_post_diag's rule (ED_DIAG.f90:471-605), restated: each sector of
    the list is solved next for one state more than the list holds of it;
    a full list whose Boltzmann tail at its top is above the cutoff grows
    by lanc_nstates_step, and one whose tail is below it, if it holds more
    than two steps, is cut to the states within -ln(cutoff) / beta of the
    ground state. -> (neigen of the list's sectors, lanc_nstates_total)."""
    counts = {}
    for st in state_list.states:
        counts[st.qn] = counts.get(st.qn, 0) + 1
    e0, size = state_list.emin, state_list.size
    tail = np.exp(-cfg.beta * (state_list.emax - e0))
    if tail > cfg.cutoff and size >= total:
        total += cfg.lanc_nstates_step
    elif tail < cfg.cutoff and size > 2 * cfg.lanc_nstates_step:
        keep = sum(st.e <= e0 - np.log(cfg.cutoff) / cfg.beta
                   for st in state_list.states)
        if keep < size:
            total = max(keep, 1)
    return {q: c + 1 for q, c in counts.items()}, total


def phase16(arpack):
    """bethe11-finite-t: run_dmft at finite T in the default configuration,
    two loops over the sectors around (6,6); loop 1's k lowest (6,6)
    energies against host ARPACK (`arpack`, phase 3's oracle at k =
    P16_K), each loop's thermal G, Sigma and chi against the f64 chains
    from the same states and start vectors, the weights, and loop 2's
    control state against ed_post_diag's rule."""
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.models import hm_bethe
    from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
    t_all = time.perf_counter()
    cfg = _dmft_cfg(2, **P16_KW)
    if cfg.ed_backend != "auto" or not cfg.ed_batch_sectors:
        raise AssertionError("phase 16 must run the default configuration")
    e0, _, e_k = arpack
    hints = [pt.qn(*q) for q in P16_HINT]
    scan = (f"each loop's scan restricted to the 9 sectors around "
            f"{P16_HINT[0]}" if hints else "the full scan in both loops")
    with sector_hint(hm_bethe, hints) as solves:
        res, counts, dt = _run_loop(
            f"phase 16 bethe11-finite-t (beta {cfg.beta:g}, "
            f"{cfg.lanc_nstates_total} states, {scan})", cfg, e0)
    chains = list(bc.chains_per_launch["gf_tridiag"])
    if len(solves) != 2:
        raise AssertionError(f"{len(solves)} solves, not two loops")
    for ent, (_, r, _, _) in zip(res.history, solves):
        sl = r.state_list
        say(f"  loop {ent['iloop']}: chi {ent['timings']['chi']:.2f} s "
            f"({CARD}); {sl.size} states in "
            f"{len(sl.sectors_contributing())} sectors, "
            f"{len(ent['diag_log'])} sectors scanned, E - E0 "
            f"{[round(x.e - sl.emin, 6) for x in sl.states]}, clean cut "
            f"{sl.clean_cut}")
    # loop 1's k lowest (6,6) energies against host ARPACK at the same k
    r1 = solves[0][1]
    e66 = next(np.asarray(e) for q, e, _ in r1.state_list.diag_log
               if q == pt.qn(HALF, HALF))
    d_k = np.abs(e66 - e_k[:len(e66)])
    say(f"  loop 1's {len(e66)} lowest (6,6) energies "
        f"{[f'{x:+.12f}' for x in e66]}, |dE| vs host ARPACK "
        f"{[f'{x:.2e}' for x in d_k]} (gate 1e-10)")
    if not (len(e66) == P16_K and np.all(d_k <= 1e-10)):
        raise AssertionError("the (6,6) energies miss host ARPACK")
    # each loop: weights, and G, Sigma, chi against the f64 chains
    for i, (_, r, packed, solver) in enumerate(solves):
        w, zeta = r.state_list.boltzmann_weights(cfg.beta, True)
        d_z = abs(float(w.sum()) / zeta - 1.0)
        say(f"  loop {i + 1}: |sum w / Z - 1| {d_z:.2e} (gate 1e-12), Z "
            f"{zeta:.12f}, gf routing {r.gf.routing}")
        if not d_z <= 1e-12:
            raise AssertionError("the Boltzmann weights do not sum to Z")
        real_axis_gates(f"loop {i + 1}", solver, packed, r, ("spin",))
    # loop 2 started from ed_post_diag's rule applied to loop 1's list
    want_n, want_t = post_diag_rule(cfg, r1.state_list,
                                    cfg.lanc_nstates_total)
    (n2, t2), r2 = solves[1][0], solves[1][1]
    used = {q: len(e) for q, e, _ in r2.state_list.diag_log}
    table = solves[1][3].table
    want_used = {q: min(table.dim(q), want_n.get(q, cfg.lanc_nstates_sector))
                 for q in used}
    say(f"  loop 2 started from neigen_sector {sorted(n2.items())}, "
        f"lanc_nstates_total {t2}; the rule from loop 1's list: "
        f"{sorted(want_n.items())}, {want_t}")
    if not (n2 == want_n and t2 == want_t and used == want_used
            and r2.state_list.max_size == want_t):
        raise AssertionError("loop 2's neigen_sector or lanc_nstates_total "
                             "do not follow ed_post_diag's rule")
    say(f"  B4: {len(chains)} launches, at most {max(chains)} chains a "
        f"launch (phase 2s times two at {(HALF + 1, HALF)})")
    say(f"phase 16: {time.perf_counter() - t_all:.1f} s ({CARD})")
    return counts[0], counts[1], dt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,2s,3,3b,4,5,6,7,8,9,10,11,12,13,14,15,"
                            "16")
    ap.add_argument("--ghost-tol", type=float, default=None)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dmft_lanc_ed_tpu_torch")):
        print("chip_smoke: the dmft_lanc_ed_tpu_torch package is not next "
              "to this script", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    oracle = waiter = None
    go = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "go")
    try:
        with timed("0"):
            phase0()
        if args.ghost_tol is not None:
            from dmft_lanc_ed_tpu_torch.ops import bs_chain
            say(f"_GHOST_TOL {bs_chain._GHOST_TOL} -> {args.ghost_tol}")
            bs_chain._GHOST_TOL = args.ghost_tol
        rows, counts, steps = [], {}, {}
        e_gs = serial = None
        e0 = arpack = p9_oracle = p10_oracle = p12_oracle = None
        p13_oracle = p15_oracle = p15_ref = None
        # the host oracles run in their own processes while nvcc builds
        # and the first phases run
        oracle = oracle_pool()
        if phases & {"7", "15"}:
            waiter, pending = spawn_ranks(go)

        def result(pending):
            with timed("oracle wait"):
                return pending.get()
        on_854k = phases & {"2", "2s", "3", "3b", "6", "7", "8", "14", "15"}
        if on_854k or "16" in phases:
            with timed("854k build"):
                cfg, sec, h, op = sector_854k()
            if phases & {"2", "3", "3b", "7", "14", "15", "16"}:
                # phase 16 gates (6,6)'s P16_K lowest energies
                arpack = oracle.apply_async(
                    host_ground_state,
                    (h, sec, "", P16_K if "16" in phases else 1))
        if "9" in phases:
            p9_oracle = oracle.apply_async(phase9_oracles)
        if phases & {"10", "11"}:
            # phase 11 solves phase 10's model at the same bath and sector
            p10_oracle = oracle.apply_async(phase10_oracle)
        if "12" in phases:
            p12_oracle = oracle.apply_async(phase12_oracles)
        if "13" in phases:
            p13_oracle = oracle.apply_async(phase13_oracle)
        if "15" in phases:
            p15_oracle = oracle.apply_async(phase15_oracles,
                                            ("12" not in phases,))
        oracle.close()            # the workers exit once the oracles are in
        if "1" in phases:
            with timed("1"):
                phase1()
        if on_854k:
            # 2s, 6, 3's solve, 4 and 5 need no oracle: they run while the
            # first ARPACK does
            b2_steps, rows6 = {}, []
            if "2s" in phases:
                with timed("2s"):
                    b2_steps = phase2s()
            if "6" in phases:
                with timed("6"):
                    rows6 = phase6(op)
            if "3" in phases:
                with timed("3"):
                    e_gs, t3 = phase3(cfg, sec, op)
        if "4" in phases:
            with timed("4"):
                serial, (c4, s4), _ = phase4(e_gs)
            counts.update(c4)
            steps.update(s4)
        if "5" in phases:
            # the chain kernels' launches are those of phases 4 and 5
            with timed("5"):
                c5, s5 = phase5(e_gs, serial)[0]
            for tot, add in ((counts, c5), (steps, s5)):
                for k, n in add.items():
                    tot[k] = tot.get(k, 0) + n
        if on_854k:
            if arpack is not None:
                e0, v_gs, _ = result(arpack)
            if "3" in phases:
                phase3_gate(e_gs, t3, e0)
            if "2" in phases:
                with timed("2"):
                    rows = phase2(op, e0, v_gs)
            rows += rows6
            if "3b" in phases:
                with timed("3b"):
                    counts.update(phase3b(cfg, sec, op, e0)[0])
            if "8" in phases:
                with timed("8"):
                    r8, c8, s8 = phase8(op, rows, b2_steps)
                rows += r8
                counts.update(c8)
                steps.update(s8)
            if "14" in phases:
                with timed("14"):
                    p14 = phase14(cfg, sec, h, op, e0)
            if "15" in phases:
                with timed("15"):
                    p15_ref = phase15_ref(op)
            del op
            _SECTORS.clear()
        # the ranks of phases 7 and 15 run their work beside phases 9-13
        # and 16 (the kernels' timings of phases 2, 2s, 6, 8 and 14 are
        # taken before)
        parts = phases & {"7", "15"}
        if parts:
            t_ranks = time.perf_counter()
            release_ranks(go, parts)
        if "9" in phases:
            p9 = result(p9_oracle)
            with timed("9"):
                for c9, s9, _ in (phase9a(p9["hybrid"]), phase9b(p9)):
                    for tot, add in ((counts, c9), (steps, s9)):
                        for k, n in add.items():
                            tot[k] = tot.get(k, 0) + n
        later = []
        if "10" in phases:
            p10 = result(p10_oracle)
            with timed("10"):
                later.append(phase10(p10))
        if "11" in phases:
            p10 = result(p10_oracle)
            with timed("11"):
                later.append(phase11(p10))
        if "12" in phases:
            p12 = result(p12_oracle)
            with timed("12"):
                phase12(p12)
        if "13" in phases:
            p13 = result(p13_oracle)
            with timed("13"):
                later.append(phase13(p13))
        if "14" in phases:
            later.append(p14 + (None,))
        for c_n, s_n, _ in later:
            for tot, add in ((counts, c_n), (steps, s_n)):
                for k, n in add.items():
                    tot[k] = tot.get(k, 0) + n
        if "15" in phases:
            p15 = result(p15_oracle)
            if "holstein7" not in p15:
                p15["holstein7"] = result(p12_oracle)["holstein7"]
        if "16" in phases:
            with timed("16"):
                c16, s16, _ = phase16(result(arpack))
            for tot, add in ((counts, c16), (steps, s16)):
                for k, n in add.items():
                    tot[k] = tot.get(k, 0) + n
        ranks = {}
        if parts:
            with timed("7, 15: ranks"):
                ranks = sharded_ranks(pending, parts, t_ranks)
        if "7" in phases:
            with timed("7"):
                counts.update(phase7(e0, e_gs, ranks["7"]))
        if "15" in phases:
            with timed("15"):
                phase15(e0, p15_ref, p15, ranks["15"])
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if oracle is not None:
            oracle.terminate()
            oracle.join()
        if waiter is not None:
            if not os.path.exists(go):
                release_ranks(go, ())
            waiter.shutdown()
        shutil.rmtree(os.path.dirname(go))
    if "jax" in sys.modules or "dmft_lanc_ed_tpu" in sys.modules:
        print("chip_smoke: the JAX package was imported", file=sys.stderr)
        return 1
    for name, sec_n in PHASE_S.items():
        pol_s, pol_n = PHASE_POLISH.get(name, (0.0, 0))
        say(f"seconds, phase {name}: {sec_n:.1f} ({CARD})"
            + (f"; f64 polish {pol_s:.1f} s in {pol_n} calls" if pol_n
               else ""))
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": counts.get(name, 0),
         # a per-call kernel runs one step a launch
         "steps": steps.get(name, counts.get(name, 0)),
         "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        for name, err, ms_k, ms_p, b_ms, b_by in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
