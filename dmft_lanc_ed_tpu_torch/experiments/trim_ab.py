"""E2, the zero-tile trim probe (port of ``experiments/trim_ab.py``).

The JAX probe A/Bs the zero-tile trim structures of the per-call matvec B1
on the TPU: per-tile lists walked dynamically on one side, both or none
(E2a, :func:`make_variant`, modes ``untrimmed`` / ``dwtrim`` / ``uptrim``
/ ``both``), and per-panel static runs (E2b, :func:`make_static_runs`).
Each form computes B1's function with split-bf16 three-pass products:
``call(v32p, scale)`` -> (y = scale * H_p v32p [ddp, dup] f32, per-panel
sums of squares [ntd, 1] f32).

Both become one CUDA kernel on the tensor cores, ``csrc/trim_ab.cu``
(``trim_matvec``: a split launch, then the three-pass product of
``csrc/bs_panel_tc.cuh`` on ``wgmma`` with the epilogue and the panel sums
in one launch), fed the tile lists per side (E2a: the trimmed lists of
:func:`tables_from_runs` or the whole window, as the mode selects) or the
op's trim runs (E2b: the tables B1a reads). Every form walks the same
nonzero tiles in ascending order, so all five give the same bits on the
card, at every tile width. For a CPU tensor every form runs the plain
version :func:`matvec_plain`; for a CUDA tensor it launches the kernel or
raises, and counts the call in :data:`launch_counts` (``trim_tiles`` for
E2a, ``trim_static_runs`` for E2b) and the kernels it launched (two) in
:data:`kernel_launches`.

    python -m dmft_lanc_ed_tpu_torch.experiments.trim_ab [cuda]

times ``untrimmed`` and ``static_runs`` at the 854k-state (6,6) sector of
nbath = 11 in microseconds per matvec, as the slope over 200, 700 and
1200 chained calls.
"""
from __future__ import annotations

import sys
import ctypes
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.bf16x3 import _cached, hv_plain, split_bf16, split_op
from ..ops.blocksparse import (_check_cuda_inputs, _geometry, _panel_ss,
                               _pop, build_blocksparse_op, ticket, to_padded)
from ..ops.factory import resolve_device

MODES = ("untrimmed", "dwtrim", "uptrim", "both")

# kernel launches per form since the last reset (one per matvec call)
launch_counts = {"trim_tiles": 0, "trim_static_runs": 0}
# the CUDA kernels those calls launched (the split and the product: two a
# call), as the launcher counts them
kernel_launches = {"trim_tiles": 0, "trim_static_runs": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, kernel_launches):
        for k in counts:
            counts[k] = 0


def _expand(runs_tup, ntw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-panel runs -> (cnt [nt, 1], lst [nt, ntw]) int32 tile lists."""
    nt = len(runs_tup)
    cnt = np.zeros((nt, 1), np.int32)
    lst = np.zeros((nt, ntw), np.int32)
    for i, runs in enumerate(runs_tup):
        k = 0
        for (r0, r1) in runs:
            for wt in range(r0, r1):
                lst[i, k] = wt
                k += 1
        cnt[i, 0] = k
    return cnt, lst


def tables_from_runs(op) -> Tuple[torch.Tensor, ...]:
    """(dwc [ntd, 1], dwl [ntd, W_dw/128], upc [ntu, 1], upl [ntu,
    W_up/128]) int32 on the op's device: the per-tile lists of the windows'
    nonzero tiles, expanded from the op's trim runs (``trim_ab.py:42``)."""
    def make(pop):
        dw_runs, up_runs = pop.trim_runs
        out = (*_expand(dw_runs, pop.w_dw // 128),
               *_expand(up_runs, pop.w_up // 128))
        return tuple(torch.as_tensor(t, device=pop.device) for t in out)
    return _cached("trim_lists", _pop(op), make)


def _full_tables(op) -> Tuple[torch.Tensor, ...]:
    """The whole windows as tile lists, in tables_from_runs' layout."""
    def make(pop):
        ddp, dup = pop.padded_shape
        out = []
        for nt, ntw in ((ddp // 128, pop.w_dw // 128),
                        (dup // 128, pop.w_up // 128)):
            out += [np.full((nt, 1), ntw, np.int32),
                    np.tile(np.arange(ntw, dtype=np.int32), (nt, 1))]
        return tuple(torch.as_tensor(t, device=pop.device) for t in out)
    return _cached("full_lists", _pop(op), make)


def matvec_plain(op, v32p: torch.Tensor, scale
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of every form: (scale * H_p v with split-bf16 three-
    pass hop products, per-panel sums of squares [ntd, 1] f32), through
    the dense padded factors' split (bf16x3.hv_plain)."""
    v = v32p.float()
    y = scale * hv_plain(op, *split_bf16(v), v, passes=3)
    return y, _panel_ss(y).reshape(-1, 1)


def _launch(op, v32p: torch.Tensor, scale, kind: int,
            tables: Tuple[torch.Tensor, ...], tile: int
            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], int]:
    """trim_matvec over tile lists (kind 0) or runs (kind 1) -> ((y, ss),
    the kernels it launched)."""
    from .. import _kernels
    pop = _pop(op)
    lib = _kernels.lib()
    v = v32p.contiguous()
    _check_cuda_inputs(pop, v)
    if v.dim() != 2:
        raise ValueError(f"trim_ab: one vector [ddp, dup], got "
                         f"{tuple(v.shape)}")
    sp = split_op(pop)
    dev = v.device
    ddp, dup = pop.padded_shape
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    else:
        s = torch.full((1,), float(scale), dtype=torch.float32, device=dev)
    parts = torch.empty((2, ddp, dup), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(v)
    ss = torch.empty((ddp // 128, 1), dtype=torch.float32, device=dev)
    partials = torch.empty(lib.trim_matvec_nblk(ddp, dup),
                           dtype=torch.float64, device=dev)
    launches = ctypes.c_int(0)
    err = lib.trim_matvec(
        sp.dw_hi.data_ptr(), sp.dw_lo.data_ptr(), sp.up_hi.data_ptr(),
        sp.up_lo.data_ptr(), pop.diag_a.data_ptr(), pop.diag_b.data_ptr(),
        v.data_ptr(), parts.data_ptr(), y.data_ptr(), s.data_ptr(),
        partials.data_ptr(), ticket(dev, "trim_matvec").data_ptr(),
        ss.data_ptr(), kind, *(t.data_ptr() for t in tables),
        *_geometry(pop), tile, ctypes.byref(launches),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "trim_matvec")
    return (y, ss), launches.value


def _dispatch(op, v32p, scale, name: str, kind: int, tables, tile: int):
    if v32p.device.type == "cpu":
        return matvec_plain(op, v32p, scale)
    if not v32p.is_cuda:
        raise ValueError(f"trim_ab: unsupported device {v32p.device}")
    out, n = _launch(op, v32p, scale, kind, tables, tile)
    launch_counts[name] += 1
    kernel_launches[name] += n
    return out


def make_variant(op, mode: str) -> Callable:
    """E2a: ``call(v32p, scale, tile=0)`` -> (y [ddp, dup], ss [ntd, 1])
    f32, the dw and up windows walked as per-tile lists, trimmed on the
    sides the mode names (``dwtrim``: dw, ``uptrim``: up, ``both``), else
    whole. `tile`: the output tile's width on the card (32, 64 or 128; 0
    for the launcher's choice); every width gives the same bits."""
    if mode not in MODES:
        raise ValueError(f"trim_ab: mode {mode!r} not in {MODES}")
    trim = tables_from_runs(op)
    full = _full_tables(op)
    dw = trim[:2] if mode in ("dwtrim", "both") else full[:2]
    up = trim[2:] if mode in ("uptrim", "both") else full[2:]

    def call(v32p: torch.Tensor, scale, tile: int = 0):
        return _dispatch(op, v32p, scale, "trim_tiles", 0, dw + up, tile)
    return call


def make_static_runs(op) -> Callable:
    """E2b: ``call(v32p, scale, tile=0)`` -> (y, ss) as
    :func:`make_variant`'s, walking the op's per-panel runs of nonzero
    tiles (the TPU kernel's static runs; here the int32 run tables of
    B1a)."""
    runs = _pop(op).runs_trim

    def call(v32p: torch.Tensor, scale, tile: int = 0):
        return _dispatch(op, v32p, scale, "trim_static_runs", 1, runs, tile)
    return call


def sector_854k(device):
    """The probes' sector: nbath = 11, (6,6), 853,776 states, 1024^2
    padded, on `device`."""
    from .. import (EDConfig, SectorTable, build_sector_hamiltonian,
                    init_bath, qn)
    cfg = EDConfig(norb=1, nbath=11, uloc=(2.0,))
    sec = SectorTable(cfg).sector(qn(6, 6))
    h = build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                 init_bath(cfg))
    return build_blocksparse_op(h, device)


def random_start(op, seed: int = 0) -> torch.Tensor:
    """A normalized random vector of the sector, numpy default_rng(seed),
    permuted and padded (f32) on the op's device."""
    v = np.random.default_rng(seed).standard_normal((op.dim_dw, op.dim_up))
    return to_padded(op, v / np.linalg.norm(v))


def main(device="cuda", op=None) -> dict:
    """Time ``untrimmed`` and ``static_runs`` (the card by default; raises
    without one): microseconds per matvec as the slope over 200, 700 and
    1200 chained calls, each feeding rsqrt(sum ss) forward as the next
    scale. On the CPU each form runs once (no time). `op`: the sector's
    op (default: built here)."""
    dev = resolve_device(device)
    op = sector_854k(dev) if op is None else op
    vp = random_start(op)
    ns = (200, 700, 1200)
    out = {}
    for mode in ("untrimmed", "static_runs"):
        call = (make_static_runs(op) if mode == "static_runs"
                else make_variant(op, mode))
        if dev.type != "cuda":
            _, ss = call(vp, 1.0)
            print(f"{mode:11s}: sum ss {float(ss.double().sum())!r} (time "
                  "not measured on the CPU)")
            out[mode] = None
            continue
        from .timing import device_ms

        def run(n):
            w, r = vp, torch.ones((), device=dev)
            for _ in range(n):
                w, ss = call(w, r)
                r = torch.rsqrt(ss.double().sum() + 1e-30).float()
            return w
        ts = np.array([device_ms(lambda: run(n), 1, 3) for n in ns])
        slope = np.linalg.lstsq(np.vstack([np.array(ns, float),
                                           np.ones(3)]).T, ts,
                                rcond=None)[0][0]
        out[mode] = 1e3 * slope
        print(f"{mode:11s}: {out[mode]:8.2f} us/mv -> "
              f"{op.nnz / (1e-3 * slope) / 1e9:6.1f} Gnnz/s  "
              f"(t={['%.4f' % (t * 1e-3) for t in ts]} s)")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
