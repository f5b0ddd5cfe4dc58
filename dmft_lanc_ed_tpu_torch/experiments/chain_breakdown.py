"""E3, the chain-breakdown probe (port of
``experiments/chain_breakdown.py``).

The JAX probe times where the fused Lanczos chain's step (B2) spends its
time on the TPU, through product forms of the same step:

- ``3pass``: B2's split-bf16 three-pass products (the reference point);
- ``1pass``: one bf16 product of the hi parts (the matrix unit's share);
- ``bf16pair``: the vector planes stored as bf16 hi/lo pairs, so window
  reads feed the product without a split and every write splits;
- ``nop1``: pass 1's write-back skipped (its dot kept);
- ``tileskip``: the windows' zero tiles skipped by per-tile masks
  (:func:`tile_masks`).

``make_variant(op, mode)`` returns ``call(v32p, kk)`` -> (alphas [kk, 1],
betas [kk, 1]) f32, kk steps from the normalized padded start v32p. On the
card one CUDA chain serves every form, ``csrc/chain_breakdown.cu``
(``bd_chain``): B2's step on the pipelined three-pass product of
``csrc/bs_panel_tc.cuh`` (``wgmma``), two launches a step; ``1pass``
issues hi.hi alone over the same staged parts, ``bf16pair`` keeps no f32
planes, ``nop1`` writes plane prv's parts in pass 0, ``tileskip`` walks
the runs of :func:`skip_runs`. A call counts one in :data:`launch_counts`,
its steps in :data:`step_counts` and the kernels it launched in
:data:`kernel_launches`. For a CPU tensor each form runs its plain version
:func:`chain_plain`.

``bf16pair`` deviates from the JAX probe on purpose. The JAX kernel seeds
its planes from v0 only in the other modes (``chain_breakdown.py:96-99``),
so its ``bf16pair`` reads unseeded planes and its result is undefined (the
probe calls it timing-only; NaN in interpret mode on the CPU). The port
seeds plane 0 with the split of v0, so its result is defined: the 3pass
chain with every vector rounded to its hi + lo pair (~2^-17 relative).

    python -m dmft_lanc_ed_tpu_torch.experiments.chain_breakdown [cuda]

times ``3pass`` and ``tileskip`` at the 854k-state (6,6) sector of
nbath = 11, in microseconds per step: (t256 - t64) / 192 / M over M = 8
chained calls of 64 and of 256 steps.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Callable, Tuple

import torch

from ..ops.bf16x3 import _cached, hv_plain, split_bf16, split_op
from ..ops.blocksparse import _geometry, _mask_runs, _pop, _runs_table
from ..ops.factory import resolve_device
from .trim_ab import random_start, sector_854k

MODES = ("3pass", "1pass", "bf16pair", "nop1", "tileskip")

# kernel launches since the last reset (one per chain call)
launch_counts = {"chain_breakdown": 0}
# the chain steps those launches ran (a kernel's time is quoted per step)
step_counts = {"chain_breakdown": 0}
# the CUDA kernels those calls launched (two a step), as the launcher
# counts them
kernel_launches = {"chain_breakdown": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, step_counts, kernel_launches):
        for k in counts:
            counts[k] = 0


def tile_masks(op) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dwm [ntd, W_dw/128], upm [ntu, W_up/128]) int32 on the op's device:
    1 where the 128 x 128 window tile of the split slabs is nonzero
    (``chain_breakdown.py:47``)."""
    def make(pop):
        sp = split_op(pop)
        ddp, dup = pop.padded_shape
        ntd, ntu = ddp // 128, dup // 128
        dw = (sp.dw_hi.float().abs() + sp.dw_lo.float().abs()).reshape(
            ntd, 128, pop.w_dw // 128, 128)
        up = (sp.up_hi.float().abs() + sp.up_lo.float().abs()).reshape(
            ntu, pop.w_up // 128, 128, 128)
        return ((dw.amax((1, 3)) > 0).to(torch.int32),
                (up.amax((2, 3)) > 0).to(torch.int32))
    return _cached("tile_masks", _pop(op), make)


def skip_runs(op) -> Tuple[torch.Tensor, ...]:
    """tileskip's stage stream: (dw offsets [ntd + 1], dw pairs, up offsets
    [ntu + 1], up pairs) int32 on the op's device, the runs of the tiles
    :func:`tile_masks` sets, in the layout of the op's run tables
    (``ops/blocksparse._runs_table``); cached per op."""
    def make(pop):
        dwm, upm = (m.cpu().numpy() for m in tile_masks(pop))
        return (*_runs_table(_mask_runs(dwm), pop.device),
                *_runs_table(_mask_runs(upm), pop.device))
    return _cached("skip_runs", _pop(op), make)


def chain_plain(op, v32p: torch.Tensor, kk: int, mode: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of a form: kk steps of the kernel's recurrence in
    PyTorch (f32 vectors, f64 scalars and sums), the hop products split
    as bf16x3.hv_plain, the planes as f32 or (bf16pair) as hi/lo pairs.
    Returns (alphas [kk, 1], betas [kk, 1]) f32."""
    if mode not in MODES:
        raise ValueError(f"chain_breakdown: mode {mode!r} not in {MODES}")
    pair = mode == "bf16pair"
    passes = 1 if mode == "1pass" else 3

    def store(w):
        return split_bf16(w) if pair else w

    def read(p):
        return p[0].float() + p[1].float() if pair else p
    v0 = v32p.float()
    planes = [store(v0), store(torch.zeros_like(v0))]
    f64 = dict(dtype=torch.float64, device=v0.device)
    s_cur = torch.ones((), **f64)
    coup = torch.zeros((), **f64)
    alphas, betas = [], []
    for k in range(kk):
        cur, prv = planes[k % 2], planes[1 - k % 2]
        u = read(cur)
        u_hi, u_lo = cur if pair else split_bf16(cur)
        y = s_cur.float() * hv_plain(op, u_hi, u_lo, u, passes)
        alpha = s_cur * (u.double() * y.double()).sum()
        prv = store(y if k == 0 else y - coup.float() * read(prv))
        w = read(prv) - (alpha * s_cur).float() * u
        beta = torch.sqrt((w.double() ** 2).sum())
        planes[1 - k % 2] = prv if mode == "nop1" else store(w)
        coup = beta * s_cur
        s_cur = torch.where(beta > 1e-30, 1.0 / beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta)
    return (torch.stack(alphas).float().reshape(kk, 1),
            torch.stack(betas).float().reshape(kk, 1))


def _launch(op, v32p: torch.Tensor, kk: int, mode: str
            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], int]:
    """bd_chain in form `mode` -> ((alphas, betas), the kernels it
    launched). The buffers are B2's (``ops/bs_chain._chain_buffers``):
    plane 0 the start and its split parts, state {1, 0, 0, 0}; bf16pair
    passes no f32 plane."""
    from .. import _kernels
    from ..ops.bs_chain import _chain_buffers, _split2_ptrs
    pop = _pop(op)
    v = v32p.contiguous()
    if v.dim() != 2:
        raise ValueError(f"chain_breakdown: one vector [ddp, dup], got "
                         f"{tuple(v.shape)}")
    lib, planes, parts, state, partials, counter = _chain_buffers(
        pop, v[None], kk, 2)
    dev = v.device
    runs = skip_runs(pop) if mode == "tileskip" else (None,) * 4
    alphas = torch.empty(kk, dtype=torch.float64, device=dev)
    betas = torch.empty(kk, dtype=torch.float64, device=dev)
    launches = ctypes.c_int(0)
    err = lib.bd_chain(
        *_split2_ptrs(pop),
        None if mode == "bf16pair" else planes.data_ptr(), parts.data_ptr(),
        *(None if t is None else t.data_ptr() for t in runs),
        state.data_ptr(), partials.data_ptr(), counter.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), MODES.index(mode),
        *_geometry(pop), kk, ctypes.byref(launches),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bd_chain")
    return ((alphas.float().reshape(kk, 1), betas.float().reshape(kk, 1)),
            launches.value)


def make_variant(op, mode: str) -> Callable:
    """E3: ``call(v32p, kk)`` -> (alphas [kk, 1], betas [kk, 1]) f32, kk
    Lanczos steps of the chain in product form `mode` (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"chain_breakdown: mode {mode!r} not in {MODES}")

    def call(v32p: torch.Tensor, kk: int):
        if v32p.device.type == "cpu":
            return chain_plain(op, v32p, kk, mode)
        if not v32p.is_cuda:
            raise ValueError(f"chain_breakdown: unsupported device "
                             f"{v32p.device}")
        out, n = _launch(op, v32p, kk, mode)
        launch_counts["chain_breakdown"] += 1
        step_counts["chain_breakdown"] += kk
        kernel_launches["chain_breakdown"] += n
        return out
    return call


def main(device="cuda", op=None) -> dict:
    """Time ``3pass`` and ``tileskip`` (the card by default; raises without
    one) in microseconds per step, (t256 - t64) / 192 / M over M = 8
    chained calls, each the least of 4. On the CPU each form runs one
    8-step chain (no time). `op`: the sector's op (default: built here)."""
    dev = resolve_device(device)
    op = sector_854k(dev) if op is None else op
    vp = random_start(op)
    m = 8
    out = {}
    for mode in ("3pass", "tileskip"):
        call = make_variant(op, mode)
        if dev.type != "cuda":
            al, be = call(vp, 8)
            print(f"{mode:8s}: alpha[:3] {al[:3, 0].tolist()} (time not "
                  "measured on the CPU)")
            out[mode] = None
            continue
        from .timing import device_ms

        def run(kk):
            vv = vp
            for _ in range(m):
                al, _ = call(vv, kk)
                vv = vp * (1.0 + 1e-30 * al[0, 0])
            return al
        ts = {kk: device_ms(lambda: run(kk), 1, 4) for kk in (64, 256)}
        out[mode] = 1e3 * (ts[256] - ts[64]) / (256 - 64) / m
        print(f"{mode:8s}: {out[mode]:8.2f} us/step (t64={ts[64]:.1f} ms, "
              f"t256={ts[256]:.1f} ms)")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
