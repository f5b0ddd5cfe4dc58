"""The least time a band-sparse chain launch could take on one H100:
the frozen yardstick of the kernel rooflines.

A launch runs ``kk`` steps of ``nb`` chains over one sector operator
padded to ``ddp x dup``, whose hop factors are stored as 128 x 128 tiles.
Its bound is the largest of

- the tensor-core operations of one f32 product a step and a chain over
  the operator's nonzero tiles, counted once whatever number of split
  passes an implementation runs, over the card's dense bf16 peak (the
  highest rate of any input precision that could carry an f32 product);
- the elementwise FP32 operations of the diagonal and the recurrence
  over the FP32 peak;
- the bytes of the launch, each input read once (the f32 tiles, the
  diagonal factors, the start vectors) and each output written once,
  over the memory rate.

Counted from the operator's shape alone, this reads the same for any
kernel that computes the same chain.
"""
from __future__ import annotations

from typing import Sequence, Tuple

PEAK_TC = 989e12          # FLOP/s, H100 SXM, dense bf16 tensor cores
PEAK_FP32 = 67e12         # FLOP/s, H100 SXM, outside the tensor cores
PEAK_BYTES = 3.35e12      # bytes/s, H100 SXM HBM3
TILE = 128

# elementwise FP32 operations an element and a step, besides the diagonal
RECURRENCE_OPS = {"lanczos": 12, "chebyshev": 8}


def kept_tiles(trim_runs: Tuple[Sequence, Sequence]) -> Tuple[int, int]:
    """(dw, up) nonzero 128 x 128 tiles of the hop factors, from the
    operator's per-panel runs [(t0, t1), ...] of nonzero tiles."""
    dw_runs, up_runs = trim_runs
    return tuple(sum(t1 - t0 for runs in rr for t0, t1 in runs)
                 for rr in (dw_runs, up_runs))


def hop_flops(padded_shape: Tuple[int, int], dw_tiles: int,
              up_tiles: int) -> int:
    """Operations of one H_hop u over the padded grid: each nonzero dw
    tile meets every column of u, each up tile every row."""
    ddp, dup = padded_shape
    return 2 * TILE * TILE * (dup * dw_tiles + ddp * up_tiles)


def launch_seconds(padded_shape: Tuple[int, int], rank: int,
                   tiles: Tuple[int, int], kk: int, nb: int,
                   kind: str) -> Tuple[float, str]:
    """(least seconds, "tensor" / "fp32" / "bytes") of one launch of kk
    steps of nb chains; kind "lanczos" (B2, B4: alphas and betas out) or
    "chebyshev" (B3: the last vector and its norm out)."""
    ddp, dup = padded_shape
    grid = ddp * dup
    t_tc = kk * nb * hop_flops(padded_shape, *tiles) / PEAK_TC
    t_fp = kk * nb * (2 * rank + RECURRENCE_OPS[kind]) * grid / PEAK_FP32
    nbytes = (4 * TILE * TILE * sum(tiles) + 4 * rank * (ddp + dup)
              + 4 * nb * grid)
    nbytes += 16 * nb * kk if kind == "lanczos" else 4 * grid + 8
    t_by = nbytes / PEAK_BYTES
    best = max((t_tc, "tensor"), (t_fp, "fp32"), (t_by, "bytes"))
    return best
