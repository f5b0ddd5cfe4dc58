"""The split-bf16 products of the kernels B1-B5 and of the experiment
probes E2/E3: the per-op split of the slabs, and the plain counterparts of
``csrc/bs_panel_tc.cuh``.

The JAX package reaches f32 accuracy on the TPU's matrix unit with products
of bf16 parts. B2/B3 take the three-pass product
(``ops/blocksparse.py:_dot3``): x = x_hi + x_lo with x_hi = bf16(x) and
x_lo = bf16(x - x_hi), and x a ~ x_hi a_hi + x_lo a_hi + x_hi a_lo. B4 takes
Mosaic's six-pass HIGHEST dot (``ops/bs_chain.py:_dotf``): x = hi + mid + lo
with mid = bf16(x - hi), lo = bf16(x - hi - mid), and x a ~ hi.hi + hi.mid
+ mid.hi + hi.lo + lo.hi + mid.mid. The port's tensor-core kernels compute
the same forms, B1 and B5 B4's six passes (f32 grade). The op keeps its
slabs in f32; they are split here, once per op (:func:`split_op`,
:func:`split3_op`), from ``BsPaddedOp.dw_f32`` / ``up_f32``, and stay
constant over every call and chain of a sector.

The plain versions multiply the bf16 parts cast to f32 in f32 products
(each product of two bf16 values is exact in f32), over the dense padded
f32 factors ``hdw_p32`` / ``hup_p32`` split the same way
(:func:`dense_split`, :func:`dense_split3`) rather than the slabs, so a
window fault of a kernel shows as a mismatch, as B1's plain version does.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from .blocksparse import BsPaddedOp, _pop


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t (f32) -> (hi, lo) bf16 with hi = bf16(t), lo = bf16(t - hi), round
    to nearest even: the JAX package's split (``blocksparse.py:130``)."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def split3_bf16(t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """t (f32) -> (hi, mid, lo) bf16 with hi = bf16(t), mid = bf16(t - hi),
    lo = bf16(t - hi - mid), round to nearest even (both differences are
    exact in f32): 24 significant bits, the split of Mosaic's HIGHEST dot
    and of B4's kernel epilogue (``csrc/bs_panel_tc.cuh`` split3)."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def dot3_plain(xh, xl, ah, al) -> torch.Tensor:
    """x @ a from the parts: x_hi a_hi + x_lo a_hi + x_hi a_lo (f32)."""
    xh, xl, ah, al = (z.float() for z in (xh, xl, ah, al))
    return xh @ ah + xl @ ah + xh @ al


def dot1_plain(xh, xl, ah, al) -> torch.Tensor:
    """The one-pass product x_hi a_hi (f32); the lo parts are unused."""
    return xh.float() @ ah.float()


def dot6_plain(x, a) -> torch.Tensor:
    """x @ a from the (hi, mid, lo) parts of both: hi.hi + hi.mid + mid.hi
    + hi.lo + lo.hi + mid.mid, the kernel's passes, summed as the kernel
    sums them, in one f32 accumulation (the passes side by side along the
    contraction)."""
    (xh, xm, xl), (ah, am, al) = ([z.float() for z in p] for p in (x, a))
    return (torch.cat([xh, xh, xm, xh, xl, xm], -1)
            @ torch.cat([ah, am, ah, al, ah, am], -2))


@dataclass(frozen=True)
class SplitSlabs:
    """The op's slabs as bf16 hi/lo pairs, on the op's device."""
    dw_hi: torch.Tensor     # [ntd, 128, W_dw]
    dw_lo: torch.Tensor
    up_hi: torch.Tensor     # [ntu, W_up, 128]
    up_lo: torch.Tensor


@dataclass(frozen=True)
class DenseSplit:
    """The dense padded factors' bf16 parts, held as f32, and the dense
    separable diagonal: what the plain versions multiply."""
    hdw_hi: torch.Tensor    # [ddp, ddp]
    hdw_lo: torch.Tensor
    hup_hi: torch.Tensor    # [dup, dup]
    hup_lo: torch.Tensor
    diag: torch.Tensor      # [ddp, dup] f32, A @ B


@dataclass(frozen=True)
class Split3Slabs:
    """The op's slabs as (hi, mid, lo) bf16 parts, on the op's device."""
    dw: Tuple[torch.Tensor, ...]    # 3 x [ntd, 128, W_dw]
    up: Tuple[torch.Tensor, ...]    # 3 x [ntu, W_up, 128]

    def pointers(self) -> tuple:
        return tuple(t.data_ptr() for t in self.dw + self.up)


@dataclass(frozen=True)
class DenseSplit3:
    """The dense padded factors' (hi, mid, lo), held as f32, and the dense
    separable diagonal: what B4's plain version multiplies."""
    hdw: Tuple[torch.Tensor, ...]   # 3 x [ddp, ddp]
    hup: Tuple[torch.Tensor, ...]   # 3 x [dup, dup]
    diag: torch.Tensor              # [ddp, dup] f32, A @ B


_CACHE: Dict[Tuple[str, int], tuple] = {}


def _cached(kind: str, pop: BsPaddedOp, make: Callable):
    """make(pop), kept while pop lives (a few ops at a time)."""
    key = (kind, id(pop))
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is pop:
        return hit[1]
    for k in [k for k, (ref, _) in _CACHE.items() if ref() is None]:
        del _CACHE[k]
    val = make(pop)
    _CACHE[key] = (weakref.ref(pop), val)
    return val


def split_op(op) -> SplitSlabs:
    """The split of the op's f32 slabs (cached per op)."""
    def make(pop):
        return SplitSlabs(*split_bf16(pop.dw_f32), *split_bf16(pop.up_f32))
    return _cached("slabs", _pop(op), make)


def split3_op(op) -> Split3Slabs:
    """The three-part split of the op's f32 slabs (cached per op)."""
    def make(pop):
        return Split3Slabs(split3_bf16(pop.dw_f32), split3_bf16(pop.up_f32))
    return _cached("slabs3", _pop(op), make)


def dense_split(op) -> DenseSplit:
    """The split of the dense padded f32 factors (cached per op)."""
    def make(pop):
        dh, dl = split_bf16(pop.hdw_p32)
        uh, ul = split_bf16(pop.hup_p32)
        return DenseSplit(dh.float(), dl.float(), uh.float(), ul.float(),
                          pop.diag_a @ pop.diag_b)
    return _cached("dense", _pop(op), make)


def hv_plain(op, u_hi: torch.Tensor, u_lo: torch.Tensor, u32: torch.Tensor,
             passes: int = 3) -> torch.Tensor:
    """H_p u with split-bf16 hop products: (A B) o u32 + H_dw (u_hi, u_lo)
    + (u_hi, u_lo) H_up, three passes each (or one, passes=1), f32."""
    ds = dense_split(op)
    dot = dot3_plain if passes == 3 else dot1_plain
    return (ds.diag * u32 + dot(ds.hdw_hi, ds.hdw_lo, u_hi, u_lo)
            + dot(u_hi, u_lo, ds.hup_hi, ds.hup_lo))


def dense_split3(op) -> DenseSplit3:
    """The three-part split of the dense padded f32 factors (cached per
    op)."""
    def make(pop):
        def parts(t):
            return tuple(z.float() for z in split3_bf16(t))
        return DenseSplit3(parts(pop.hdw_p32), parts(pop.hup_p32),
                           pop.diag_a @ pop.diag_b)
    return _cached("dense3", _pop(op), make)


def hv_plain3(op, u_parts, u32: torch.Tensor) -> torch.Tensor:
    """H_p u with six-pass hop products: (A B) o u32 + H_dw u + u H_up over
    the (hi, mid, lo) parts of the factors and of u, f32."""
    ds = dense_split3(op)
    return (ds.diag * u32 + dot6_plain(ds.hdw, u_parts)
            + dot6_plain(u_parts, ds.hup))
