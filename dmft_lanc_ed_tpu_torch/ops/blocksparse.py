"""Band-sparse sector operator: host builder, the per-call matvec kernel
B1 and the plain applies (port of ``dmft_lanc_ed_tpu/ops/blocksparse.py``).

The host builder is the reference's: a reverse-Cuthill-McKee reordering of
each one-spin hop factor concentrates its nonzeros into a band of a few
128-tiles, and the factors become clipped banded slabs over the 128-padded
permuted grid (dw: row slabs [ntd, 128, W_dw]; up: column slabs
[ntu, W_up, 128]). The sector diagonal is exactly low-rank and becomes two
small factors A[ddp, R] B[R, dup] by adaptive cross approximation; the pad
block gets +PAD_SHIFT through two extra rank terms, so the pad subspace is
exactly invariant and far above the physics. The per-panel runs of the
windows' nonzero 128-tiles (:func:`_trim_runs`) are kept on the op, as
host tuples and as small int32 device tables.

The op keeps its slabs in plain f32. The kernels split them into bf16
parts once per op (``ops/bf16x3.split_op``, ``split3_op``): the chain
kernels B2/B3 run the JAX package's three-pass split-bf16 product on the
tensor cores, B1, B4 and B5 six passes over a three-part split, whose
error is that of an f32 product.

B1, hand-written CUDA in ``csrc/bs_matvec.cu``: one fused matvec
``y = s·((A B)∘v + H_dw,p v + v H_up,p)`` with per-128-row-panel sums of
squares, either over the trim runs (:func:`matvec_bs_padded`,
:func:`chain_step`; replaces ``blocksparse.py:_runs_kernel``) or over the
whole windows (``trim=False``; replaces ``_fused_kernel``). A call is two
launches: the split of v into its three bf16 parts (:func:`split3_rows`),
then the product, whose last block finishes the panel sums. Beside it sits
its plain PyTorch version :func:`matvec_bs_padded_plain`, the same six
passes through the dense padded f32 factors' split, so a window or run
fault of the kernel shows as a mismatch. A wrapper runs the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises, and counts the product launch in :data:`launch_counts`.

The padded-space exact (f64) and mixed (true-f32 products, f64 diagonal)
applies serve the Lanczos top-off and the f64 polish of the two-stage
ground state; they are plain ``torch.matmul``, as the JAX package left
them to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..hamiltonian import SectorHamiltonian
from ..utils.observability import trace
from .dense import electron_only

PAD_SHIFT = 1.0e3   # pad-row diagonal shift
ACA_RANK_MAX = 24   # diagonal separability cap (physics: ~2 + norb^2)
# Device-memory gate of the band-sparse operator (the JAX package gated on
# the TPU's VMEM): the op keeps its padded and natural factors (f64 + f32),
# the f32 slabs and the f64 padded diagonal in device memory, next to the
# Krylov bases of the solver. 8 GiB leaves most of an 80 GB card to them.
BS_DEVICE_BUDGET = 8 << 30


def _pad128(n: int) -> int:
    return ((n + 127) // 128) * 128


def _factor_dense(cols: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    h = np.zeros((n, n))
    np.add.at(h, (np.repeat(np.arange(n), cols.shape[1]),
                  np.asarray(cols).ravel()),
              np.asarray(vals, np.float64).ravel())
    return h


def _rcm_perm(h: np.ndarray) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a symmetric factor (host scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    m = sp.csr_matrix(h)
    m.eliminate_zeros()
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      np.int64)


def _band(h: np.ndarray) -> int:
    i, j = np.nonzero(h)
    return int(np.abs(i - j).max()) if i.size else 0


def _aca(diag: np.ndarray, rmax: int = ACA_RANK_MAX,
         tol: float = 1e-12) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Adaptive cross approximation diag ~ sum_r a_r (x) b_r (exact for the
    exactly-low-rank sector diagonals; None if rank exceeds rmax)."""
    r = np.array(diag, np.float64)
    scale = np.abs(r).max() or 1.0
    a_list, b_list = [], []
    for _ in range(rmax):
        flat = np.abs(r).argmax()
        i, j = np.unravel_index(flat, r.shape)
        piv = r[i, j]
        if abs(piv) <= tol * scale:
            break
        a = r[:, j].copy()
        b = r[i, :] / piv
        a_list.append(a)
        b_list.append(b)
        r -= np.outer(a, b)
    if np.abs(r).max() > 10 * tol * scale:
        return None
    if not a_list:
        a_list, b_list = [np.zeros(diag.shape[0])], [np.zeros(diag.shape[1])]
    return np.stack(a_list, 1), np.stack(b_list, 0)   # [dd, R], [R, du]


def _banded_slabs(h_p: np.ndarray, n: int, np_: int, axis: int
                  ) -> Tuple[np.ndarray, int, int]:
    """Clipped banded slabs of a permuted factor, padded to np_.

    axis=0: row slabs [nt, 128, W] (panel i of rows x column window) —
    the dw form. axis=1: column slabs [nt, W, 128] — the up form.
    """
    nt = np_ // 128
    d = (_band(h_p) + 127) // 128
    w = min((2 * d + 1) * 128, np_)
    hp = np.zeros((np_, np_))
    hp[:n, :n] = h_p
    if axis == 0:
        slabs = np.zeros((nt, 128, w), np.float32)
        for i in range(nt):
            t = min(max((i - d) * 128, 0), np_ - w)
            slabs[i] = hp[i * 128:(i + 1) * 128, t:t + w]
    else:
        slabs = np.zeros((nt, w, 128), np.float32)
        for j in range(nt):
            t = min(max((j - d) * 128, 0), np_ - w)
            slabs[j] = hp[t:t + w, j * 128:(j + 1) * 128]
    return slabs, w, d


def _mask_runs(mask: np.ndarray) -> Tuple[Tuple, ...]:
    """Per-panel rows of a tile mask [nt, ntw] -> per-panel tuples of
    (t0, t1) half-open ranges of its set tiles, ascending."""
    out = []
    for row in np.asarray(mask):
        runs = []
        for wt in map(int, np.flatnonzero(row)):
            if runs and runs[-1][1] == wt:
                runs[-1] = (runs[-1][0], wt + 1)
            else:
                runs.append((wt, wt + 1))
        out.append(tuple(runs))
    return tuple(out)


def _trim_runs(slabs: np.ndarray, axis: int) -> Tuple[Tuple, ...]:
    """Per-panel contiguous RUNS of nonzero window tiles (the zero-tile
    trim).

    slabs: [nt, 128, W] (axis=0, dw row slabs) or [nt, W, 128] (axis=1,
    up column slabs). Returns per-panel tuples of (t0, t1) half-open tile
    ranges of the window covering every nonzero tile, ascending — trimmed
    accumulation visits the nonzero tiles in the untrimmed order, and the
    skipped terms are exact zeros.
    """
    nt = slabs.shape[0]
    if axis == 0:
        tiles = slabs.reshape(nt, 128, slabs.shape[2] // 128, 128)
        return _mask_runs(np.any(tiles != 0.0, axis=(1, 3)))
    tiles = slabs.reshape(nt, slabs.shape[1] // 128, 128, 128)
    return _mask_runs(np.any(tiles != 0.0, axis=(2, 3)))


def _runs_table(runs: Tuple[Tuple, ...], device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-panel runs -> (offsets [nt + 1], pairs [n, 2]) int32 on
    `device`: panel p's runs are pairs[offsets[p]:offsets[p + 1]]."""
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in runs])])
    tab = np.asarray([t for r in runs for t in r], np.int32).reshape(-1, 2)
    if not len(tab):
        tab = np.zeros((1, 2), np.int32)     # no runs at all: never read
    return (torch.as_tensor(ptr.astype(np.int32), device=device),
            torch.as_tensor(tab, device=device))


@dataclass(frozen=True)
class BsPaddedOp:
    """Padded-space half of the band-sparse operator: what the chain
    kernels, the top-off and the polish read (all on one device)."""
    dw_f32: torch.Tensor      # [ntd, 128, W_dw] f32 row slabs of Hdw
    up_f32: torch.Tensor      # [ntu, W_up, 128] f32 column slabs of Hup
    diag_a: torch.Tensor      # [ddp, R] f32 separable-diagonal factors
    diag_b: torch.Tensor      # [R, dup] f32
    diag_p: torch.Tensor      # [ddp, dup] f64 (pad rows/cols +PAD_SHIFT)
    hup_p: torch.Tensor       # [dup, dup] f64 permuted padded
    hdw_p: torch.Tensor       # [ddp, ddp] f64
    hup_p32: torch.Tensor     # f32 copies (mixed top-off, plain chains)
    hdw_p32: torch.Tensor
    w_dw: int = 0
    d_dw: int = 0
    w_up: int = 0
    d_up: int = 0
    # (dw_runs, up_runs): per-panel nonzero-tile runs, host tuples
    trim_runs: Tuple = ()
    # device run tables of the trimmed and of the whole windows, each
    # (dw offsets, dw pairs, up offsets, up pairs) int32 (see _runs_table)
    runs_trim: Tuple = ()
    runs_full: Tuple = ()
    # the sector Hamiltonian's nonzeros: what a matvec applies (counters)
    nnz: int = 0
    # R, the rank of the diagonal's ACA: diag_a's columns R and R + 1
    # (and diag_b's rows) carry the pad shift
    diag_rank: int = 0

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return tuple(self.diag_p.shape)

    @property
    def dim(self) -> int:
        ddp, dup = self.padded_shape
        return ddp * dup

    @property
    def device(self) -> torch.device:
        return self.diag_p.device


@dataclass(frozen=True)
class BlockSparseSectorOp:
    """Sector operator of the band-sparse backend.

    ``pop`` is the padded-space half. The natural-order fields serve the
    boundary crossings (:func:`to_padded` / :func:`from_padded`), the GF
    flat applies and the f64 oracle.
    """
    pop: BsPaddedOp
    perm_dw: torch.Tensor     # [dd] natural -> permuted gather indices
    perm_up: torch.Tensor     # [du]
    iperm_dw: torch.Tensor    # [dd] inverse
    iperm_up: torch.Tensor    # [du]
    diag: torch.Tensor        # [dd, du] f64, natural order
    hup: torch.Tensor         # [du, du] f64
    hdw: torch.Tensor         # [dd, dd] f64
    hup32: torch.Tensor       # f32 copies (GF flat apply, mixed contract)
    hdw32: torch.Tensor
    dim_dw: int = 0
    dim_up: int = 0
    nnz_count: int = 0

    @property
    def dim(self) -> int:
        return self.dim_dw * self.dim_up

    @property
    def nnz(self) -> int:
        return self.nnz_count

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return self.pop.padded_shape

    @property
    def device(self) -> torch.device:
        return self.pop.device


def _pop(op) -> BsPaddedOp:
    """Accept either the outer sector op or the padded half."""
    return op.pop if isinstance(op, BlockSparseSectorOp) else op


def _device_bytes(dd: int, du: int) -> int:
    """Device footprint of the op built for a dd x du sector (the slab
    windows bounded by the full padded width), with the three bf16 parts of
    the slabs that B1, B4 and B5 multiply."""
    ddp, dup = _pad128(dd), _pad128(du)
    return (8 * ddp * dup + 8 * dd * du            # diag_p, natural diag
            + 12 * (ddp * ddp + dup * dup)         # padded factors f64+f32
            + 12 * (dd * dd + du * du)             # natural factors f64+f32
            + 10 * (ddp * ddp + dup * dup))        # slabs f32 + 3 parts


def blocksparse_applicable(h: SectorHamiltonian) -> bool:
    """Pure-electron sectors without Jx/Jp whose operator fits the device
    budget and whose diagonal is ACA-separable (it always is for
    density-density interactions)."""
    if h.ph_diag is not None or h.nd_up_src is not None:
        return False
    if _device_bytes(h.dim_dw, h.dim_up) > BS_DEVICE_BUDGET:
        return False
    return _aca(np.asarray(h.diag, np.float64)) is not None


def build_blocksparse_op(h: SectorHamiltonian, device) -> BlockSparseSectorOp:
    """Host builder (RCM, slabs, ACA) -> operator tensors on `device`."""
    electron_only(h, "band-sparse backend")
    dd, du = h.dim_dw, h.dim_up
    ddp, dup = _pad128(dd), _pad128(du)
    hup = _factor_dense(h.up_cols, h.up_vals, du)
    hdw = _factor_dense(h.dw_cols, h.dw_vals, dd)
    diag = np.asarray(h.diag, np.float64)

    perm_up = _rcm_perm(hup)
    perm_dw = _rcm_perm(hdw)
    hup_p = hup[perm_up][:, perm_up]
    hdw_p = hdw[perm_dw][:, perm_dw]
    diag_p = diag[perm_dw][:, perm_up]

    dw_slabs, w_dw, d_dw = _banded_slabs(hdw_p, dd, ddp, axis=0)
    up_slabs, w_up, d_up = _banded_slabs(hup_p, du, dup, axis=1)
    dw_runs = _trim_runs(dw_slabs, axis=0)
    up_runs = _trim_runs(up_slabs, axis=1)
    full_dw = (((0, w_dw // 128),),) * (ddp // 128)
    full_up = (((0, w_up // 128),),) * (dup // 128)

    # separable diagonal over the padded grid, pad shift included as two
    # extra rank terms: PAD_SHIFT * (1_pad^dw (x) 1 + 1_phys^dw (x) 1_pad^up)
    ab = _aca(diag_p)
    if ab is None:
        raise ValueError("sector diagonal is not ACA-separable "
                         "(use the dense backend)")
    a, b = ab
    r = a.shape[1]
    rp = max(8, ((r + 2 + 7) // 8) * 8)
    diag_a = np.zeros((ddp, rp), np.float32)
    diag_b = np.zeros((rp, dup), np.float32)
    diag_a[:dd, :r] = a
    diag_b[:r, :du] = b
    diag_a[dd:, r] = PAD_SHIFT
    diag_b[r, :] = 1.0
    diag_a[:dd, r + 1] = PAD_SHIFT
    diag_b[r + 1, du:] = 1.0

    hup_pp = np.zeros((dup, dup))
    hup_pp[:du, :du] = hup_p
    hdw_pp = np.zeros((ddp, ddp))
    hdw_pp[:dd, :dd] = hdw_p
    diag_pp = np.zeros((ddp, dup))
    diag_pp[:dd, :du] = diag_p
    diag_pp[dd:, :] += PAD_SHIFT
    diag_pp[:dd, du:] += PAD_SHIFT

    inv_up = np.empty(du, np.int64)
    inv_up[perm_up] = np.arange(du)
    inv_dw = np.empty(dd, np.int64)
    inv_dw[perm_dw] = np.arange(dd)

    nbytes = [0]       # the run tables' few hundred bytes aside

    def put(x, dtype=torch.float64):
        t = torch.as_tensor(x, dtype=dtype, device=device)
        nbytes[0] += t.nbytes
        return t
    f32 = torch.float32
    with trace.span("ed.upload") as up:
        pop = BsPaddedOp(
            dw_f32=put(dw_slabs, f32), up_f32=put(up_slabs, f32),
            diag_a=put(diag_a, f32), diag_b=put(diag_b, f32),
            diag_p=put(diag_pp), hup_p=put(hup_pp), hdw_p=put(hdw_pp),
            hup_p32=put(hup_pp, f32), hdw_p32=put(hdw_pp, f32),
            w_dw=w_dw, d_dw=d_dw, w_up=w_up, d_up=d_up,
            trim_runs=(dw_runs, up_runs),
            runs_trim=(*_runs_table(dw_runs, device),
                       *_runs_table(up_runs, device)),
            runs_full=(*_runs_table(full_dw, device),
                       *_runs_table(full_up, device)),
            nnz=h.nnz, diag_rank=r)
        i64 = torch.int64
        op = BlockSparseSectorOp(
            pop=pop, perm_dw=put(perm_dw, i64), perm_up=put(perm_up, i64),
            iperm_dw=put(inv_dw, i64), iperm_up=put(inv_up, i64),
            diag=put(diag), hup=put(hup), hdw=put(hdw),
            hup32=put(hup, f32), hdw32=put(hdw, f32),
            dim_dw=dd, dim_up=du, nnz_count=h.nnz)
        if op.device.type == "cuda":
            up["bytes"] = nbytes[0]
            trace.count("h2d_bytes", nbytes[0])
    return op


# --------------------------------------------------------------------------
# the per-call fused matvec (B1): plain version, kernel wrapper
# --------------------------------------------------------------------------
# kernel launches per form since the last reset (one per matvec call)
launch_counts = {"matvec_runs": 0, "matvec_full": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def trim_share(pop) -> float:
    """Share of the window tiles the trim runs skip (both factors)."""
    pop = _pop(pop)
    (dw_runs, up_runs) = pop.trim_runs
    kept = sum(t1 - t0 for runs in dw_runs + up_runs for t0, t1 in runs)
    total = len(dw_runs) * pop.w_dw // 128 + len(up_runs) * pop.w_up // 128
    return 1.0 - kept / total


def _hv_plain(pop: BsPaddedOp, u: torch.Tensor) -> torch.Tensor:
    """H_p u for f32 u [..., ddp, dup] through the padded f32 factors (true
    f32 products: the yardstick of the split products)."""
    d = pop.diag_a @ pop.diag_b
    return d * u + pop.hdw_p32 @ u + u @ pop.hup_p32


def _panel_ss(y: torch.Tensor) -> torch.Tensor:
    """Per-128-row-panel sums of squares of y [ddp, dup] -> [ntd] f32."""
    return (y.double() ** 2).reshape(y.shape[0] // 128, -1).sum(1).float()


def matvec_bs_padded_plain(pop, v: torch.Tensor, scale
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: (scale * H_p v, per-panel sums of squares
    [ntd] f32) for f32 v [ddp, dup], with the kernel's six-pass products of
    the three-part splits of v and of the dense padded f32 factors (which
    hold every skipped tile as exact zeros)."""
    from .bf16x3 import hv_plain3, split3_bf16
    y = scale * hv_plain3(_pop(pop), split3_bf16(v), v)
    return y, _panel_ss(y)


def split3_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: the (hi, mid, lo) bf16 parts of
    f32 x [rows, dup] as one tensor [3, rows, dup]."""
    from .bf16x3 import split3_bf16
    return torch.stack(split3_bf16(x))


def split3_rows(x: torch.Tensor) -> torch.Tensor:
    """The split kernel (``csrc/bs_matvec.cu`` bs_split3): the (hi, mid,
    lo) bf16 parts of the f32 rows x [rows, dup] -> [3, rows, dup], round
    to nearest even. B1 and B5 multiply these parts of their vector. On a
    CPU tensor, :func:`split3_rows_plain`."""
    if x.device.type == "cpu":
        return split3_rows_plain(x)
    if not x.is_cuda:
        raise ValueError(f"split3_rows: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 8:
        raise ValueError("split3_rows: needs a contiguous f32 tensor of a "
                         "multiple of 8 values")
    from .. import _kernels
    parts = torch.empty((3,) + tuple(x.shape), dtype=torch.bfloat16,
                        device=x.device)
    _kernels.check(_kernels.lib().bs_split3(
        x.data_ptr(), parts.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream), "bs_split3")
    return parts


# the product launches' ticket counters, one int32 per device and launch
# site: 0 between launches (the launch's last block resets it), so a call
# needs no fill.
# Calls on one device run in stream order (the port uses one stream).
_TICKETS: dict = {}


def ticket(device: torch.device, site: str = "bs_matvec") -> torch.Tensor:
    """The ticket counter of a launch site's product launches on `device`
    (B1/B5's ``bs_matvec``, E2's ``trim_matvec``)."""
    t = _TICKETS.get((device, site))
    if t is None:
        t = _TICKETS[(device, site)] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
    return t


def _check_cuda_inputs(pop: BsPaddedOp, v: torch.Tensor) -> None:
    tensors = (v, pop.dw_f32, pop.up_f32, pop.diag_a, pop.diag_b)
    if any(t.device != v.device for t in tensors):
        raise ValueError("band-sparse kernel: operator and vector on "
                         "different devices")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("band-sparse kernel: needs contiguous f32 tensors")
    if tuple(v.shape[-2:]) != pop.padded_shape:
        raise ValueError(f"band-sparse kernel: vector shape "
                         f"{tuple(v.shape)} vs padded operator "
                         f"{pop.padded_shape}")


def _geometry(pop: BsPaddedOp):
    ddp, dup = pop.padded_shape
    return (ddp, dup, pop.diag_a.shape[1], pop.w_dw, pop.d_dw, pop.w_up,
            pop.d_up)


def _matvec_padded(op, v32p: torch.Tensor, scale, trim: bool = True,
                   tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: (scale * H_p v, per-panel sums of squares [ntd] f32) for the
    permuted padded f32 vector v32p [ddp, dup]; `scale` is a float or a
    device scalar (no host sync). ``trim`` walks the op's nonzero-tile
    runs (B1a), else the whole windows (B1b); the two agree bit for bit.
    `tile`: the output tile's width on the card (32 or 128; 0 for the
    launcher's choice); every width gives the same bits."""
    pop = _pop(op)
    if v32p.device.type == "cpu":
        return matvec_bs_padded_plain(pop, v32p, scale)
    if not v32p.is_cuda:
        raise ValueError(f"matvec_bs_padded: unsupported device "
                         f"{v32p.device}")
    from .. import _kernels
    from .bf16x3 import split3_op
    lib = _kernels.lib()
    v = v32p.contiguous()
    _check_cuda_inputs(pop, v)
    if v.dim() != 2:
        raise ValueError(f"matvec_bs_padded: one vector [ddp, dup], got "
                         f"{tuple(v.shape)}")
    dev = v.device
    ddp, dup = pop.padded_shape
    # a device scalar (its f32 copy) or a float the launch takes by value
    s, s_val = None, 0.0
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    else:
        s_val = float(scale)
    parts = split3_rows(v)
    y = torch.empty_like(v)
    ss = torch.empty(ddp // 128, dtype=torch.float32, device=dev)
    partials = torch.empty(lib.bs_matvec_nblk(ddp, dup), dtype=torch.float64,
                           device=dev)
    runs = pop.runs_trim if trim else pop.runs_full
    err = lib.bs_matvec(
        *split3_op(pop).pointers(), pop.diag_a.data_ptr(),
        pop.diag_b.data_ptr(), v.data_ptr(), parts.data_ptr(), None,
        y.data_ptr(), None if s is None else s.data_ptr(), s_val,
        partials.data_ptr(), ticket(dev).data_ptr(), ss.data_ptr(),
        *(t.data_ptr() for t in runs), ddp, ddp, *_geometry(pop)[1:], tile,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_matvec")
    launch_counts["matvec_runs" if trim else "matvec_full"] += 1
    return y, ss


def matvec_bs_padded(op, v32p: torch.Tensor, trim: bool = True
                     ) -> torch.Tensor:
    """Unscaled fused matvec H_p v on the permuted padded f32 vector."""
    return _matvec_padded(op, v32p, 1.0, trim)[0]


def chain_step(op, v32p: torch.Tensor, inv_norm
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One normalized power-iteration step in one trimmed kernel call:
    y = (inv_norm * H_p) v, returning (y, rsqrt(|y|^2 + 1e-30)) as an f32
    device scalar (no host sync) — feed it back as the next inv_norm."""
    y, ss = _matvec_padded(op, v32p, inv_norm)
    return y, torch.rsqrt(ss.double().sum() + 1e-30).float()


# --------------------------------------------------------------------------
# boundary helpers (natural <-> permuted padded)
# --------------------------------------------------------------------------
def to_padded(op: BlockSparseSectorOp, v) -> torch.Tensor:
    """Natural [..., dd, du] (numpy or tensor, any float dtype) -> permuted
    padded f32 [..., ddp, dup] on the op's device; the pad is exactly 0."""
    if trace.on and op.device.type == "cuda" and not (
            isinstance(v, torch.Tensor) and v.is_cuda):
        trace.count("h2d_bytes", v.nbytes)
    v = torch.as_tensor(v, device=op.device)
    lead = tuple(v.shape[:-2])
    ddp, dup = op.padded_shape
    out = torch.zeros(lead + (ddp, dup), dtype=torch.float32,
                      device=op.device)
    vp = v.index_select(-2, op.perm_dw).index_select(-1, op.perm_up)
    out[..., :op.dim_dw, :op.dim_up] = vp
    return out


def from_padded(op: BlockSparseSectorOp, v32p: torch.Tensor,
                dtype=torch.float64) -> torch.Tensor:
    """Permuted padded [..., ddp, dup] -> natural [..., dd, du] in `dtype`."""
    vn = v32p[..., :op.dim_dw, :op.dim_up].to(dtype)
    return vn.index_select(-2, op.iperm_dw).index_select(-1, op.iperm_up)


# --------------------------------------------------------------------------
# padded-space exact/mixed applies (polish & top-off)
# --------------------------------------------------------------------------
def matvec_bs_exact_padded(pop, v: torch.Tensor) -> torch.Tensor:
    """f64-exact apply in the permuted padded space ([ddp, dup] in/out).
    The pad subspace is exactly invariant (zero factor rows; diag_p keeps
    zero pad components zero)."""
    pop = _pop(pop)
    return pop.diag_p * v + v @ pop.hup_p + pop.hdw_p @ v


def matvec_bs_mixed_padded(pop, v: torch.Tensor) -> torch.Tensor:
    """True-f32 products + f64 diagonal in the padded space (the mixed
    contract, ~1e-7 relative), for the Lanczos top-off."""
    pop = _pop(pop)
    v32 = v.float()
    y32 = v32 @ pop.hup_p32 + pop.hdw_p32 @ v32
    return pop.diag_p * v + y32.to(v.dtype)


# --------------------------------------------------------------------------
# flat interfaces (natural order; GF scan and oracle)
# --------------------------------------------------------------------------
def _nd(op, v_flat: torch.Tensor) -> torch.Tensor:
    return v_flat.reshape(v_flat.shape[:-1] + (op.dim_dw, op.dim_up))


def matvec_bs_flat(op: BlockSparseSectorOp, v_flat: torch.Tensor
                   ) -> torch.Tensor:
    """Natural flat matvec at the mixed contract (true-f32 products over
    the natural-order factors + f64 diagonal) — the GF / generic apply.
    Takes [..., dim]."""
    v = _nd(op, v_flat)
    v32 = v.float()
    y32 = v32 @ op.hup32 + op.hdw32 @ v32
    return (op.diag * v + y32.to(v.dtype)).reshape(v_flat.shape)


def matvec_bs_exact_flat(op: BlockSparseSectorOp, v_flat: torch.Tensor
                         ) -> torch.Tensor:
    """f64-exact apply over the natural-order factors (polish / oracle)."""
    v = _nd(op, v_flat)
    return (op.diag * v + v @ op.hup + op.hdw @ v).reshape(v_flat.shape)
