"""Band-sparse Krylov chains: the B2/B3/B4 kernels, their plain versions,
and the glue of the two-stage ground state and the GF chains (port of
``dmft_lanc_ed_tpu/ops/bs_chain.py``).

Three kernels, hand-written CUDA for sm_90a, over one panel apply of H_p u
on the RCM-permuted padded grid:

- B2 :func:`tridiag_call` — K plain Lanczos steps (no reorthogonalization,
  lazy normalization) emitting (alpha, beta); replaces
  ``bs_chain.py:_tridiag_kernel``. ``csrc/bs_chain_tc.cu``.
- B3 :func:`cheb_call` — K scaled-Chebyshev filter steps T_K((H - c)/e) v,
  normalized every step; replaces ``bs_chain.py:_cheb_kernel``.
  ``csrc/bs_chain_tc.cu``.
- B4 :func:`gf_tridiag_call` — the B2 step over a batch of excitation
  chains (the chain index is a grid dimension, every chain has its own
  scalar state, all chains advance in one launch per pass); replaces
  ``bs_chain.py:_gf_tridiag_kernel`` and the fixed zero-filled
  ``GF_CHAIN_BATCH`` chunks of ``_gf_batch_call``. ``csrc/bs_chain_tc.cu``.

All three run the hop products on the tensor cores in the TPU kernels' own
forms, with f32 accumulation (``csrc/bs_panel_tc.cuh``: wgmma fed by a
cp.async ring, two launches a B2/B4 step and one a B3 step; see the notes
at the top of the sources for what bounds them and what the design does
about it). B2 and B3 take the three-pass split-bf16 product hi.hi + lo.hi
+ hi.lo and carry the split's ~1.5e-5 relative error per product, the
contract the TPU's B2/B3 have. B4 takes the six-pass product of a
three-part split (hi.hi + hi.mid + mid.hi + hi.lo + lo.hi + mid.mid, the
TPU kernel's HIGHEST dots: 24 significant bits a side) for the GF chains'
~1e-7 per-matvec contract. The slabs are split once per op
(``ops/bf16x3.py``) and every vector plane is kept as f32 plus its stored
bf16 parts. All three keep f32 vectors, f64 cross-block sums and f64
scalar state.

Beside each kernel sits its plain PyTorch version
(:func:`tridiag_chain_plain`, :func:`cheb_chain_plain`,
:func:`gf_tridiag_batch_plain`): the same recurrence with the kernel's
product form (:func:`hv_split` for B2/B3, :func:`hv_split3` for B4),
through the dense padded factors and the diagonal ``diag_a @ diag_b``
rather than the slabs, so a window-clamping fault of a kernel shows as a
mismatch. A wrapper runs the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. Each wrapper counts its
chain launches in :data:`launch_counts` and the steps they ran in
:data:`step_counts` (a chain launch is K steps of one or two CUDA kernels
on one stream; a kernel's time is quoted per step); B4's launches also
record how many chains each carried (:data:`chains_per_launch`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.observability import kernel_stats, trace
from .bf16x3 import (hv_plain, hv_plain3, split3_bf16, split3_op,
                     split_bf16, split_op)
from .blocksparse import (BsPaddedOp, BlockSparseSectorOp, _check_cuda_inputs,
                          _geometry, _hv_plain, _pop, from_padded, to_padded)

# Chebyshev filter degrees are rounded up to these, as the reference's
# kernel does (its chain length is a static kernel parameter), so a given
# m_cheb filters with the same polynomial in both packages.
_K_BUCKETS = (16, 32, 64, 96, 128, 192, 256)

# Device-memory gate of one chain (the JAX package gated on the TPU's
# ~16 MB VMEM). Here the vector planes, the slabs and the diagonal factors
# live in device memory; a chain fits when they take at most this.
CHAIN_DEVICE_BUDGET = 2 << 30

# chain launches per wrapper since the last reset, and the steps they ran
# (see module docstring)
launch_counts = {"tridiag": 0, "cheb": 0, "gf_tridiag": 0}
step_counts = {"tridiag": 0, "cheb": 0, "gf_tridiag": 0}
# the chains each B4 launch carried, in launch order
chains_per_launch: dict = {"gf_tridiag": []}
# ground_state_seed calls that reached eta_target / gave up after
# max_rounds (the latter send their sector through the full top-off)
seed_counts = {"reached": 0, "missed": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, step_counts, seed_counts):
        for k in counts:
            counts[k] = 0
    for chains in chains_per_launch.values():
        chains.clear()


def _count(name: str, kk: int) -> None:
    launch_counts[name] += 1
    step_counts[name] += kk


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if k <= b:
            return b
    raise ValueError(f"chain length {k} exceeds the largest chain bucket "
                     f"{_K_BUCKETS[-1]}")


def _chain_bytes(pop: BsPaddedOp, nchains: int = 1, parts: int = 2) -> int:
    """Device bytes that nchains chains on the op hold in the product form
    of `parts` bf16 parts a side (2: B2/B3, 3: B4): per chain two f32
    planes and their parts; per op the slabs split into their parts and the
    diagonal factors."""
    ddp, dup = pop.padded_shape
    slabs = pop.dw_f32.numel() + pop.up_f32.numel()
    return (nchains * 2 * (4 + 2 * parts) * ddp * dup
            + 2 * parts * slabs
            + 4 * (pop.diag_a.numel() + pop.diag_b.numel()))


def chain_applicable(op) -> bool:
    """True when one B2/B3 chain's vector planes (f32 and bf16 pairs), the
    split slabs and the diagonal factors fit :data:`CHAIN_DEVICE_BUDGET` of
    device memory."""
    return _chain_bytes(_pop(op)) <= CHAIN_DEVICE_BUDGET


def gf_chain_applicable(op, m: int) -> bool:
    """Gate of the GF chain path: one B4 chain's footprint (f32 planes and
    their three parts, the three-part slabs, the diagonal) within
    :data:`CHAIN_DEVICE_BUDGET`, and a chain length within the reference's
    largest bucket (so both packages route the same sectors)."""
    return (m <= _K_BUCKETS[-1]
            and _chain_bytes(_pop(op), 1, parts=3) <= CHAIN_DEVICE_BUDGET)


# --------------------------------------------------------------------------
# plain versions (PyTorch, same recurrences, dense padded factors)
# --------------------------------------------------------------------------
def _bcast(s: torch.Tensor) -> torch.Tensor:
    return s.float()[:, None, None]


def hv_split(pop: BsPaddedOp, u: torch.Tensor,
             pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """H_p u in B2/B3's product form: the three-pass split-bf16 hop
    products over the dense split factors, the diagonal in f32. `pair`:
    the stored (hi, lo) of u, else u is split here (the same bits)."""
    u_hi, u_lo = split_bf16(u) if pair is None else pair
    return hv_plain(pop, u_hi, u_lo, u)


def hv_split3(pop: BsPaddedOp, u: torch.Tensor,
              parts: Optional[Tuple[torch.Tensor, ...]] = None
              ) -> torch.Tensor:
    """H_p u in B4's product form: the six-pass hop products of the
    three-part split over the dense split factors, the diagonal in f32.
    `parts`: the stored (hi, mid, lo) of u, else u is split here."""
    return hv_plain3(pop, split3_bf16(u) if parts is None else parts, u)


def _split_of(hv: Callable) -> Optional[Callable]:
    """The split whose parts the planes of a chain with product `hv`
    carry (None for a product of f32 planes, such as ``_hv_plain``)."""
    return {hv_split: split_bf16, hv_split3: split3_bf16}.get(hv)


def tridiag_chain_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int,
                        hv: Callable = hv_split, out: Optional[dict] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2 (and, with ``hv=hv_split3``, of B4): kk Lanczos
    steps of nb chains from the normalized padded f32 starts v32p
    [nb, ddp, dup] with the product ``hv(pop, u)``; returns raw
    (alphas, betas) [nb, kk] f64 (betas[:, k] couples step k -> k+1).
    ``hv=_hv_plain`` gives the true-f32 chain, the yardstick of what a
    product form costs. With a split product the planes carry their stored
    bf16 parts, as the kernel's do; `out`, if given, receives the final
    ``planes`` (two f32 [nb, ddp, dup]) and ``parts`` (their parts)."""
    pop = _pop(pop)
    planes = [v32p.float().clone(),
              torch.zeros_like(v32p, dtype=torch.float32)]
    split = _split_of(hv)
    parts = [split(p) for p in planes] if split else None
    nb = v32p.shape[0]
    f64 = dict(dtype=torch.float64, device=v32p.device)
    s_cur = torch.ones(nb, **f64)
    coup = torch.zeros(nb, **f64)
    alphas, betas = [], []
    for k in range(kk):
        u, q = planes[k % 2], planes[1 - k % 2]
        hu = hv(pop, u, parts[k % 2]) if split else hv(pop, u)
        y = _bcast(s_cur) * hu - _bcast(coup) * q
        alpha = s_cur * (u.double() * y.double()).sum((1, 2))
        w = y - _bcast(alpha * s_cur) * u
        beta = torch.sqrt((w.double() ** 2).sum((1, 2)))
        planes[1 - k % 2] = w
        if split:
            parts[1 - k % 2] = split(w)
        coup = beta * s_cur
        s_cur = torch.where(beta > 1e-30, 1.0 / beta, 0.0)
        alphas.append(alpha)
        betas.append(beta)
    if out is not None:
        out.update(planes=planes, parts=parts)
    return torch.stack(alphas, 1), torch.stack(betas, 1)


def cheb_chain_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int, c: float,
                     inv_e: float, hv: Callable = hv_split,
                     out: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3: kk scaled-Chebyshev steps from v32p [ddp, dup]
    with the product ``hv(pop, u)`` (the split product and stored pairs by
    default; ``_hv_plain`` gives the true-f32 chain the kernel is measured
    against); returns (the last unnormalized vector f32, its norm f64).
    `out` as in :func:`tridiag_chain_plain` (planes [1, ddp, dup])."""
    pop = _pop(pop)
    planes = [v32p.float().clone()[None],
              torch.zeros((1,) + tuple(v32p.shape), dtype=torch.float32,
                          device=v32p.device)]
    split = _split_of(hv)
    parts = [split(p) for p in planes] if split else None
    f64 = dict(dtype=torch.float64, device=v32p.device)
    s_cur = torch.ones(1, **f64)
    s_prv = torch.zeros(1, **f64)
    nrm = torch.zeros(1, **f64)
    for k in range(kk):
        u, q = planes[k % 2], planes[1 - k % 2]
        fac = (inv_e if k == 0 else 2.0 * inv_e) * s_cur
        hu = hv(pop, u, parts[k % 2]) if split else hv(pop, u)
        r = _bcast(fac) * (hu - c * u) - _bcast(s_cur * s_prv) * q
        nrm = torch.sqrt((r.double() ** 2).sum((1, 2)))
        planes[1 - k % 2] = r
        if split:
            parts[1 - k % 2] = split(r)
        s_prv = s_cur
        s_cur = torch.where(nrm > 1e-30, 1.0 / nrm, 0.0)
    if out is not None:
        out.update(planes=planes, parts=parts)
    return planes[kk % 2][0], nrm[0]


def gf_tridiag_batch_plain(pop: BsPaddedOp, v32p: torch.Tensor, kk: int,
                           out: Optional[dict] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4: the B2 recurrence over a batch with the
    six-pass product of the three-part split (:func:`hv_split3`), the
    planes carrying their stored (hi, mid, lo); `out` as in
    :func:`tridiag_chain_plain`."""
    return tridiag_chain_plain(pop, v32p, kk, hv=hv_split3, out=out)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def _chain_buffers(pop: BsPaddedOp, vb: torch.Tensor, kk: int, parts: int):
    """Check the inputs of tensor-core chains from the starts vb
    [nb, ddp, dup] and allocate what they run on: (lib, planes
    [nb, 2, ddp, dup] f32, their parts [nb, 2, parts, ddp, dup] bf16, state
    [nb, 4] f64, partials, ticket counters [nb]). Plane 0 of each chain
    holds its start and parts[:, 0] the start's split, each state is
    {1, 0, 0, 0}, each counter 0. Every fill is a device operation, so a
    call can be captured into a CUDA graph."""
    from .. import _kernels
    lib = _kernels.lib()
    if vb.dim() != 3 or kk <= 0:
        raise ValueError(f"chain kernel: vectors [nb, ddp, dup] and kk > 0, "
                         f"got {tuple(vb.shape)}, kk={kk}")
    _check_cuda_inputs(pop, vb)
    nb = vb.shape[0]
    ddp, dup = pop.padded_shape
    dev = vb.device
    planes = torch.zeros((nb, 2, ddp, dup), dtype=torch.float32, device=dev)
    planes[:, 0].copy_(vb)
    pv = torch.zeros((nb, 2, parts, ddp, dup), dtype=torch.bfloat16,
                     device=dev)
    for p, t in enumerate((split_bf16 if parts == 2 else split3_bf16)(vb)):
        pv[:, 0, p].copy_(t)
    state = torch.zeros((nb, 4), dtype=torch.float64, device=dev)
    state[:, :1].fill_(1.0)
    partials = torch.empty((nb, lib.bs_chain_tc_nblk(ddp, dup)),
                           dtype=torch.float64, device=dev)
    counter = torch.zeros(nb, dtype=torch.int32, device=dev)
    return lib, planes, pv, state, partials, counter


def _one(v32p: torch.Tensor, what: str) -> torch.Tensor:
    """v32p [ddp, dup] as a batch of one chain."""
    if v32p.dim() != 2:
        raise ValueError(f"{what}: one vector [ddp, dup], got "
                         f"{tuple(v32p.shape)}")
    return v32p[None]


def _split2_ptrs(pop: BsPaddedOp) -> tuple:
    """Pointers of B2/B3's split slabs and of the diagonal factors."""
    sp = split_op(pop)
    return (sp.dw_hi.data_ptr(), sp.dw_lo.data_ptr(), sp.up_hi.data_ptr(),
            sp.up_lo.data_ptr(), pop.diag_a.data_ptr(),
            pop.diag_b.data_ptr())


def _split3_ptrs(pop: BsPaddedOp) -> tuple:
    """Pointers of B4's three-part slabs and of the diagonal factors."""
    return split3_op(pop).pointers() + (pop.diag_a.data_ptr(),
                                        pop.diag_b.data_ptr())


def _run_tridiag_tc(pop: BsPaddedOp, v32p: torch.Tensor, kk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B2's tensor-core chain kernel on v32p [ddp, dup] -> (alphas,
    betas) [kk] f64."""
    from .. import _kernels
    lib, planes, pair, state, partials, counter = _chain_buffers(
        pop, _one(v32p, "tridiag_call"), kk, 2)
    dev = v32p.device
    alphas = torch.empty(kk, dtype=torch.float64, device=dev)
    betas = torch.empty(kk, dtype=torch.float64, device=dev)
    err = lib.bs_tridiag_chain_tc(
        *_split2_ptrs(pop), planes.data_ptr(), pair.data_ptr(),
        state.data_ptr(), partials.data_ptr(), counter.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), *_geometry(pop), kk,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_tridiag_chain_tc")
    return alphas, betas


def _run_cheb_tc(pop: BsPaddedOp, v32p: torch.Tensor, kk: int, c: float,
                 inv_e: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B3's tensor-core chain kernel on v32p [ddp, dup] -> (the last
    unnormalized vector f32, its norm f64 0-d)."""
    from .. import _kernels
    lib, planes, pair, state, partials, counter = _chain_buffers(
        pop, _one(v32p, "cheb_call"), kk, 2)
    dev = v32p.device
    norm = torch.empty(1, dtype=torch.float64, device=dev)
    err = lib.bs_cheb_chain_tc(
        *_split2_ptrs(pop), planes.data_ptr(), pair.data_ptr(),
        state.data_ptr(), partials.data_ptr(), counter.data_ptr(),
        norm.data_ptr(), float(c), float(inv_e), *_geometry(pop), kk,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_cheb_chain_tc")
    return planes[0, kk % 2], norm[0]


def _run_gf_tc(pop: BsPaddedOp, vb: torch.Tensor, kk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B4's tensor-core chain kernel on the nb starts vb
    [nb, ddp, dup] -> (alphas, betas) [nb, kk] f64."""
    from .. import _kernels
    lib, planes, parts, state, partials, counter = _chain_buffers(
        pop, vb, kk, 3)
    nb = vb.shape[0]
    dev = vb.device
    alphas = torch.empty((nb, kk), dtype=torch.float64, device=dev)
    betas = torch.empty((nb, kk), dtype=torch.float64, device=dev)
    err = lib.bs_gf_tridiag_chain_tc(
        *_split3_ptrs(pop), planes.data_ptr(), parts.data_ptr(),
        state.data_ptr(), partials.data_ptr(), counter.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), nb, *_geometry(pop), kk,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "bs_gf_tridiag_chain_tc")
    return alphas, betas


def _run_hv_tc(pop: BsPaddedOp, u: torch.Tensor, tile: int = 0
               ) -> torch.Tensor:
    """One H_p u in B4's six-pass form on the card (the product of a B4
    step without its recurrence), at output tile width `tile` (32 or 128;
    0: the launcher's choice for one chain) -> f32 [ddp, dup]. For tests
    and measurements; on no solver path."""
    from .. import _kernels
    lib, planes, parts, _, _, _ = _chain_buffers(pop, _one(u, "hv"), 1, 3)
    err = lib.bs_hv_tc(
        *_split3_ptrs(pop), planes.data_ptr(), parts.data_ptr(),
        *_geometry(pop), tile,
        torch.cuda.current_stream(u.device).cuda_stream)
    _kernels.check(err, "bs_hv_tc")
    return planes[0, 1]


def tridiag_call(op, v32p: torch.Tensor, kk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: kk Lanczos steps of one chain from v32p [ddp, dup] -> raw
    (alphas, betas) [kk] f64 on the vector's device."""
    pop = _pop(op)
    if v32p.is_cuda:
        al, be = _run_tridiag_tc(pop, v32p, kk)
        _count("tridiag", kk)
        return al, be
    if v32p.device.type == "cpu":
        al, be = tridiag_chain_plain(pop, v32p[None], kk)
        return al[0], be[0]
    raise ValueError(f"tridiag_call: unsupported device {v32p.device}")


def gf_tridiag_call(op, v32p: torch.Tensor, kk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: kk Lanczos steps of the nb chains v32p [nb, ddp, dup] in one
    kernel chain -> raw (alphas, betas) [nb, kk] f64."""
    pop = _pop(op)
    if v32p.is_cuda:
        al, be = _run_gf_tc(pop, v32p.contiguous(), kk)
        _count("gf_tridiag", kk)
        chains_per_launch["gf_tridiag"].append(int(v32p.shape[0]))
        return al, be
    if v32p.device.type == "cpu":
        return gf_tridiag_batch_plain(pop, v32p, kk)
    raise ValueError(f"gf_tridiag_call: unsupported device {v32p.device}")


def cheb_call(op, v32p: torch.Tensor, kk: int, c: float, inv_e: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: kk scaled-Chebyshev steps of v32p [ddp, dup] -> (the last
    unnormalized vector f32 [ddp, dup], its norm f64 0-d tensor)."""
    pop = _pop(op)
    if v32p.device.type == "cpu":
        return cheb_chain_plain(pop, v32p, kk, c, inv_e)
    if not v32p.is_cuda:
        raise ValueError(f"cheb_call: unsupported device {v32p.device}")
    out = _run_cheb_tc(pop, v32p, kk, c, inv_e)
    _count("cheb", kk)
    return out


# --------------------------------------------------------------------------
# glue
# --------------------------------------------------------------------------
def tridiag_chain(op, v32p: torch.Tensor, m: int
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """m-step Lanczos tridiagonalization from a normalized padded v0.

    Returns (alphas[m], betas[m], beta_out) host f64 — (alphas, betas) in
    the lanczos_tridiag layout (betas[0]=0, betas[j] couples steps j-1 <-> j)
    and beta_out the coupling out of the last vector (the Ritz residual
    scale). One chain launch; the host reads the results once."""
    al, be = tridiag_call(op, v32p, m)
    kernel_stats.record(m, _pop(op).nnz)
    al = al.cpu().numpy()
    be_raw = be.cpu().numpy()
    betas = np.concatenate([[0.0], be_raw[:m - 1]])
    return al, betas, float(be_raw[m - 1])


def cheb_chain(op, v32p: torch.Tensor, m: int, c: float, e: float
               ) -> torch.Tensor:
    """Scaled Chebyshev filter T_K((H - c)/e) v of degree K = the bucket
    of m, normalized output (no host sync). Components inside [c-e, c+e]
    are damped to <= 1; those below c-e grow like
    cosh(K acosh((c-lam)/e)), so the ground state dominates."""
    kk = _bucket_k(m)
    v, nrm = cheb_call(op, v32p, kk, c, 1.0 / e)
    kernel_stats.record(kk, _pop(op).nnz)
    return v / torch.clamp(nrm, min=1e-30).float()


# Ritz ghost-cluster tolerance, as a fraction of the spectral span. A chain
# without reorthogonalization re-creates converged eigenvalues as
# near-duplicate "ghosts" just above theta_0, and a copy still converging
# sits a little higher; everything within this window of theta_0 is one
# target cluster (the filter cut must sit outside it and the seed overlap
# sums over it). Where the copies appear depends on the chain's rounding
# noise, so the value is measured per product form, over all 109
# band-sparse sectors of the nbath = 11 default bath on an H100. The JAX
# package tuned 3e-5 to its split-bf16 chain on the TPU. The port's f32
# chain needed 3e-4 (a converging copy at 2.3e-4 x span passed for the gap
# in sectors (4,5) and (7,6)). With the split-bf16 tensor-core chain 3e-4
# is too tight in turn: in the 495 x 12 sector a copy at 3.2e-4 and then
# 3.9e-4 x span passed for the gap, the cut fell next to theta_0, the
# filter barely amplified, and the seed never reached eta_target in 3
# rounds (1 of 109 missed at 1e-4 and 3e-4, 3 at 3e-5). 1e-3 and 3e-3 seed
# all 109; 1e-3 is 2.5x above the highest copy seen and 20x below the
# smallest true gap of those sectors (2.1e-2 x span). Merging a real state
# that close only widens the filtered cluster, which the top-off / polish
# resolve (ROADMAP C3).
_GHOST_TOL = 1e-3


def _ritz_bounds(op, v0, m_tri):
    """One tridiag chain -> (theta ascending, b_safe, cluster overlap
    |<v_start, span{ritz in theta_0 cluster}>|, cluster_tol)."""
    alphas, betas, beta_out = tridiag_chain(op, v0, m_tri)
    m_eff = m_tri
    for j in range(1, m_tri):
        if betas[j] <= 1e-20:          # invariant subspace exhausted
            m_eff = j
            beta_out = 0.0
            break
    t = np.diag(alphas[:m_eff]) + np.diag(betas[1:m_eff], 1) \
        + np.diag(betas[1:m_eff], -1)
    theta, s = np.linalg.eigh(t)
    span = max(float(theta[-1] - theta[0]), 1e-12)
    # the top Ritz value underestimates lambda_max; pad by its residual so
    # the filter interval truly covers the spectrum
    resid_top = abs(beta_out * float(s[m_eff - 1, -1]))
    b_safe = float(theta[-1]) + 4.0 * resid_top + 1e-3 * span
    cluster_tol = _GHOST_TOL * span
    cluster = theta <= float(theta[0]) + cluster_tol
    s00 = float(np.sqrt(np.sum(s[0, cluster] ** 2)))
    return theta, b_safe, s00, cluster_tol


def ground_state_seed(op: BlockSparseSectorOp, m_tri: int = 96,
                      m_cheb: int = 128, seed: int = 17,
                      v0: Optional[torch.Tensor] = None,
                      max_rounds: int = 4, eta_target: float = 3e-3,
                      return_padded: bool = False):
    """Ground-state seed via tridiag chains (B2) + Chebyshev filters (B3).

    Iterates (tridiag chain -> Ritz bounds -> filter) until the current
    vector's overlap with the lowest Ritz direction reaches
    1 - eta_target^2 (or ``max_rounds``). The damping cut sits strictly
    inside the (theta_0, theta_1) Ritz gap and the upper bound b comes from
    the first round (a random start sees the top of the spectrum).

    Four rounds where the JAX package gives three: the BHZ replica bath's
    sectors (5,4), (5,3) and their mirrors at nbath = 5 have a true gap of
    1.1e-3 to 2.3e-3 x span, just above the ghost tolerance; their third
    filtered vector reaches eta_target (eta 1.2e-3 to 9e-6, against 3.1e-3
    to 2e-1 before that filter), which only a fourth Ritz round sees. A
    sector that reaches it sooner stops sooner, so the extra round costs
    nothing elsewhere; a sector that misses takes the whole mixed top-off.

    Returns (theta_min estimate, normalized seed, eta): the seed natural
    [dim_dw, dim_up] f64 by default, or permuted padded f32 when
    ``return_padded``. The start vector is numpy ``default_rng(seed)``, as
    in the reference, so both packages start from the same vector. The pad
    subspace starts exactly zero and stays exactly zero.
    """
    if v0 is None:
        rng = np.random.default_rng(seed)
        v0n = rng.standard_normal((op.dim_dw, op.dim_up))
        v0 = to_padded(op, v0n / np.linalg.norm(v0n))
    v = v0
    b_global = None
    theta = None
    eta = 1.0
    reached = False
    for _ in range(max_rounds):
        theta, b_safe, s00, cluster_tol = _ritz_bounds(op, v, m_tri)
        eta = float(np.sqrt(max(1.0 - s00 * s00, 0.0)))
        b_global = b_safe if b_global is None else max(b_global, b_safe)
        if 1.0 - s00 * s00 <= eta_target * eta_target:
            reached = True
            break
        span = max(b_global - float(theta[0]), 1e-12)
        distinct = theta[theta > theta[0] + cluster_tol]
        gap = float(distinct[0] - theta[0]) if distinct.size \
            else 0.02 * span
        cut = float(theta[0]) + 0.35 * gap
        c = 0.5 * (b_global + cut)
        e = max(0.5 * (b_global - cut), 1e-12 * span)
        v = cheb_chain(op, v, m_cheb, c, e)
    seed_counts["reached" if reached else "missed"] += 1
    if return_padded:
        return float(theta[0]), v, eta
    vnat = from_padded(op, v, torch.float64)
    return float(theta[0]), vnat / torch.linalg.vector_norm(vnat), eta


def gf_tridiag_batch(op: BlockSparseSectorOp, v_batch, m: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched GF tridiagonalization through the B4 chain kernel.

    v_batch: [B, dim] f64 flat natural-layout start vectors (normalized),
    numpy or tensor; returns (alphas [B, m], betas [B, m]) host f64 in the
    lanczos_tridiag layout (betas[:, 0] = 0) — drop-in for
    ``lanczos_tridiag_batched`` where :func:`gf_chain_applicable` holds.
    All chains of a chunk advance together; chunks only bound the planes'
    device memory (:data:`CHAIN_DEVICE_BUDGET`)."""
    pop = op.pop
    if trace.on and op.device.type == "cuda" and not (
            isinstance(v_batch, torch.Tensor) and v_batch.is_cuda):
        trace.count("h2d_bytes", v_batch.nbytes)
    v_batch = torch.as_tensor(v_batch, device=op.device)
    b_total = v_batch.shape[0]
    per_chain = _chain_bytes(pop, 2, parts=3) - _chain_bytes(pop, 1, parts=3)
    chunk = max(1, (CHAIN_DEVICE_BUDGET - _chain_bytes(pop, 0, parts=3))
                // per_chain)
    al_all, be_all = [], []
    for i0 in range(0, b_total, chunk):
        vs = v_batch[i0:i0 + chunk].reshape(-1, op.dim_dw, op.dim_up)
        al, be = gf_tridiag_call(op, to_padded(op, vs), m)
        if trace.on and al.is_cuda:
            trace.count("d2h_bytes", al.nbytes + be.nbytes)
        al_all.append(al.cpu().numpy())
        be_all.append(be.cpu().numpy())
    al = np.concatenate(al_all)
    be_raw = np.concatenate(be_all)
    betas = np.concatenate([np.zeros((b_total, 1)), be_raw[:, :m - 1]],
                           axis=1)
    return al, betas
