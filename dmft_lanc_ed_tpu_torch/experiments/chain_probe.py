"""E1, the chain probe (port of ``experiments/chain_probe.py``).

The JAX probe tests, on the TPU, the Pallas constructs a one-launch chain
needs: scratch persisting over grid steps, a scalar accumulated over grid
steps and async copies. It runs a K-step normalized power chain
y <- A y / |A y| in one ``pallas_call`` and checks it against numpy. On
the card the counterpart of those constructs is one thread-block cluster
that runs the whole chain on chip: A resident in shared memory, the vector
exchanged through distributed shared memory, a cluster barrier between the
steps (``csrc/chain_probe.cu``; the note at its top has the design and what
bounds it).

:func:`chain` launches it for a CUDA tensor (or raises) and counts the
launch in :data:`launch_counts`; for a CPU tensor it runs the plain
version :func:`chain_plain`, the kernel's arithmetic in PyTorch: the JAX
kernel's HIGHEST product as six bf16 passes over a three-part split, each
64-deep stage summed apart, f64 sums of squares. :func:`reference` is the
JAX probe's own f32 numpy chain, the probe's check.

    python -m dmft_lanc_ed_tpu_torch.experiments.chain_probe [cuda|cpu]

runs the probe's check and, on the card, prints the time per step.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Tuple

import numpy as np
import torch

from ..ops.bf16x3 import dot6_plain, split3_bf16
from ..ops.factory import resolve_device

N = 256          # matrix dim (2 row panels of 128)
K = 7            # chain steps
COLS = 128       # vector columns
NMAX = 256       # the largest n one cluster holds (the kernel pads to it)
STAGE = 64       # contraction depth the kernel sums apart
BN = 32          # the kernel's tile, 64 x 32: a cluster of 16 CTAs
CTAS = NMAX // STAGE * COLS // BN

# kernel launches since the last reset (one per chain call)
launch_counts = {"chain_probe": 0}
# the chain steps those launches ran (a kernel's time is quoted per step)
step_counts = {"chain_probe": 0}

# what the launcher returns when the card cannot schedule the cluster
# (cudaErrorNotSupported)
_NO_CLUSTER = 801


def reset_launch_counts() -> None:
    for counts in (launch_counts, step_counts):
        for k in counts:
            counts[k] = 0


def _check(v0: torch.Tensor, a: torch.Tensor, kk: int) -> int:
    """n, after checking what one cluster takes (raises otherwise)."""
    n = v0.shape[0] if v0.dim() == 2 else -1
    if (tuple(v0.shape) != (n, COLS) or tuple(a.shape) != (n, n)
            or not 1 <= n <= NMAX):
        raise ValueError(f"chain: needs v0 [n, {COLS}] and A [n, n] with "
                         f"1 <= n <= {NMAX} (one cluster holds A's and the "
                         f"vector's {NMAX} rows), got {tuple(v0.shape)}, "
                         f"{tuple(a.shape)}")
    if (v0.dtype != torch.float32 or a.dtype != torch.float32
            or a.device != v0.device):
        raise ValueError("chain: needs f32 tensors on one device")
    if kk < 1:
        raise ValueError(f"chain: needs kk >= 1, got {kk}")
    return n


def _product_plain(a_parts, u: torch.Tensor) -> torch.Tensor:
    """A u as the kernel forms it: six passes over the (hi, mid, lo) parts
    of A (a_parts) and of u, per 64-deep stage, the stages added in f32 in
    order."""
    u_parts = split3_bf16(u)
    acc = torch.zeros((a_parts[0].shape[0], u.shape[1]), dtype=torch.float32,
                      device=u.device)
    for k0 in range(0, u.shape[0], STAGE):
        acc = acc + dot6_plain(tuple(p[:, k0:k0 + STAGE] for p in a_parts),
                               tuple(p[k0:k0 + STAGE] for p in u_parts))
    return acc


def chain_plain(v0: torch.Tensor, a: torch.Tensor, kk: int = K
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: kk steps of y = s (A u), s = 1 / |previous y| (1 at
    the start), u the previous y (v0 at the start); A u by
    :func:`_product_plain`, f32 with f64 sums of squares. Returns (norms
    [kk, 1] f32, the last y [n, 128] f32)."""
    a_parts = split3_bf16(a)
    s = torch.ones((), dtype=torch.float32, device=v0.device)
    u = v0.float()
    norms = []
    for _ in range(kk):
        u = s * _product_plain(a_parts, u)
        nrm = torch.sqrt((u.double() ** 2).sum()).float()
        norms.append(nrm)
        s = 1.0 / nrm
    return torch.stack(norms).reshape(kk, 1), u


def chain(v0: torch.Tensor, a: torch.Tensor, kk: int = K
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1: kk chain steps (the probe's K) from v0 [n, 128] with A [n, n]
    (f32, n <= 256) -> (norms [kk, 1] f32, vout [n, 128] f32, the last
    unnormalized product)."""
    n = _check(v0, a, kk)
    if v0.device.type == "cpu":
        return chain_plain(v0, a, kk)
    if not v0.is_cuda:
        raise ValueError(f"chain: unsupported device {v0.device}")
    return _launch(v0, a, kk, None)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address (the kernel's bulk copy
    and float4 loads need it; a view with a storage offset may not be)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(v0: torch.Tensor, a: torch.Tensor, kk: int, trace
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked CUDA tensors; trace: None or [kk, CTAS, 4]
    int64 for the clock trace."""
    from .. import _kernels
    n = v0.shape[0]
    lib = _kernels.lib()
    dev = v0.device
    if n < NMAX:                # zero rows and columns add exact zeros
        v0 = torch.nn.functional.pad(v0, (0, 0, 0, NMAX - n))
        a = torch.nn.functional.pad(a, (0, NMAX - n, 0, NMAX - n))
    v0, a = _aligned(v0), _aligned(a)
    norms = torch.empty(kk, dtype=torch.float32, device=dev)
    vout = torch.empty_like(v0)
    err = lib.chain_probe(v0.data_ptr(), a.data_ptr(), norms.data_ptr(),
                          vout.data_ptr(),
                          None if trace is None else trace.data_ptr(), kk,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err == _NO_CLUSTER:
        raise RuntimeError(f"chain_probe: this card cannot schedule a "
                           f"cluster of {CTAS} CTAs")
    _kernels.check(err, "chain_probe")
    launch_counts["chain_probe"] += 1
    step_counts["chain_probe"] += kk
    return norms.reshape(kk, 1), vout[:n]


def step_phases(v0: torch.Tensor, a: torch.Tensor, kk: int = 71) -> dict:
    """Where a step of the kernel goes, from its clock trace (each CTA's SM
    clock at a step's start, after the product, before the step's last
    cluster barrier and after it), over steps 1 .. kk - 2 and every CTA:
    the shares of the mean step of the product (from the wait for the
    peers' tiles on), the epilogue (the exchange), the barrier and the rest
    (the norm, the loop); and the mean step in clocks."""
    _check(v0, a, kk)
    if not v0.is_cuda or kk < 4:
        raise ValueError("step_phases: needs CUDA tensors and kk >= 4")
    trace = torch.zeros((kk, CTAS, 4), dtype=torch.int64, device=v0.device)
    _launch(v0, a, kk, trace)
    tr = trace.cpu().double()
    step = tr[2:, :, 0] - tr[1:-1, :, 0]
    cuts = tr[1:-1]
    parts = {"product": cuts[..., 1] - cuts[..., 0],
             "epilogue": cuts[..., 2] - cuts[..., 1],
             "barrier": cuts[..., 3] - cuts[..., 2],
             "rest": step - (cuts[..., 3] - cuts[..., 0])}
    mean = float(step.mean())
    out = {k: float(v.mean()) / mean for k, v in parts.items()}
    out["step_clocks"] = mean
    return out


def geometry() -> dict:
    """The kernel's cluster on the current card: its CTAs, each CTA's
    dynamic and static shared memory (bytes) and registers a thread, and
    the clusters the card holds at once (0: it cannot schedule one)."""
    from .. import _kernels
    out = (ctypes.c_int * 5)()
    _kernels.check(_kernels.lib().chain_probe_geometry(ctypes.addressof(out)),
                   "chain_probe_geometry")
    return dict(zip(("ctas", "smem_dynamic", "smem_static", "registers",
                     "clusters"), out))


def probe_inputs(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs, from numpy default_rng(0) as the JAX probe
    draws them: (v0 [N, 128] normalized, A [N, N] symmetric), f32."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)).astype(np.float32)
    a = a + a.T
    v0 = rng.standard_normal((N, COLS)).astype(np.float32)
    v0 /= np.linalg.norm(v0)
    return (torch.as_tensor(v0, device=device),
            torch.as_tensor(a, device=device))


def reference(v0: np.ndarray, a: np.ndarray, kk: int = K
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX probe's numpy check (f32): (norms [kk], the last y)."""
    v = v0.copy()
    ref_norms = []
    for _ in range(kk):
        w = (a @ v).astype(np.float32)
        n = np.linalg.norm(w).astype(np.float32)
        ref_norms.append(n)
        v = w / n
    ref_norms = np.array(ref_norms)
    return ref_norms, v * ref_norms[-1]


def main(device="cuda") -> dict:
    """The probe on `device` (the card by default; raises without one):
    its check against numpy with the JAX probe's gates (norms 1e-5, vout
    1e-4 relative) and, on the card, the time per step."""
    dev = resolve_device(device)
    v0, a = probe_inputs(dev)
    norms, vout = chain(v0, a)
    norms = norms.cpu().numpy().ravel()
    ref_norms, vref = reference(v0.cpu().numpy(), a.cpu().numpy())
    print("norms kernel:", norms)
    print("norms ref:   ", ref_norms)
    err_n = float(np.abs(norms - ref_norms).max() / ref_norms.max())
    err_v = float(np.abs(vout.cpu().numpy() - vref).max() / np.abs(vref).max())
    print(f"max rel err: norms {err_n:.2e}, vout {err_v:.2e}")
    if not (err_n < 1e-5 and err_v < 1e-4):
        raise AssertionError("chain probe: MISMATCH")
    out = {"err_norms": err_n, "err_vout": err_v, "us_per_step": None}
    if dev.type == "cuda":
        from .timing import device_ms
        out["us_per_step"] = 1e3 * device_ms(lambda: chain(v0, a), 200) / K
        print(f"{out['us_per_step']:.3f} us per step ({K} steps in one "
              "cluster launch)")
    print("PROBE OK on", dev)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
