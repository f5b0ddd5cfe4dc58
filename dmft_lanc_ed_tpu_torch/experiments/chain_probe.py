"""E1, the chain probe (port of ``experiments/chain_probe.py``).

The JAX probe tests, on the TPU, the Pallas constructs a one-launch chain
needs: scratch persisting over grid steps, a scalar accumulated over grid
steps and async copies. It runs a K-step normalized power chain
y <- A y / |A y| in one ``pallas_call`` and checks it against numpy. On
the card the counterpart of those constructs is a persistent, cooperatively
launched kernel with grid-wide syncs between the steps: ``csrc/
chain_probe.cu`` (the note at its top has the design and what bounds it).

:func:`chain` launches it for a CUDA tensor (or raises) and counts the
launch in :data:`launch_counts`; for a CPU tensor it runs the plain
version :func:`chain_plain`, the same recurrence in PyTorch f32.

    python -m dmft_lanc_ed_tpu_torch.experiments.chain_probe [cuda|cpu]

runs the probe's check and, on the card, prints the time per step.
"""
from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from ..ops.factory import resolve_device

N = 256          # matrix dim (2 row panels of 128)
K = 7            # chain steps
COLS = 128       # vector columns

# kernel launches since the last reset (one per chain call)
launch_counts = {"chain_probe": 0}
# the chain steps those launches ran (a kernel's time is quoted per step)
step_counts = {"chain_probe": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, step_counts):
        for k in counts:
            counts[k] = 0


def chain_plain(v0: torch.Tensor, a: torch.Tensor, kk: int = K
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: kk steps of y = s (A u), s = 1 / |previous y| (1 at
    the start), u the previous y (v0 at the start), in f32 with f64 sums of
    squares. Returns (norms [kk, 1] f32, the last y [n, 128] f32)."""
    s = torch.ones((), dtype=torch.float32, device=v0.device)
    u = v0.float()
    norms = []
    for _ in range(kk):
        u = s * (a.float() @ u)
        nrm = torch.sqrt((u.double() ** 2).sum()).float()
        norms.append(nrm)
        s = 1.0 / nrm
    return torch.stack(norms).reshape(kk, 1), u


def chain(v0: torch.Tensor, a: torch.Tensor, kk: int = K
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1: kk chain steps (the probe's K) from v0 [n, 128] with A [n, n]
    (f32) -> (norms [kk, 1] f32, vout [n, 128] f32, the last unnormalized
    product)."""
    if v0.device.type == "cpu":
        return chain_plain(v0, a, kk)
    if not v0.is_cuda:
        raise ValueError(f"chain: unsupported device {v0.device}")
    n = v0.shape[0]
    if (tuple(v0.shape) != (n, COLS) or tuple(a.shape) != (n, n)
            or n % 32 != 0):
        raise ValueError(f"chain: needs v0 [n, {COLS}] and A [n, n] with n "
                         f"a multiple of 32, got {tuple(v0.shape)}, "
                         f"{tuple(a.shape)}")
    if (v0.dtype != torch.float32 or a.dtype != torch.float32
            or a.device != v0.device):
        raise ValueError("chain: needs f32 tensors on one device")
    from .. import _kernels
    lib = _kernels.lib()
    v0, a = v0.contiguous(), a.contiguous()
    dev = v0.device
    norms = torch.empty(kk, dtype=torch.float32, device=dev)
    vout = torch.empty_like(v0)
    buf = torch.empty((2, n, COLS), dtype=torch.float32, device=dev)
    partials = torch.empty(2 * (n // 32) * (COLS // 32), dtype=torch.float64,
                           device=dev)
    err = lib.chain_probe(v0.data_ptr(), a.data_ptr(), norms.data_ptr(),
                          vout.data_ptr(), buf.data_ptr(),
                          partials.data_ptr(), n, kk,
                          torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "chain_probe")
    launch_counts["chain_probe"] += 1
    step_counts["chain_probe"] += kk
    return norms.reshape(kk, 1), vout


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


def reference(v0: np.ndarray, a: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """The JAX probe's numpy check (f32): (norms [K], the last y)."""
    v = v0.copy()
    ref_norms = []
    for _ in range(K):
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
              "cooperative launch)")
    print("PROBE OK on", dev)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
