"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together (:data:`build_seconds` keeps each one's
time), and linked into one shared library with a
plain C interface, at first use, into this package's build directory
(``_build/``, git-ignored), and bound with ctypes: every pointer and the
stream are ``c_void_p``, every entry point returns ``cudaGetLastError()``
and :func:`check` raises on anything but 0. The library file name carries
a hash of the sources, so an edited source rebuilds.

Nothing here runs at import: :func:`lib` builds on its first call, which
only a kernel wrapper handed a CUDA tensor makes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
# seconds of each source's nvcc in the last build of this process
build_seconds: Dict[str, float] = {}
# the warning lines each source's nvcc printed in that build (ptxas's C7515,
# wgmma serialized, among them)
build_warnings: Dict[str, list] = {}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = path if path and os.path.exists(path) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def build() -> str:
    """Compile ``csrc/*.cu`` if the hashed library is missing; returns its
    path. Raises with nvcc's output when the build fails."""
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libbs_kernels-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [p for p in srcs if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cus]

    def compile_one(src_obj):
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", src_obj[1],
                              src_obj[0]], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return res.stdout, res.returncode, time.perf_counter() - t0
    with ThreadPoolExecutor(len(cus)) as pool:
        outs = list(pool.map(compile_one, zip(cus, objs)))
    build_seconds.clear()
    build_seconds.update((os.path.basename(p), sec)
                         for p, (_, _, sec) in zip(cus, outs))
    build_warnings.clear()
    build_warnings.update(
        (os.path.basename(p), [ln for ln in out.splitlines()
                               if "warning" in ln.lower()])
        for p, (out, _, _) in zip(cus, outs))
    failed = [f"{os.path.basename(p)} ({rc}):\n{out}"
              for p, (out, rc, _) in zip(cus, outs) if rc != 0]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.tmp", *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stdout}"
                          f"\n{res.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(f"{tmp}.tmp", so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        cdll = ctypes.CDLL(build())
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the chain kernels B2/B3/B4 on the tensor cores (csrc/bs_chain_tc.cu)
        cdll.bs_chain_tc_nblk.restype = i32
        cdll.bs_chain_tc_nblk.argtypes = [i32, i32]
        cdll.bs_chain_tc_tile.restype = i32
        cdll.bs_chain_tc_tile.argtypes = [i32] * 4
        cdll.bs_tridiag_chain_tc.restype = i32
        cdll.bs_tridiag_chain_tc.argtypes = [vp] * 13 + [i32] * 8 + [vp]
        cdll.bs_cheb_chain_tc.restype = i32
        cdll.bs_cheb_chain_tc.argtypes = [vp] * 12 + [f32, f32] + [i32] * 8 \
            + [vp]
        # B4 and its one-product entry
        cdll.bs_gf_tridiag_chain_tc.restype = i32
        cdll.bs_gf_tridiag_chain_tc.argtypes = [vp] * 15 + [i32] * 9 + [vp]
        cdll.bs_hv_tc.restype = i32
        cdll.bs_hv_tc.argtypes = [vp] * 10 + [i32] * 8 + [vp]
        # B1 and B5 (csrc/bs_matvec.cu): the split and the product
        cdll.bs_matvec_nblk.restype = i32
        cdll.bs_matvec_nblk.argtypes = [i32, i32]
        cdll.bs_matvec_tile.restype = i32
        cdll.bs_matvec_tile.argtypes = [i32, i32]
        cdll.bs_split3.restype = i32
        cdll.bs_split3.argtypes = [vp, vp, ctypes.c_long, vp]
        cdll.bs_matvec.restype = i32
        cdll.bs_matvec.argtypes = [vp] * 13 + [f32] + [vp] * 7 + [i32] * 9 \
            + [vp]
        # the experiment probes' kernels (experiments/)
        cdll.chain_probe.restype = i32
        cdll.chain_probe.argtypes = [vp] * 5 + [i32, vp]
        cdll.chain_probe_geometry.restype = i32
        cdll.chain_probe_geometry.argtypes = [vp]
        # (E2, E3: the last pointer counts the kernels a call launched)
        ip = ctypes.POINTER(i32)
        cdll.trim_matvec_nblk.restype = i32
        cdll.trim_matvec_nblk.argtypes = [i32, i32]
        cdll.trim_matvec.restype = i32
        cdll.trim_matvec.argtypes = [vp] * 13 + [i32] + [vp] * 4 + [i32] * 8 \
            + [ip, vp]
        cdll.bd_chain.restype = i32
        cdll.bd_chain.argtypes = [vp] * 17 + [i32] * 9 + [ip, vp]
        _LIB = cdll
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
