"""ctypes bindings for the native host-side builder (native/edcore.cpp).

The same C++ source as the JAX package's, compiled at first use into this
package's build directory (``_build/``, git-ignored) — never into
``native/``. Every entry point has a numpy fallback in :mod:`.sectors`, so
the package works without a compiler. Enable/disable via the
DMFT_ED_NATIVE env var (default: use if it builds and loads).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("dmft_lanc_ed_tpu_torch")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "edcore.cpp")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "c++")
    subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DMFT_ED_NATIVE", "1") == "0":
        return None
    so = os.path.join(BUILD_DIR, "libedcore.so")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
        try:
            _build(so)
        except (subprocess.SubprocessError, OSError) as e:
            log.debug("native build failed (%s); using numpy fallback", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.ed_enumerate_states.restype = ctypes.c_int64
    lib.ed_enumerate_states.argtypes = [ctypes.c_int32, ctypes.c_int32, i64p]
    lib.ed_hop_entries.restype = ctypes.c_int64
    lib.ed_hop_entries.argtypes = [i64p, ctypes.c_int64, i32p, i32p, f64p,
                                   ctypes.c_int32, i64p, i64p, f64p]
    _LIB = lib
    return _LIB


def enumerate_states(ns: int, npart: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    from math import comb
    out = np.empty(comb(ns, npart), dtype=np.int64)
    n = lib.ed_enumerate_states(ns, npart, out)
    return out[:n]


def hop_entries_batch(states: np.ndarray, pos_c: np.ndarray,
                      pos_d: np.ndarray, amps: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, dtype=np.int64)
    n = len(states)
    nt = len(pos_c)
    cap = n * max(nt, 1)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float64)
    nnz = lib.ed_hop_entries(states, n,
                             np.ascontiguousarray(pos_c, np.int32),
                             np.ascontiguousarray(pos_d, np.int32),
                             np.ascontiguousarray(amps, np.float64),
                             nt, rows, cols, vals)
    return rows[:nnz], cols[:nnz], vals[:nnz]
