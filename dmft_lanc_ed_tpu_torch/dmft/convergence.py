"""Convergence check (DMFT_Tools check_convergence analogue).

err = sum_n |F_n - F_n_prev| / sum_n |F_n|, converged after `nsuccess`
consecutive iterations below threshold.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ConvergenceCheck:
    def __init__(self, threshold: float, nsuccess: int = 1,
                 max_iter: int = 100):
        self.threshold = threshold
        self.nsuccess = nsuccess
        self.max_iter = max_iter
        self._prev: Optional[np.ndarray] = None
        self._streak = 0
        self.iteration = 0
        self.error = np.inf

    def __call__(self, f: np.ndarray) -> bool:
        f = np.asarray(f)
        self.iteration += 1
        if self._prev is None:
            self._prev = f.copy()
            self.error = np.inf
            return False
        num = np.abs(f - self._prev).sum()
        den = np.abs(f).sum()
        self.error = float(num / max(den, 1e-300))
        self._prev = f.copy()
        if self.error < self.threshold:
            self._streak += 1
        else:
            self._streak = 0
        converged = self._streak >= self.nsuccess
        return converged or self.iteration >= self.max_iter
