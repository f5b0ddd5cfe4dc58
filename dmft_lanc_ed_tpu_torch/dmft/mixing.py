"""Bath / Weiss mixing: linear and Broyden (edn_hm_bethe_broyden analogue)."""
from __future__ import annotations

from typing import Optional

import numpy as np


class LinearMixer:
    """x <- alpha x_new + (1-alpha) x_old (driver wmixing)."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self._prev: Optional[np.ndarray] = None

    def __call__(self, x_new: np.ndarray) -> np.ndarray:
        x_new = np.asarray(x_new, dtype=np.float64)
        if self._prev is None:
            self._prev = x_new.copy()
            return x_new
        mixed = self.alpha * x_new + (1.0 - self.alpha) * self._prev
        self._prev = mixed.copy()
        return mixed


class BroydenMixer:
    """Modified (good) Broyden mixing on the fixed-point residual.

    Standard Broyden second method as used for DMFT bath acceleration
    (drivers/edn_hm_bethe_broyden.f90 capability).
    """

    def __init__(self, alpha: float = 0.5, history: int = 8):
        self.alpha = alpha
        self.history = history
        self._x: Optional[np.ndarray] = None
        self._f: Optional[np.ndarray] = None
        self._dx = []
        self._df = []

    def __call__(self, x_new: np.ndarray) -> np.ndarray:
        x_new = np.asarray(x_new, dtype=np.float64)
        if self._x is None:
            self._x = x_new.copy()
            return x_new
        f = x_new - self._x          # residual of the fixed-point map
        if self._f is not None:
            self._dx.append(self._x - self._x_prev)
            self._df.append(f - self._f)
            if len(self._dx) > self.history:
                self._dx.pop(0)
                self._df.pop(0)
        self._x_prev = self._x.copy()
        self._f = f.copy()
        if not self._df:
            x = self._x + self.alpha * f
        else:
            dfm = np.stack(self._df)           # [m, n]
            dxm = np.stack(self._dx)
            # solve least squares for Broyden update
            a = dfm @ dfm.T
            b = dfm @ f
            try:
                gamma = np.linalg.solve(a + 1e-12 * np.eye(len(b)), b)
            except np.linalg.LinAlgError:
                gamma = np.zeros(len(b))
            update = self.alpha * f - gamma @ (dxm + self.alpha * dfm)
            x = self._x + update
        self._x = x.copy()
        return x
