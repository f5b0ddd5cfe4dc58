"""Chemical-potential search for fixed density.

Re-design of `ed_search_variable` (ED_AUX_FUNX.f90:325-419): secant-like mu
update driven by a running compressibility estimate chi = dn/dmu, falling back
to fixed steps while chi is unknown; the loop's convergence flag is withheld
until the density is within `nerr`.
"""
from __future__ import annotations

import numpy as np


class DensitySearch:
    RESTART_FILE = "var_compressibility.restart"

    def __init__(self, nread: float, nerr: float = 1e-4, ndelta: float = 0.1,
                 workdir: str = "."):
        self.nread = nread
        self.nerr = nerr
        self.ndelta = ndelta
        self._prev_mu = None
        self._prev_n = None
        self.workdir = workdir
        self._load()

    def _load(self):
        import os
        path = os.path.join(self.workdir, self.RESTART_FILE)
        if os.path.exists(path):
            try:
                vals = [float(x) for x in open(path).read().split()]
                if len(vals) >= 3:
                    self._prev_mu, self._prev_n, self.ndelta = vals[:3]
            except (ValueError, OSError):
                pass

    def save(self):
        import os
        path = os.path.join(self.workdir, self.RESTART_FILE)
        if self._prev_mu is not None:
            with open(path, "w") as fh:
                fh.write(f"{self._prev_mu} {self._prev_n} {self.ndelta}\n")

    def update(self, xmu: float, dens: float, converged: bool):
        """Returns (new_xmu, still_converged)."""
        err = dens - self.nread
        if abs(err) <= self.nerr:
            return xmu, converged
        if self._prev_mu is not None and abs(dens - self._prev_n) > 1e-12:
            chi = (dens - self._prev_n) / (xmu - self._prev_mu + 1e-300)
            if chi > 1e-4:           # physical compressibility
                step = -err / chi
                step = np.clip(step, -abs(self.ndelta), abs(self.ndelta))
            else:
                step = -np.sign(err) * self.ndelta
        else:
            step = -np.sign(err) * self.ndelta
        self._prev_mu, self._prev_n = xmu, dens
        self.save()
        return xmu + step, False
