"""The DMFT loop body the window drives, through the port's public calls:

    EDSolver.solve(bath) -> dmft.gloc_dos -> dmft.self_consistency
        -> fit.chi2_fitgf -> dmft.LinearMixer

as ``models/hm_bethe.run_dmft`` and ``models/multiorb_kanamori.run_dmft``
run it, held here so that the window keeps the solver's state from one
iteration to the next. Each iteration leaves a small record: its seconds,
the solve's timings, the scan's lowest energies, the ground-state
sectors, G, Sigma, the Weiss field and the baths, all on the host.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def fill_sector(ns: int, fill: float):
    n = int(round(fill * ns))
    return (n, n)


JITTER = 0.02            # the first bath's jitter, a share of hwband / of V
WARMUP_ITERATIONS = 1


def seeded_bath(init: np.ndarray, norb: int, nbath: int, hwband: float,
                seed: int) -> np.ndarray:
    """The driver's init_bath layout (levels, then hybridizations, one
    spin) moved by a jitter drawn from `seed`: levels by up to JITTER x
    hwband, hybridizations scaled by up to 1 +- JITTER."""
    n = norb * nbath
    out = np.asarray(init, np.float64).copy()
    rng = np.random.default_rng(seed % (1 << 63))
    out[:n] += JITTER * hwband * rng.uniform(-1.0, 1.0, n)
    out[n:2 * n] *= 1.0 + JITTER * rng.uniform(-1.0, 1.0, n)
    return out


def start_bath(config: Dict, traffic: Dict, seed: int) -> np.ndarray:
    """The run's first bath: the port's init_bath layout for the cell's
    configuration (computed on the host), jittered as :func:`seeded_bath`
    says."""
    import dmft_lanc_ed_tpu_torch as pt
    cfg = ed_config(config, traffic)
    init = pt.EDSolver(cfg, device="cpu").init_bath()
    return seeded_bath(init, cfg.norb, cfg.nbath, cfg.hwband, seed)


def ed_config(config: Dict, traffic: Dict):
    """The port's EDConfig of a cell: the configuration's ``ed`` keys with
    the traffic's on top."""
    import dmft_lanc_ed_tpu_torch as pt
    ed = dict(config["ed"])
    ed.update(traffic.get("ed", {}))
    ed["uloc"] = tuple(ed["uloc"])
    return pt.EDConfig(**ed)


def _pair(q) -> tuple:
    return (int(sum(q[0])), int(sum(q[1])))


class Loop:
    """One DMFT run of a cell on `device`: its configuration, solver,
    bath and mixer, and the records of its iterations."""

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device="cuda"):
        import dmft_lanc_ed_tpu_torch as pt
        from dmft_lanc_ed_tpu_torch import dmft
        self.pt = pt
        self.device = device
        self.traffic = traffic
        model = config["model"]
        self.cfg = ed_config(config, traffic)
        norb = self.cfg.norb
        self.ns = norb * (self.cfg.nbath + 1)
        cf = np.asarray(model.get("crystal_field", [0.0] * norb), float)
        self.hloc = np.zeros((self.cfg.nspin, self.cfg.nspin, norb, norb))
        for s in range(self.cfg.nspin):
            self.hloc[s, s] = np.diag(cf)
        self.h0 = cf
        self.ebands, self.dbands, _ = dmft.bethe_bands(
            norb, model["wband"], cf, model["n_energies"])
        self.z = 1j * pt.matsubara_grid(self.cfg)
        self.wmixing = model["wmixing"]
        self.mixer = dmft.LinearMixer(self.wmixing)
        self.solver = None
        self.bath = start_bath(config, traffic, seed)
        self.records: List[Dict] = []
        self.mixes = 0

    def hints(self, fills: Optional[Sequence[float]]):
        if fills is None:
            return None
        return [fill_sector(self.ns, f) for f in fills]

    def new_solver(self, fills: Optional[Sequence[float]]):
        pt = self.pt
        self.solver = pt.EDSolver(self.cfg, self.hloc, device=self.device)
        hints = self.hints(fills)
        if hints is not None:
            self.solver.diag_state.sector_hint = [pt.qn(*h) for h in hints]

    def _sync(self):
        if str(self.device).startswith("cuda"):
            import torch
            torch.cuda.synchronize()

    def iteration(self, spans=None) -> Dict:
        """One loop body; returns (and keeps) its record. `spans`, where
        given, receives (phase, start ns, end ns) on the host clock."""
        from dmft_lanc_ed_tpu_torch import dmft, fit
        from dmft_lanc_ed_tpu_torch.ops import bs_chain
        from dmft_lanc_ed_tpu_torch.ops.lanczos import polish_counts
        cfg = self.cfg
        t0 = time.perf_counter()
        ctl = self.solver.diag_state
        hint = None if not ctl.sector_hint else sorted(
            {_pair(q) for q in ctl.sector_hint})
        bath_in = self.bath.copy()
        polish0 = polish_counts["s"]
        chains0 = len(bs_chain.chains_per_launch["gf_tridiag"])

        def mark(phase, start):
            if spans is not None:
                spans.append((phase, start, time.perf_counter_ns()))
        s = time.perf_counter_ns()
        res = self.solver.solve(self.bath)
        mark("solve", s)
        s = time.perf_counter_ns()
        gloc = dmft.gloc_dos(self.ebands, self.dbands, self.h0,
                             res.sigma_mats, self.z, xmu=cfg.xmu)
        weiss = dmft.self_consistency(gloc, res.sigma_mats, self.hloc,
                                      self.z, sctype=cfg.cg_scheme,
                                      xmu=cfg.xmu)
        mark("self_consistency", s)
        s = time.perf_counter_ns()
        t_fit = time.perf_counter()
        fitted = fit.chi2_fitgf(cfg, weiss, self.bath, self.hloc)
        t_fit = time.perf_counter() - t_fit
        mark("fit", s)
        first_mix = self.mixes == 0
        self.bath = self.mixer(fitted)
        self.mixes += 1
        self._sync()
        wall = time.perf_counter() - t0
        norb = cfg.norb
        diag = lambda x: np.array([x[0, 0, a, a] for a in range(norb)])
        rec = dict(
            wall_s=wall, timings=dict(res.timings), fit_s=t_fit,
            polish_s=polish_counts["s"] - polish0,
            chains=list(bs_chain.chains_per_launch["gf_tridiag"][chains0:]),
            hint=hint,
            sectors={_pair(q): float(np.min(e))
                     for q, e, _ in res.state_list.diag_log},
            ground=sorted({_pair(st.qn) for st in res.state_list.states}),
            g=diag(res.g_mats), sigma=diag(res.sigma_mats),
            weiss=diag(weiss), bath_in=bath_in,
            fitted=np.asarray(fitted, np.float64).copy(),
            bath_out=np.asarray(self.bath, np.float64).copy(),
            first_mix=first_mix)
        self.records.append(rec)
        return rec

    def run_warmup(self):
        t = self.traffic
        fills = t.get("warmup_hint_fill", t.get("hint_fill"))
        self.new_solver(fills)
        for _ in range(WARMUP_ITERATIONS):
            self.iteration()

    def window_iteration(self, spans=None) -> Dict:
        if self.traffic["solver"] == "new":
            self.new_solver(self.traffic.get("hint_fill"))
        return self.iteration(spans)

    def release(self):
        """Drop the solver and its device memory."""
        self.solver = None
        import gc
        gc.collect()
        if str(self.device).startswith("cuda"):
            import torch
            torch.cuda.empty_cache()
