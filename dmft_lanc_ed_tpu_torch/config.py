"""Solver configuration.

Copied from ``dmft_lanc_ed_tpu/config.py`` with the same fields, defaults
and checks, so reference input files run unchanged (reference input system
ED_INPUT_VARS.f90:13-236): the full solver configuration is a single frozen
dataclass. In this package ``ed_backend="pallas"`` keeps its name and means
the band-sparse backend with the hand-written CUDA chain kernels
(ops/bs_chain.py); ``ed_precision="auto"`` and ``ed_backend="auto"``
resolve by the device the solver runs on (ops/factory.py).

Parsing compatibility: :func:`read_input` understands the reference's
``inputED.conf`` key=value format (SciFortran SF_PARSE_INPUT style), including
comma-separated arrays and Fortran logicals (T/F/.true./.false.), plus
command-line style ``NAME=value`` overrides. :func:`save_used_input` mirrors
``print_input``/``save_input`` (used.<file> echo).
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

MAX_ORB = 5  # reference caps Norb at 5 (Uloc/g_ph are dimension(5) arrays)


def _tuple5(x) -> Tuple[float, float, float, float, float]:
    vals = list(x)[:MAX_ORB]
    vals += [0.0] * (MAX_ORB - len(vals))
    return tuple(float(v) for v in vals)


@dataclass(frozen=True)
class EDConfig:
    """All solver input variables (defaults match ED_INPUT_VARS.f90:129-208)."""

    # --- problem size -----------------------------------------------------
    norb: int = 1          # NORB: impurity orbitals (max 5)
    nbath: int = 6         # NBATH: bath sites (per-orb for normal, total for hybrid, replicas for replica)
    nspin: int = 1         # NSPIN: spin degeneracy (max 2)
    nph: int = 0           # NPH: phonon cutoff (DimPh = nph+1)

    # --- interaction ------------------------------------------------------
    uloc: Tuple[float, ...] = (2.0, 0.0, 0.0, 0.0, 0.0)  # ULOC per orbital
    ust: float = 0.0       # UST inter-orbital density-density
    jh: float = 0.0        # JH Hund coupling
    jx: float = 0.0        # JX spin-exchange
    jp: float = 0.0        # JP pair-hopping
    beta: float = 1000.0   # BETA inverse temperature (IR cutoff at T=0)
    xmu: float = 0.0       # XMU chemical potential (0 = half filling when hfmode)
    g_ph: Tuple[float, ...] = (0.0,) * 5  # G_PH e-ph coupling per orbital
    w0_ph: float = 0.0     # W0_PH phonon frequency
    hfmode: bool = True    # HFMODE: U(n-1/2)(n-1/2) Hartree-shifted form

    # --- dmft loop --------------------------------------------------------
    nloop: int = 100
    dmft_error: float = 1e-5
    nsuccess: int = 1
    sb_field: float = 0.1
    nread: float = 0.0
    nerr: float = 1e-4
    ndelta: float = 0.1
    ncoeff: float = 1.0

    # --- diagonalization --------------------------------------------------
    ed_diag_type: str = "lanc"     # lanc | full
    ed_finite_temp: bool = False
    ed_twin: bool = False
    ed_sectors: bool = False
    ed_sectors_shift: int = 1
    ed_sparse_h: bool = True       # stored factors vs matrix-free HxV
    ed_total_ud: bool = True       # total (Nup,Ndw) vs per-orbital QNs
    ed_solve_offdiag_gf: bool = False
    ed_print_sigma: bool = True
    ed_print_g: bool = True
    ed_print_g0: bool = True
    ed_verbose: int = 3

    lanc_method: str = "arpack"    # arpack (thick-restart here) | lanczos
    lanc_nstates_sector: int = 2
    lanc_nstates_total: int = 1
    lanc_nstates_step: int = 2
    lanc_ncv_factor: int = 10
    lanc_ncv_add: int = 0
    lanc_niter: int = 512
    lanc_ngfiter: int = 200
    lanc_tolerance: float = 1e-18
    lanc_dim_threshold: int = 1024

    # --- frequency grids --------------------------------------------------
    lmats: int = 5000
    lreal: int = 5000
    ltau: int = 1000
    lfit: int = 1000
    lpos: int = 100
    wini: float = -5.0
    wfin: float = 5.0
    xmin: float = -3.0
    xmax: float = 3.0
    eps: float = 0.01      # real-axis broadening
    cutoff: float = 1e-9   # spectral summation cutoff
    gs_threshold: float = 1e-9
    hwband: float = 2.0    # bath init half-bandwidth

    # --- susceptibilities -------------------------------------------------
    chispin_flag: bool = False
    chidens_flag: bool = False
    chipair_flag: bool = False
    chiexct_flag: bool = False

    # --- chi2 fit ---------------------------------------------------------
    cg_method: int = 0
    cg_grad: int = 0
    cg_ftol: float = 1e-5
    cg_stop: int = 0
    cg_niter: int = 500
    cg_weight: int = 1     # 1=1, 2=1/n, 3=1/w_n
    cg_scheme: str = "weiss"  # weiss | delta
    cg_pow: int = 2
    cg_minimize_ver: bool = False
    cg_minimize_hh: float = 1e-4

    # --- bath -------------------------------------------------------------
    bath_type: str = "normal"  # normal | hybrid | replica
    hfile: str = "hamiltonian"
    hlocfile: str = "inputHLOC.in"
    logfile: Optional[str] = None  # None = stdout

    # --- runtime extensions (no reference analogue) -----------------------
    ed_dtype: str = "float64"      # compute dtype for the ED core
    ed_backend: str = "auto"       # auto | ell | direct | dense | pallas
    # matmul precision of the dense/pallas backends:
    #   f64   — exact f64 matmuls
    #   mixed — true-f32 matmuls (TF32 off, ~1e-7 matvec error) + automatic
    #           f64 Rayleigh-Ritz polish of eigenpairs
    #   fast  — accepted for input compatibility; the port runs it as mixed
    ed_precision: str = "auto"
    mesh_shape: Tuple[int, ...] = ()  # device mesh for sharded sector matvec
    # sectors with dim_dw >= ed_shard_min_dimdw run the dw-sharded matvec
    # when a mesh is configured (below it, sharding overhead dominates)
    ed_shard_min_dimdw: int = 64
    # batch same-shape-bucket small sectors into one vmapped Krylov solve
    # (replaces the reference's strictly serial sector scan, ED_DIAG.f90:58).
    # Applied for ed_backend auto/dense/pallas; explicit ell/direct runs
    # serial so backend cross-checks exercise the chosen kernel.
    ed_batch_sectors: bool = True
    ed_batch_dim_max: int = 1 << 16   # largest flat dim eligible for batching
    # GF continued-fraction chains run through the f32 chain kernel
    # (ops/bs_chain.gf_tridiag_batch) for pallas-backend sectors at least
    # this large; below it the batched dense scan runs them. The kernel
    # chain runs its recurrence in f32 and carries ~2e-5 relative GF
    # noise — far below bath-discretization error at this sector scale,
    # but raise this threshold (or set ed_backend=dense) if dmft_error is
    # pushed below 1e-5.
    ed_gf_chain_min_dim: int = 1 << 16
    # pow2 shape-bucketing of GF target-sector operators in the JAX
    # package; accepted for input compatibility, the port does not bucket.
    ed_gf_bucket: str = "auto"     # auto | on | off

    # ----------------------------------------------------------------------
    def __post_init__(self):
        object.__setattr__(self, "uloc", _tuple5(self.uloc))
        object.__setattr__(self, "g_ph", _tuple5(self.g_ph))
        # reference fixups (ED_SETUP.f90 ed_checks_global / ED_INPUT_VARS):
        object.__setattr__(self, "ltau", max(int(self.beta), self.ltau))
        object.__setattr__(self, "lfit", min(self.lfit, self.lmats))
        if self.norb > MAX_ORB:
            raise ValueError(f"norb={self.norb} exceeds max {MAX_ORB}")
        if self.nspin > 2:
            raise ValueError("nspin must be 1 or 2")
        if self.bath_type not in ("normal", "hybrid", "replica"):
            raise ValueError(f"unknown bath_type {self.bath_type!r}")
        if self.ed_diag_type not in ("lanc", "full"):
            raise ValueError(f"unknown ed_diag_type {self.ed_diag_type!r}")
        if self.ed_backend not in ("auto", "ell", "direct", "dense", "pallas"):
            raise ValueError(f"unknown ed_backend {self.ed_backend!r}")
        if self.ed_precision not in ("auto", "f64", "mixed", "fast"):
            raise ValueError(f"unknown ed_precision {self.ed_precision!r}")
        if self.ed_gf_bucket not in ("auto", "on", "off"):
            raise ValueError(f"unknown ed_gf_bucket {self.ed_gf_bucket!r}")
        if not self.ed_total_ud and (self.jx != 0.0 or self.jp != 0.0):
            raise ValueError("ed_total_ud=False cannot be used with Jx!=0 "
                             "or Jp!=0 (spin-exchange/pair-hopping violate "
                             "per-orbital QNs; ED_SETUP.f90:71)")
        if not self.ed_total_ud and self.bath_type == "hybrid":
            raise ValueError("ed_total_ud=False is incompatible with hybrid bath "
                             "(ED_SETUP.f90 ed_checks_global)")
        if self.ed_finite_temp and self.lanc_nstates_total <= 1:
            raise ValueError("finite T requires lanc_nstates_total > 1")
        # lanc_method parity (ed_checks_global, ED_SETUP.f90:81-87): the
        # plain-Lanczos dial only supports the single-ground-state T=0 mode;
        # arpack -> thick-restart Lanczos (ops/lanczos.py), dvdson -> real
        # diagonally-preconditioned Davidson (ops/davidson.py)
        if self.lanc_method not in ("arpack", "lanczos", "dvdson"):
            raise ValueError(f"unknown lanc_method {self.lanc_method!r}")
        if self.lanc_method == "lanczos":
            if self.lanc_nstates_total > 1:
                raise ValueError("lanc_method=lanczos requires "
                                 "lanc_nstates_total == 1 (T=0)")
            if self.lanc_nstates_sector > 1:
                raise ValueError("lanc_method=lanczos requires "
                                 "lanc_nstates_sector == 1 (T=0)")
        if self.ed_diag_type == "lanc" and not self.ed_finite_temp \
                and self.lanc_nstates_total > 1:
            # reference coerces this back to 1 with a warning
            object.__setattr__(self, "lanc_nstates_total", 1)
        if not self.ed_total_ud and self.ed_solve_offdiag_gf:
            raise ValueError("off-diagonal GF requires ed_total_ud=True "
                             "(mixed operators span per-orbital sectors)")

    # --- derived dimensions (ED_SETUP.f90:113-135) ------------------------
    @property
    def ns(self) -> int:
        """Total number of electronic levels per spin."""
        if self.bath_type in ("normal", "replica"):
            return (self.nbath + 1) * self.norb
        return self.norb + self.nbath  # hybrid

    @property
    def ns_ud(self) -> int:
        return 1 if self.ed_total_ud else self.norb

    @property
    def ns_orb(self) -> int:
        return self.ns if self.ed_total_ud else self.ns // self.norb

    @property
    def dim_ph(self) -> int:
        return self.nph + 1

    @property
    def finite_t(self) -> bool:
        return self.ed_finite_temp

    @property
    def nsectors(self) -> int:
        return ((self.ns_orb + 1) ** 2) ** self.ns_ud

    def replace(self, **kw) -> "EDConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# input-file parsing (reference format compatibility)
# --------------------------------------------------------------------------
_BOOL_RE = re.compile(r"^\.?(t(rue)?|f(alse)?)\.?$", re.I)

_ALIASES = {  # reference NAME -> dataclass field
    "impHfile".upper(): "hlocfile",
}


def _parse_value(field_type, raw: str):
    raw = raw.strip().strip('"').strip("'")
    if raw.lower() in ("none", ""):
        return None
    if field_type is bool or (isinstance(raw, str) and _BOOL_RE.match(raw)):
        return raw.lower().lstrip(".").startswith("t")
    if field_type is int:
        return int(float(raw))
    if field_type is float:
        return float(raw.replace("d", "e").replace("D", "E"))
    if field_type is str:
        return raw
    # tuple of floats
    parts = [p for p in raw.replace(",", " ").split() if p]
    return tuple(float(p.replace("d", "e").replace("D", "E")) for p in parts)


def read_input(path: Optional[str] = None, **overrides) -> EDConfig:
    """Parse a reference-style input file plus keyword overrides.

    Mirrors ``ed_read_input`` (ED_INPUT_VARS.f90:109-236): file values override
    defaults, explicit keyword args (CLI-style) override the file.
    """
    fields = {f.name: f for f in dataclasses.fields(EDConfig)}
    values = {}
    if path and os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.split("!")[0].split("#")[0].strip()
                if not line or "=" not in line:
                    continue
                name, raw = line.split("=", 1)
                name = name.strip().upper()
                name = _ALIASES.get(name, name).lower()
                if name in fields:
                    f = fields[name]
                    ftype = f.type if isinstance(f.type, type) else type(f.default)
                    if isinstance(f.default, tuple):
                        ftype = tuple
                    values[name] = _parse_value(ftype, raw)
    for k, v in overrides.items():
        k = k.lower()
        if k not in fields:
            raise KeyError(f"unknown input variable {k!r}")
        values[k] = v
    cfg = EDConfig(**values)
    # strip restart suffixes like the reference (ED_INPUT_VARS.f90:234-235)
    hfile = cfg.hfile.replace(".restart", "").replace(".ed", "")
    if hfile != cfg.hfile:
        cfg = cfg.replace(hfile=hfile)
    return cfg


def save_used_input(cfg: EDConfig, path: str) -> None:
    """Echo the fully-resolved config, reference 'used.<input>' style."""
    out = os.path.join(os.path.dirname(path) or ".", "used." + os.path.basename(path))
    with open(out, "w") as fh:
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if v is None or (isinstance(v, tuple) and len(v) == 0):
                continue           # unset optionals round-trip as defaults
            if isinstance(v, bool):
                v = "T" if v else "F"
            elif isinstance(v, tuple):
                v = ",".join(str(x) for x in v)
            fh.write(f"{f.name.upper()}={v}\n")
