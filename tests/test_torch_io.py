"""PyTorch port, the I/O and restart surface: ``io.py`` against the JAX
package's, ``EDSolver.restore`` and the solve's ``timings["kernel_*"]``.

- the four tests of tests/test_io.py, on the port (its replica case with
  ``dmft/hk.py``);
- every writer, fed the same arrays (the JAX package's solve carried across
  by ``convert.result_from_reference``, one packed bath), writes
  byte-identical files in both packages, ``print_chi`` / ``print_impd``
  too on seeded synthetic susceptibilities;
- each package's own solve plus ``write_all`` gives the same file set,
  field for field;
- files either package wrote are read by the other's readers, and
  restore -> solve gives the same Egs in both;
- the matvec counters against the JAX package's.

Tolerances, each with its origin: Egs 1e-10 (the reference's energy gate),
dens/docc 1e-9, Sigma(iw) and G(iw) 1e-8 (both packages solve on f64
operators: the port's dense backend, the JAX package's ELL), each plus one
unit of the digit a file prints; files written from the same arrays and
restart reads: exact.
"""
import filecmp
import functools
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import io as jio
from dmft_lanc_ed_tpu.dmft import hk as jhk
from dmft_lanc_ed_tpu_torch import io as pio
from dmft_lanc_ed_tpu_torch.convert import result_from_reference
from dmft_lanc_ed_tpu_torch.dmft import hk as phk

_HYB_HLOC = ((0.0, 0.15), (0.15, 0.1))
# solve configurations: a normal bath at T = 0 (Krylov sectors), a hybrid
# bath with an off-diagonal hloc (the off-diagonal GF files), finite T (the
# histogram), a BHZ replica bath (nspin = 2, the replica restart layout)
CASES = {
    "normal": dict(norb=1, nbath=3, uloc=(2.0,), beta=50.0, lmats=64,
                   lreal=16, lanc_dim_threshold=8),
    "hybrid": dict(norb=2, nbath=2, bath_type="hybrid", uloc=(2.0, 2.0),
                   ust=1.0, jh=0.3, beta=50.0, lmats=64, lreal=16,
                   lanc_dim_threshold=64),
    "finite_t": dict(norb=1, nbath=2, uloc=(1.5,), beta=4.0, lmats=16,
                     lreal=9, ed_finite_temp=True, lanc_nstates_total=40,
                     lanc_nstates_sector=10, lanc_dim_threshold=4096),
    "replica": dict(norb=2, nspin=2, nbath=2, bath_type="replica",
                    uloc=(2.0, 2.0), ust=1.0, jh=0.5, beta=50.0, lmats=64,
                    lreal=16, lanc_dim_threshold=64),
}
# tolerance a file's numbers get (beyond one unit of their printed digit)
# when the two packages solve on their own
_FILE_TOL = {"impSigma": 1e-8, "impG0": 1e-12, "impG": 1e-8,
             "observables": 1e-9, "energy": 1e-9, "state_list": 1e-10,
             "eigenvalues_list": 1e-10, "histogram": 0.0,
             "Occupation": 1e-9, "parameters": 0.0, "hamiltonian": 0.0,
             "sectors_list": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The matrices here are small: one torch intra-op thread and one BLAS
    thread are as fast alone and keep parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _model(case):
    """(JAX config, port config, hloc, h_basis, lambda_imp) of a case; the
    port solves on its dense backend (``auto`` is ELL on the CPU, not
    ported), the JAX package on its CPU default."""
    kw = CASES[case]
    cfg_j, cfg_p = ed.EDConfig(**kw), pt.EDConfig(ed_backend="dense", **kw)
    basis = lam = None
    if case == "replica":
        hloc = jhk.hloc_from_hk(jhk.hk_bhz_2d(6), 2, 2)
        basis, lam = ed.decompose_hloc(cfg_j, hloc)
        basis, lam = np.asarray(basis), np.asarray(lam)
    else:
        hloc = np.zeros((1, 1, cfg_j.norb, cfg_j.norb))
        if case == "hybrid":
            hloc[0, 0] = _HYB_HLOC
    return cfg_j, cfg_p, hloc, basis, lam


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    """The JAX package's solve of a case from its initial bath -> (packed
    bath, SolveResult)."""
    cfg_j, _, hloc, basis, lam = _model(case)
    s = ed.EDSolver(cfg_j, hloc, h_basis=basis, lambda_imp=lam)
    bath = np.asarray(s.init_bath())
    return bath, s.solve(bath)


def _port_solver(case, cfg=None):
    _, cfg_p, hloc, basis, lam = _model(case)
    return pt.EDSolver(cfg or cfg_p, hloc, h_basis=basis, lambda_imp=lam,
                       device="cpu")


def _tokens(path):
    return [ln.replace("[", " ").replace("]", " ").split()
            for ln in open(path).read().splitlines()]


def _assert_same_fields(path_a, path_b, tol):
    """Two files equal token by token: words exactly, numbers within
    `tol` plus one unit of the last digit printed."""
    ta, tb = _tokens(path_a), _tokens(path_b)
    assert len(ta) == len(tb), path_a
    for la, lb in zip(ta, tb):
        assert len(la) == len(lb), (path_a, la, lb)
        for a, b in zip(la, lb):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (path_a, a, b)
                continue
            mant = a.lower().split("e")[0]
            ulp = 10.0 ** -len(mant.split(".")[1]) if "." in mant else 0.0
            if "e" in a.lower():
                ulp *= 10.0 ** int(a.lower().split("e")[1])
            assert abs(fa - fb) <= tol + ulp * (1 + 1e-9), (path_a, a, b)


# --------------------------------------------------------------------------
# tests/test_io.py, on the port
# --------------------------------------------------------------------------
def test_gf_file_roundtrip(tmp_path):
    cfg = pt.EDConfig(norb=1, nbath=2, uloc=(1.2,), lmats=32, lreal=16,
                      ed_backend="dense")
    solver = pt.EDSolver(cfg, np.zeros((1, 1, 1, 1)), device="cpu")
    res = solver.solve(solver.init_bath())
    pio.print_impsigma(cfg, res, outdir=str(tmp_path))
    back = pio.read_gf_files(cfg, "impSigma", outdir=str(tmp_path),
                             axis="iw")
    np.testing.assert_allclose(back[0, 0, 0, 0], res.sigma_mats[0, 0, 0, 0],
                               atol=1e-8)


def test_input_file_roundtrip(tmp_path):
    path = os.path.join(str(tmp_path), "inputED.conf")
    with open(path, "w") as fh:
        fh.write("NORB=2\nNBATH=3\nULOC=1.5,2.5\nBETA=77\nED_TWIN=T\n"
                 "CG_SCHEME=delta\n")
    cfg = pt.read_input(path)
    assert cfg.norb == 2 and cfg.nbath == 3 and cfg.ed_twin
    assert cfg.uloc[:2] == (1.5, 2.5) and cfg.beta == 77.0
    assert cfg.cg_scheme == "delta"
    pt.save_used_input(cfg, path)
    assert os.path.exists(os.path.join(str(tmp_path), "used.inputED.conf"))
    cfg2 = pt.read_input(os.path.join(str(tmp_path), "used.inputED.conf"))
    assert cfg2 == cfg


def test_eigenvalues_list_and_histogram_files(tmp_path):
    """eigenvalues_list.ed (per-sector appended spectra) and the finite-T
    histogram_states.ed (ED_DIAG.f90:265-270,530-546), and the reference
    test's last check: the direct operator's nonzero count is set (its
    kernel_stats observability) and equals the JAX package's."""
    cfg = pt.EDConfig(ed_backend="dense", **CASES["finite_t"])
    s = pt.EDSolver(cfg, np.zeros((1, 1, 1, 1)), device="cpu")
    res = s.solve(s.init_bath())
    pio.write_all(cfg, res, s.init_bath(), outdir=str(tmp_path))

    ev = (tmp_path / "eigenvalues_list.ed").read_text().strip().split("\n\n")
    table = pt.SectorTable(cfg)
    assert len(ev) == len(table.all_qns())
    first = ev[0].splitlines()
    assert first[0].lstrip().startswith("#")
    assert int(first[1].split()[0]) == 1
    float(first[2])

    hist = np.loadtxt(tmp_path / "histogram_states.ed")
    assert hist.shape == (len(table.all_qns()), 3)
    assert hist[:, 2].sum() == res.state_list.size

    from dmft_lanc_ed_tpu.ops.direct import build_direct_op as j_direct
    from dmft_lanc_ed_tpu_torch.ops.direct import build_direct_op
    hloc = np.zeros((1, 1, 1, 1))
    op = build_direct_op(cfg, table.sector(pt.qn(1, 1)), hloc,
                         pt.init_bath(cfg), "cpu")
    cfg_j = ed.EDConfig(ed_backend="dense", **CASES["finite_t"])
    op_j = j_direct(cfg_j, ed.SectorTable(cfg_j).sector(ed.qn(1, 1)), hloc,
                    ed.init_bath(cfg_j))
    assert op.nnz == op_j.nnz > 0


def test_bath_restart_roundtrip_all_topologies(tmp_path):
    """save_bath -> read_bath_restart returns the identical packed bath for
    normal, hybrid and replica topologies."""
    rng = np.random.default_rng(7)
    for bath_type in ("normal", "hybrid"):
        cfg = pt.EDConfig(norb=2, nspin=2, nbath=3, uloc=(1.0, 1.0),
                          bath_type=bath_type)
        solver = pt.EDSolver(cfg, np.zeros((2, 2, 2, 2)), device="cpu")
        b0 = solver.init_bath()
        b0 = b0 + 0.01 * rng.standard_normal(b0.shape)
        pio.save_bath(cfg, b0, outdir=str(tmp_path))
        b1 = pio.read_bath_restart(cfg, outdir=str(tmp_path))
        np.testing.assert_allclose(b1, b0, atol=1e-10, err_msg=bath_type)

    cfg = pt.EDConfig(norb=2, nspin=2, nbath=4, uloc=(1.0, 1.0),
                      bath_type="replica")
    hloc = phk.hloc_from_hk(phk.hk_bhz_2d(6, m0=1.0, lam=0.3, t=0.5),
                            cfg.nspin, cfg.norb)
    h_basis, lambda_imp = pt.decompose_hloc(cfg, hloc)
    solver = pt.EDSolver(cfg, hloc, h_basis=h_basis, lambda_imp=lambda_imp,
                         device="cpu")
    u0 = pt.unpack_bath(cfg, solver.init_bath())
    # perturb the physical dials (lambda, V); the packed N_dec header slots
    # are structural and rewritten canonically by save/read
    b0 = pt.pack_bath(cfg, pt.Bath(
        lam=u0.lam + 0.01 * rng.standard_normal(u0.lam.shape),
        v_rep=u0.v_rep + 0.01 * rng.standard_normal(u0.v_rep.shape)))
    pio.save_bath(cfg, b0, outdir=str(tmp_path))
    b1 = pio.read_bath_restart(cfg, outdir=str(tmp_path))
    np.testing.assert_allclose(b1, b0, atol=1e-10, err_msg="replica")


# --------------------------------------------------------------------------
# the same arrays -> byte-identical files
# --------------------------------------------------------------------------
def _dirs(tmp_path):
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dp.mkdir()
    return str(dj), str(dp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_writers_byte_identical(case, tmp_path):
    """write_all (every writer it calls) from the JAX package's solve,
    carried to the port's SolveResult, with one packed bath: the same
    files, byte for byte."""
    cfg_j, cfg_p, _, _, _ = _model(case)
    bath, res_j = _jax_solve(case)
    res_p = result_from_reference(res_j)
    dj, dp = _dirs(tmp_path)
    jio.write_all(cfg_j, res_j, bath, outdir=dj)
    pio.write_all(cfg_p, res_p, bath, outdir=dp)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dp))
    assert {"observables_last.ed", "state_list.ed", "hamiltonian.restart",
            "impSigma_l11_s1_iw.ed"} <= set(names)
    if case in ("hybrid", "replica"):
        assert "impG_l12_s1_iw.ed" in names
    if case == "finite_t":
        assert "histogram_states.ed" in names
    match, mismatch, errors = filecmp.cmpfiles(dj, dp, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


class _SyntheticChi:
    """Seeded arrays behind the susceptibility interface the writers read
    (``matsubara``, ``imtime``, ``realaxis``): the writers alone, apart
    from chi.py (whose files test_torch_chi.py holds)."""

    def __init__(self, cfg, seed):
        rng = np.random.default_rng(seed)

        def c(n):
            return rng.standard_normal(n) + 1j * rng.standard_normal(n)
        self.mats, self.tau = c(cfg.lmats), rng.standard_normal(cfg.ltau)
        self.real = c(cfg.lreal)

    def matsubara(self, beta, vm):
        return self.mats[:len(vm)]

    def imtime(self, tau):
        return self.tau[:len(tau)]

    def realaxis(self, beta, wr, eps):
        return self.real[:len(wr)]


def test_print_chi_and_impd_byte_identical(tmp_path):
    kw = dict(norb=2, nbath=2, beta=20.0, lmats=32, lreal=16, ltau=25)
    cfg_j, cfg_p = ed.EDConfig(**kw), pt.EDConfig(**kw)
    chis = {(0, 0): _SyntheticChi(cfg_j, 1), (0, 1): _SyntheticChi(cfg_j, 2),
            (-1, -1): _SyntheticChi(cfg_j, 3)}
    dph = _SyntheticChi(cfg_j, 4)
    dj, dp = _dirs(tmp_path)
    for mod, cfg, d in ((jio, cfg_j, dj), (pio, cfg_p, dp)):
        mod.print_chi(cfg, chis, "spin", d, "_x")
        mod.print_chi(cfg, chis, "dens", d)
        mod.print_impd(cfg, dph, d)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dp)) and len(names) == 20
    assert "spinChi_ltot_tau_x.ed" in names and "impDph_iv.ed" in names
    _, mismatch, errors = filecmp.cmpfiles(dj, dp, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


# --------------------------------------------------------------------------
# each package's own solve
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["normal", "hybrid", "finite_t"])
def test_write_all_end_to_end_matches_reference(case, tmp_path):
    """Each package's own solve of the same bath plus write_all: the same
    file set, field for field (tolerances by file, module docstring)."""
    cfg_j, cfg_p, _, _, _ = _model(case)
    bath, res_j = _jax_solve(case)
    res_p = _port_solver(case).solve(bath)
    assert abs(res_p.observables.egs - res_j.observables.egs) <= 1e-10
    dj, dp = _dirs(tmp_path)
    jio.write_all(cfg_j, res_j, bath, outdir=dj)
    pio.write_all(cfg_p, res_p, bath, outdir=dp)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dp))
    for name in names:
        tol = next(v for k, v in _FILE_TOL.items() if name.startswith(k))
        _assert_same_fields(os.path.join(dj, name), os.path.join(dp, name),
                            tol)


@pytest.mark.parametrize("case", ["normal", "replica"])
def test_restart_cross_reads_and_restore(case, tmp_path):
    """Files the JAX package wrote, read by the port's readers, and the
    other way round; then restore -> solve in both packages from the
    other's directory, with the sector restriction the restart carries
    (ed_sectors): the same Egs."""
    cfg_j, cfg_p, hloc, basis, lam = _model(case)
    bath, res_j = _jax_solve(case)
    dj, dp = _dirs(tmp_path)
    jio.write_all(cfg_j, res_j, bath, outdir=dj)
    pio.write_all(cfg_p, result_from_reference(res_j), bath, outdir=dp)
    for src, dst in ((dj, dp), (dp, dj)):
        b_p = pio.read_bath_restart(cfg_p, outdir=src)
        b_j = np.asarray(jio.read_bath_restart(cfg_j, outdir=src))
        assert b_p.tobytes() == b_j.tobytes()
        np.testing.assert_allclose(b_p, bath, atol=1e-11)
        c_p = pio.read_state_list_restart(cfg_p, outdir=src)
        c_j = jio.read_state_list_restart(cfg_j, outdir=src)
        assert c_p.neigen_sector == c_j.neigen_sector
        assert c_p.sector_hint == c_j.sector_hint
        assert c_p.lanc_nstates_total == c_j.lanc_nstates_total
        for prefix in ("impSigma", "impG", "impG0"):
            for axis in ("iw", "realw"):
                g_p = pio.read_gf_files(cfg_p, prefix, outdir=src, axis=axis)
                g_j = jio.read_gf_files(cfg_j, prefix, outdir=src, axis=axis)
                assert np.array_equal(g_p, g_j)
    np.testing.assert_allclose(
        pio.read_gf_files(cfg_p, outdir=dj), res_j.sigma_mats, atol=1e-8)

    egs = res_j.observables.egs
    kw = dict(ed_sectors=True, ed_sectors_shift=0)
    s_p = _port_solver(case, cfg_p.replace(**kw))
    s_j = ed.EDSolver(cfg_j.replace(**kw), hloc, h_basis=basis,
                      lambda_imp=lam)
    b_p, b_j = s_p.restore(dj), s_j.restore(dp)
    assert s_p.diag_state.sector_hint == res_j.state_list.\
        sectors_contributing()
    r_p, r_j = s_p.solve(b_p), s_j.solve(np.asarray(b_j))
    assert abs(r_p.observables.egs - r_j.observables.egs) <= 1e-10
    assert abs(r_p.observables.egs - egs) <= 1e-10
    # the restriction held: only the restart's sectors were scanned
    assert {q for q, _, _ in r_p.state_list.diag_log} == \
        set(res_j.state_list.sectors_contributing())
    assert s_p.restore(str(tmp_path / "nowhere")) is None


# --------------------------------------------------------------------------
# the solve's kernel counters
# --------------------------------------------------------------------------
@pytest.mark.parametrize("nbath,threshold", [(2, 4), (3, 30)])
def test_kernel_counters_match_reference(nbath, threshold):
    """Sectors one by one on f64 operators, every Krylov sector at most as
    large as the thick-restart basis (m = dim: one basis build each) and
    every GF chain m = min(dim, lanc_ngfiter) long: the same algorithm in
    both packages, so the same matvecs and nonzeros applied."""
    kw = dict(norb=1, nbath=nbath, uloc=(2.0,), lmats=32, lreal=16,
              lanc_dim_threshold=threshold, ed_batch_sectors=False)
    s_j = ed.EDSolver(ed.EDConfig(**kw), np.zeros((1, 1, 1, 1)))
    t_j = s_j.solve(s_j.init_bath()).timings
    s_p = pt.EDSolver(pt.EDConfig(ed_backend="dense", **kw), device="cpu")
    t_p = s_p.solve(s_p.init_bath()).timings
    assert t_p["kernel_matvecs"] == t_j["kernel_matvecs"] > 0
    assert t_p["kernel_nnz_applied"] == t_j["kernel_nnz_applied"] > 0
    # reset per solve: a second solve counts the same
    assert s_p.solve(s_p.init_bath()).timings["kernel_matvecs"] == \
        t_p["kernel_matvecs"]
    assert t_p["kernel_matvecs_per_s"] > 0


def test_kernel_counters_thick_restart_and_batched():
    """Where the packages cannot run the same algorithm the counts differ,
    by this much and for these reasons:
    - thick restarts (sectors larger than the basis): the start vectors
      differ (JAX's PRNG, numpy's here), so the restarts to convergence
      differ: within 10 % (334 against 320 matvecs measured);
    - batched buckets: the JAX package pads each bucket to a fixed batch
      with dummy sectors and pins the first restart's Ritz prefix (568
      against 346 matvecs in this solve with ``ed_batch_sectors``); the
      port counts the matvecs its real sectors run, b (m - l) a restart
      with l = 0 on the first, checked here on one bucket."""
    from dmft_lanc_ed_tpu_torch.ops import batched as bt
    from dmft_lanc_ed_tpu_torch.ops.dense import build_dense_op
    from dmft_lanc_ed_tpu_torch.utils import kernel_stats
    kw = dict(norb=1, nbath=3, uloc=(2.0,), lmats=32, lreal=16,
              lanc_dim_threshold=4, ed_batch_sectors=False)
    s_j = ed.EDSolver(ed.EDConfig(**kw), np.zeros((1, 1, 1, 1)))
    t_j = s_j.solve(s_j.init_bath()).timings
    s_p = pt.EDSolver(pt.EDConfig(ed_backend="dense", **kw), device="cpu")
    t_p = s_p.solve(s_p.init_bath()).timings
    assert abs(t_p["kernel_matvecs"] / t_j["kernel_matvecs"] - 1) <= 0.1

    cfg = pt.EDConfig(norb=1, nbath=5, uloc=(2.0,))
    table, bath = pt.SectorTable(cfg), pt.init_bath(cfg)
    ops = [build_dense_op(cfg, table.sector(pt.qn(*q)),
                          np.zeros((1, 1, 1, 1)), bath, "cpu")
           for q in ((2, 2), (4, 4), (2, 4))]       # 15 x 15 states each
    m, neigen = 32, 2
    l_keep = min(max(2 * neigen, neigen + 4), m - 4)
    bt.reset_bucket_counts()
    kernel_stats.reset()
    sols = bt.lanczos_ground_state_bucket(ops, neigen, tol=1e-12, ncv=m)
    restarts = bt.bucket_counts["restarts"]
    assert all(s is not None for s in sols) and restarts > 1
    b = len(ops)
    assert kernel_stats.matvecs == b * m + b * (m - l_keep) * (restarts - 1)
    assert kernel_stats.nnz_applied == kernel_stats.matvecs * (
        sum(o.nnz for o in ops) // b)
