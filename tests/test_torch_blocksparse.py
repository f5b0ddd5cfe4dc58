"""PyTorch port, the per-call band-sparse matvec B1 (ops/blocksparse.py)
against the JAX package on CPU: the port runs the kernel's plain version
(CPU tensors), the JAX package its Pallas kernels B1a (`_runs_kernel`) and
B1b (`_fused_kernel`) in interpret mode, from the same numpy inputs.

Tolerances, each with its origin:
- zero-tile runs: exact (the same numpy on the same f32 slabs);
- plain B1 vs the JAX kernels: 2e-5 x max|y|, the JAX kernels' split-bf16
  contract (~1.5e-5 per matvec, blocksparse.py:12-18); per-panel sums of
  squares 1e-4 relative (the same error, squared terms);
- plain B1 vs the f64 apply: 1e-6 x max|y|, and within 2x the error of
  the true-f32 dense product (six passes over three-part splits: f32
  grade, the kernel's contract);
- runs-aware slab apply: bit-equal to the whole-window one (skipped tiles
  are exact zeros) and 1e-5 x max|y| of the dense padded apply, the slab
  windows' bound of test_torch_bs_chain.py; the same in the kernel's
  six-pass form with each 64-deep stage summed apart (a skipped stage adds
  an exact zero to an f32 sum), and 1e-6 x max|y| of the plain B1;
- the split: the parts torch's split gives, bit for bit;
- per-call two-stage ground state: 1e-10 to the JAX package's same call
  and to numpy eigh (the f64 polish gate, bench.py:51).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.bath import Bath as JBath
from dmft_lanc_ed_tpu.diag import _blocksparse_ground_state as jax_two_stage
from dmft_lanc_ed_tpu.ops import blocksparse as jbs
from dmft_lanc_ed_tpu.ops.matvec import apply_h
from dmft_lanc_ed_tpu_torch.convert import hamiltonian_from_reference
from dmft_lanc_ed_tpu_torch.diag import _blocksparse_ground_state
from dmft_lanc_ed_tpu_torch.ops import blocksparse as pbs
from dmft_lanc_ed_tpu_torch.ops.bf16x3 import dot6_plain, split3_bf16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(kw, sqn, seed=0, bath="random"):
    """(JAX cfg, port cfg, sector, JAX Hamiltonian, JAX op, port op); the
    bath is test_pallas.py's random one or the default; the port's
    Hamiltonian is the JAX one carried across by convert.py."""
    cfg_j, cfg_p = ed.read_input(None, **kw), pt.read_input(None, **kw)
    if bath == "random":
        rng = np.random.default_rng(seed)
        shape = (1, cfg_j.norb, cfg_j.nbath)
        b = JBath(e=jnp.asarray(rng.normal(size=shape)),
                  v=jnp.asarray(rng.normal(size=shape) * 0.5))
    else:
        b = ed.init_bath(cfg_j)
    sec = ed.SectorTable(cfg_j).sector(sqn)
    hloc = np.zeros((1, 1, cfg_j.norb, cfg_j.norb))
    h_j = ed.build_sector_hamiltonian(cfg_j, sec, hloc, b)
    h_p = hamiltonian_from_reference(
        {f.name: getattr(h_j, f.name) for f in dataclasses.fields(h_j)})
    return (cfg_j, cfg_p, sec, h_j, jbs.build_blocksparse_op(h_j),
            pbs.build_blocksparse_op(h_p, "cpu"))


NB5 = dict(norb=1, nbath=5, uloc=(1.8,))
NORB2 = dict(norb=2, nbath=2, uloc=(1.0, 1.5), ust=0.3, jh=0.05)
SECTORS = [(NB5, ((3,), (3,)), 0), (NB5, ((2,), (4,)), 0),
           (NORB2, ((3,), (2,)), 3)]


def _runs_from_tables(ptr, tab):
    ptr, tab = ptr.tolist(), tab.tolist()
    return tuple(tuple(tuple(t) for t in tab[ptr[p]:ptr[p + 1]])
                 for p in range(len(ptr) - 1))


@pytest.mark.parametrize("kw,sqn,seed", SECTORS)
def test_trim_runs_equal_reference(kw, sqn, seed):
    *_, op_j, op_p = _both(kw, sqn, seed)
    assert op_p.pop.trim_runs == op_j.pop._trim_runs
    pop = op_p.pop
    dw_ptr, dw_tab, up_ptr, up_tab = pop.runs_trim
    assert (_runs_from_tables(dw_ptr, dw_tab),
            _runs_from_tables(up_ptr, up_tab)) == pop.trim_runs
    assert dw_ptr.dtype == torch.int32 and dw_tab.dtype == torch.int32
    # the whole-window tables the kernel reads for B1b: one run per panel
    ddp, dup = pop.padded_shape
    dw_ptr, dw_tab, up_ptr, up_tab = pop.runs_full
    assert _runs_from_tables(dw_ptr, dw_tab) == \
        (((0, pop.w_dw // 128),),) * (ddp // 128)
    assert _runs_from_tables(up_ptr, up_tab) == \
        (((0, pop.w_up // 128),),) * (dup // 128)


@pytest.mark.parametrize("kw,sqn,seed", SECTORS)
def test_plain_matvec_matches_reference_kernels(kw, sqn, seed):
    _, _, sec, h_j, op_j, op_p = _both(kw, sqn, seed)
    v = np.random.default_rng(5).standard_normal((sec.dim_dw, sec.dim_up))
    scale = 0.7
    y_p, ss_p = pbs._matvec_padded(op_p, pbs.to_padded(op_p, v), scale)
    vp_j = jbs.to_padded(op_j, v)
    y_runs, ss_runs = jbs._matvec_padded_runs(
        op_j.pop, vp_j, jnp.float32(scale), *op_j.pop._trim_runs,
        interpret=True)
    y_grid, ss_grid = jbs._matvec_padded_pop(op_j.pop, vp_j,
                                             jnp.float32(scale),
                                             interpret=True)
    y_ref = scale * np.asarray(apply_h(h_j, jnp.asarray(v)))
    ymax = np.abs(y_ref).max()
    y_np = y_p.numpy()
    for y_j, ss_j in ((y_runs, ss_runs), (y_grid, ss_grid)):
        assert np.abs(y_np - np.asarray(y_j)).max() < 2e-5 * ymax
        np.testing.assert_allclose(ss_p.numpy(), np.asarray(ss_j).ravel(),
                                   rtol=1e-4)
    y_nat = pbs.from_padded(op_p, y_p).numpy()
    assert np.abs(y_nat - y_ref).max() < 1e-6 * ymax
    assert np.all(y_np[sec.dim_dw:] == 0) and np.all(y_np[:, sec.dim_up:] == 0)
    assert ss_p.dtype == torch.float32
    assert ss_p.shape == (y_np.shape[0] // 128,)
    np.testing.assert_allclose(ss_p.numpy().sum(), (y_np.astype(np.float64)
                                                    ** 2).sum(), rtol=1e-6)
    # matvec_bs_padded is the unscaled apply
    y1 = pbs.matvec_bs_padded(op_p, pbs.to_padded(op_p, v))
    np.testing.assert_allclose(scale * y1.numpy(), y_np, rtol=1e-6,
                               atol=1e-6 * ymax)


def _hv_f64(pop, u):
    """H_p u in f64 over the f32 operator values the kernel multiplies."""
    d = pop.diag_a.double() @ pop.diag_b.double()
    u = u.double()
    return d * u + pop.hdw_p32.double() @ u + u @ pop.hup_p32.double()


@pytest.mark.parametrize("kw,sqn,seed", SECTORS)
def test_six_pass_plain_matvec_at_f32_grade(kw, sqn, seed):
    """The plain B1 (six passes over the three-part splits) against the f64
    product of the same vector over the same f32 operator values: within
    1e-6 x max|y| and within 2x the error of the true-f32 dense product."""
    *_, sec, _, _, op_p = _both(kw, sqn, seed)
    v = np.random.default_rng(8).standard_normal((sec.dim_dw, sec.dim_up))
    vp = pbs.to_padded(op_p, v)
    ref = _hv_f64(op_p.pop, vp)
    top = float(ref.abs().max())
    y6, ss6 = pbs.matvec_bs_padded_plain(op_p.pop, vp, 1.0)
    e6 = float((y6.double() - ref).abs().max())
    e32 = float((pbs._hv_plain(op_p.pop, vp).double() - ref).abs().max())
    assert e6 <= 1e-6 * top and e6 <= 2 * e32
    np.testing.assert_array_equal(ss6.numpy(), pbs._panel_ss(y6).numpy())


def test_split_plain_is_torch_split():
    """The split kernel's plain version: the (hi, mid, lo) of
    split3_bf16 as one [3, rows, dup] tensor, which sums back to x."""
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((256, 128))
                        * np.logspace(-5, 4, 128), dtype=torch.float32)
    parts = pbs.split3_rows(x)
    assert parts.shape == (3, 256, 128) and parts.dtype == torch.bfloat16
    for got, want in zip(parts, split3_bf16(x)):
        assert torch.equal(got, want)
    back = parts.double().sum(0)
    assert float(((back - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -24


def test_chain_step_normalizes():
    """Mirrors test_pallas.py:85-99: y = inv_norm * H v comes with
    rsqrt(|y|^2) = 1 / |y|, and feeding it back applies H to the
    normalized y."""
    _, _, sec, _, op_j, op_p = _both(dict(norb=1, nbath=6, uloc=(2.0,)),
                                     ((3,), (4,)), seed=2)
    v = np.random.default_rng(5).standard_normal((sec.dim_dw, sec.dim_up))
    v /= np.linalg.norm(v)
    vp = pbs.to_padded(op_p, v)
    y1, r1 = pbs.chain_step(op_p, vp, 1.0)
    assert r1.dtype == torch.float32 and r1.dim() == 0
    np.testing.assert_allclose(float(r1), 1.0 / float(y1.double().norm()),
                               rtol=1e-6)
    y2, _ = pbs.chain_step(op_p, y1, r1)
    y_ref = pbs.matvec_bs_padded(op_p, y1 * r1)
    np.testing.assert_allclose(y2.numpy(), y_ref.numpy(), atol=1e-6)
    # the JAX package's chain step on the same start
    yj, rj = jbs.chain_step(op_j, jbs.to_padded(op_j, v), jnp.float32(1.0),
                            interpret=True)
    assert np.abs(y1.numpy() - np.asarray(yj)).max() < \
        2e-5 * np.abs(np.asarray(yj)).max()
    np.testing.assert_allclose(float(r1), float(rj), rtol=1e-4)


def _slab_apply(pop, u, runs=None):
    """H_p u through the banded slabs with the CUDA kernel's window clamps
    (csrc/bs_panel_tc.cuh panel_stream), one 128-tile of the window at a
    time in ascending order, over the given runs (default: the whole
    windows), in numpy f64."""
    ddp, dup = pop.padded_shape
    dw, up = pop.dw_f32.double().numpy(), pop.up_f32.double().numpy()
    if runs is None:
        runs = (((0, pop.w_dw // 128),),) * (ddp // 128), \
            (((0, pop.w_up // 128),),) * (dup // 128)
    y = (pop.diag_a.double() @ pop.diag_b.double()).numpy() * u
    for i in range(ddp // 128):
        base = min(max(i - pop.d_dw, 0), (ddp - pop.w_dw) // 128) * 128
        for t0, t1 in runs[0][i]:
            for t in range(t0, t1):
                y[i * 128:(i + 1) * 128] += \
                    dw[i][:, t * 128:(t + 1) * 128] \
                    @ u[base + t * 128:base + (t + 1) * 128]
    for j in range(dup // 128):
        s = min(max((j - pop.d_up) * 128, 0), dup - pop.w_up)
        for t0, t1 in runs[1][j]:
            for t in range(t0, t1):
                y[:, j * 128:(j + 1) * 128] += \
                    u[:, s + t * 128:s + (t + 1) * 128] \
                    @ up[j][t * 128:(t + 1) * 128]
    return y


@pytest.mark.parametrize("sqn", [(6, 6), (6, 5)])
def test_runs_slab_apply_equals_whole_window(sqn):
    """At nbath = 11 the RCM band clips (W < padded width) and the windows
    hold zero tiles: the runs the kernel walks (also equal to the JAX
    package's _trim_runs on the same slabs) must give exactly the
    whole-window product, which reproduces the dense padded factors."""
    cfg = pt.read_input(None, norb=1, nbath=11, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                    pt.init_bath(cfg))
    pop = pbs.build_blocksparse_op(h, "cpu").pop
    ddp, dup = pop.padded_shape
    assert pop.w_dw < ddp and pop.w_up < dup
    assert pop.trim_runs == (jbs._trim_runs(pop.dw_f32.numpy(), axis=0),
                             jbs._trim_runs(pop.up_f32.numpy(), axis=1))
    assert pbs.trim_share(pop) > 0.1
    u = np.zeros((ddp, dup))
    u[:sec.dim_dw, :sec.dim_up] = np.random.default_rng(1).standard_normal(
        (sec.dim_dw, sec.dim_up))
    # the runs as the kernel reads them: decoded from its device tables
    def tables(t):
        return _runs_from_tables(t[0], t[1]), _runs_from_tables(t[2], t[3])
    assert tables(pop.runs_trim) == pop.trim_runs
    y_runs = _slab_apply(pop, u, tables(pop.runs_trim))
    y_full = _slab_apply(pop, u)
    assert np.array_equal(y_runs, y_full)
    assert np.array_equal(_slab_apply(pop, u, tables(pop.runs_full)), y_full)
    y_exact = (pop.diag_p.numpy() * u + u @ pop.hup_p.numpy()
               + pop.hdw_p.numpy() @ u)
    assert np.abs(y_runs - y_exact).max() < 1e-5 * np.abs(y_exact).max()
    assert np.all(y_runs[sec.dim_dw:] == 0) and \
        np.all(y_runs[:, sec.dim_up:] == 0)


def _stream(pop, i, j, runs):
    """The kernel's stages of output tile (panel i, panel j): ("dw" or
    "up", first element in the window) of every 64-deep slice of the runs
    (csrc/bs_panel_tc.cuh Runs), or of the dw window's first tile when the
    tile has no run at all."""
    dw = [("dw", k) for t0, t1 in runs[0][i] for k in range(128 * t0,
                                                             128 * t1, 64)]
    up = [("up", k) for t0, t1 in runs[1][j] for k in range(128 * t0,
                                                             128 * t1, 64)]
    return dw + up or [("dw", 0), ("dw", 64)]


def _six_pass_slab_apply(pop, u, runs):
    """H_p u the way the B1 kernel sums it, in torch f32 on the CPU: per
    output tile, each stage's six passes over the three-part splits of a
    64-deep slice of the slabs and of u (dot6_plain), summed apart and
    added to the tile's f32 sum in stream order; then the diagonal."""
    ddp, dup = pop.padded_shape
    dw3, up3 = split3_bf16(pop.dw_f32), split3_bf16(pop.up_f32)
    u3 = split3_bf16(u)
    acc = torch.zeros((ddp, dup), dtype=torch.float32)
    for i in range(ddp // 128):
        base = min(max(i - pop.d_dw, 0), (ddp - pop.w_dw) // 128) * 128
        rows = slice(128 * i, 128 * i + 128)
        for j in range(dup // 128):
            s_up = min(max((j - pop.d_up) * 128, 0), dup - pop.w_up)
            cols = slice(128 * j, 128 * j + 128)
            for kind, k in _stream(pop, i, j, runs):
                if kind == "dw":
                    part = dot6_plain(
                        [p[i][:, k:k + 64] for p in dw3],
                        [p[base + k:base + k + 64, cols] for p in u3])
                else:
                    part = dot6_plain(
                        [p[rows, s_up + k:s_up + k + 64] for p in u3],
                        [p[j][k:k + 64] for p in up3])
                acc[rows, cols] += part
    return (pop.diag_a @ pop.diag_b) * u + acc


@pytest.mark.parametrize("nbath,sqn", [(10, (5, 5)), (6, (3, 0)),
                                       (6, (0, 0))])
def test_six_pass_trimmed_apply_equals_whole_window(nbath, sqn):
    """The kernel's six-pass form, walked over the trim runs and over the
    whole windows as the kernel reads them from its device tables, gives
    the same bits (each skipped stage would add an exact zero to an f32
    sum), and agrees with the plain B1 to 1e-6 x max|y|. (10, (5, 5)):
    trimmed windows (16.7 % of the tiles), two runs in a window; (6, (3,
    0)): dim_dw = 1, no dw run, one up run of one tile (two stages); (6,
    (0, 0)): no run at all (the first dw tile's two zero stages)."""
    cfg = pt.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                    pt.init_bath(cfg))
    pop = pbs.build_blocksparse_op(h, "cpu").pop
    assert pbs.trim_share(pop) > 0.1
    v = np.random.default_rng(3).standard_normal((sec.dim_dw, sec.dim_up))
    u = torch.zeros(pop.padded_shape, dtype=torch.float32)
    u[:sec.dim_dw, :sec.dim_up] = torch.as_tensor(v)

    def tables(t):
        return _runs_from_tables(t[0], t[1]), _runs_from_tables(t[2], t[3])
    y_trim = _six_pass_slab_apply(pop, u, tables(pop.runs_trim))
    y_full = _six_pass_slab_apply(pop, u, tables(pop.runs_full))
    assert torch.equal(y_trim, y_full)
    y_plain, _ = pbs.matvec_bs_padded_plain(pop, u, 1.0)
    assert float((y_trim - y_plain).abs().max()) <= \
        1e-6 * float(y_plain.abs().max())


@pytest.mark.parametrize("nbath,sqn", [(4, ((2,), (2,))), (5, ((3,), (3,)))])
def test_per_call_ground_state_matches_reference(nbath, sqn):
    """The per-call two-stage solve (f32 thick restart over B1, then the
    mixed top-off and f64 polish) against the JAX package's same call and
    numpy eigh."""
    cfg_j, cfg_p, sec, h_j, op_j, op_p = _both(
        dict(norb=1, nbath=nbath, uloc=(2.0,)), sqn, bath="default")
    w, v = np.linalg.eigh(ed.dense_hamiltonian(h_j))
    e_p, vec_p = _blocksparse_ground_state(cfg_p, op_p, sec.dim, 1, 32,
                                           use_chain=False)
    e_j, vec_j = jax_two_stage(cfg_j, op_j, sec.dim, 1, 32, use_chain=False)
    assert abs(e_p[0] - e_j[0]) < 1e-10
    assert abs(e_p[0] - w[0]) < 1e-10
    assert abs(abs(np.vdot(vec_p[0], np.asarray(vec_j[0]))) - 1.0) < 1e-8
    assert abs(abs(np.vdot(vec_p[0], v[:, 0])) - 1.0) < 1e-8
