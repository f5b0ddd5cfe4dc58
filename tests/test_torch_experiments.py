"""PyTorch port, the experiment probes E1-E3 (dmft_lanc_ed_tpu_torch/
experiments/) against the JAX package's probes (experiments/*.py) on the
CPU: the port runs each kernel's plain version (CPU tensors), the JAX
probes their Pallas kernels in interpret mode, from the same numpy inputs.
The JAX probes are loaded from their files by path; ``chain_probe.chain``
takes its interpret flag, and the other two probes' ``pl.pallas_call`` is
wrapped with ``interpret=True`` for the test's duration (monkeypatch), so
nothing in the JAX package or in experiments/ changes.

Tolerances, each with its origin:
- tile tables, tile masks and the bf16 split of the slabs: exact (the same
  numpy and the same round-to-nearest-even on the same f32 slabs);
- E1: norms and vout 1e-5 relative (f32 products summed in other orders;
  the probe's own gates are 1e-5 and 1e-4 against numpy); the six-pass
  plain chain at K = 1 and 7 within those gates of the JAX probe and of
  its numpy chain;
- E2, every form: y 1e-6 x max|y|, panel sums of squares 1e-5 relative
  (the same exact bf16 products, f32 sums in other orders);
- E3, every form but bf16pair: the first 8 alpha, beta within 1e-5 x
  max(1, |alpha|max) (f32 scalars there, f64 here);
- the port's bf16pair against its 3pass: 1e-4 x max(1, |alpha|max) (its
  vectors hold hi + lo, ~2^-17 relative, per step).
"""
import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import dmft_lanc_ed_tpu as ed
from dmft_lanc_ed_tpu.ops import blocksparse as jbs
from dmft_lanc_ed_tpu_torch.convert import hamiltonian_from_reference
from dmft_lanc_ed_tpu_torch.ops import bf16x3
from dmft_lanc_ed_tpu_torch.experiments import chain_breakdown as pcb
from dmft_lanc_ed_tpu_torch.experiments import chain_probe as pcp
from dmft_lanc_ed_tpu_torch.experiments import trim_ab as pta
from dmft_lanc_ed_tpu_torch.ops import blocksparse as pbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    """experiments/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jprobes():
    return {n: _load(n) for n in ("chain_probe", "trim_ab",
                                  "chain_breakdown")}


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call of the JAX probes in interpret mode."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ops(nbath, sqn):
    """(sector, JAX op, port op) from one JAX Hamiltonian (default bath)."""
    cfg = ed.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = ed.SectorTable(cfg).sector(ed.qn(*sqn))
    h_j = ed.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                      ed.init_bath(cfg))
    h_p = hamiltonian_from_reference(
        {f.name: getattr(h_j, f.name) for f in dataclasses.fields(h_j)})
    return sec, jbs.build_blocksparse_op(h_j), \
        pbs.build_blocksparse_op(h_p, "cpu")


def _start(sec, op_j, op_p, seed):
    v = np.random.default_rng(seed).standard_normal((sec.dim_dw, sec.dim_up))
    v /= np.linalg.norm(v)
    return jbs.to_padded(op_j, v), pbs.to_padded(op_p, v)


NB10 = (10, (5, 5))     # 512^2 padded, W 384, 10 of 12 window tiles kept
NB11 = (11, (5, 5))     # 896^2 padded, W 640, a panel with two runs


def _bits(t):
    return np.asarray(t).view(np.uint16)


@pytest.mark.parametrize("geo", [NB10, NB11])
def test_tables_masks_and_split_equal_reference(jprobes, geo):
    """tables_from_runs and tile_masks equal the JAX probes' exactly, and
    the split of the port's f32 slabs equals the JAX op's bf16 slabs bit
    for bit."""
    _, op_j, op_p = _ops(*geo)
    port = pta.tables_from_runs(op_p)
    ref = jprobes["trim_ab"]._tables_from_runs(op_j.pop)
    for p, r in zip(port, ref):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for p, r in zip(pcb.tile_masks(op_p),
                    jprobes["chain_breakdown"]._tile_masks(op_j)):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    sp = bf16x3.split_op(op_p)
    for name in ("dw_hi", "dw_lo", "up_hi", "up_lo"):
        np.testing.assert_array_equal(
            getattr(sp, name).view(torch.int16).numpy().view(np.uint16),
            _bits(getattr(op_j.pop, name)))
    if geo == NB11:                 # the multi-run walk is exercised
        assert any(len(r) > 1 for r in op_p.pop.trim_runs[0]
                   + op_p.pop.trim_runs[1])


@pytest.mark.parametrize("geo", [NB10, NB11])
def test_skip_runs_walk_the_reference_masks(jprobes, geo):
    """E3's tileskip stage stream: the run tables built from tile_masks
    expand, panel by panel, to exactly the tiles the JAX probe's
    _tile_masks sets, in ascending order (what the kernel's Runs cursor
    walks)."""
    _, op_j, op_p = _ops(*geo)
    runs = pcb.skip_runs(op_p)
    ref = jprobes["chain_breakdown"]._tile_masks(op_j)
    for (ptr, tab), mask in zip((runs[:2], runs[2:]), ref):
        assert ptr.dtype == tab.dtype == torch.int32
        mask, ptr, tab = np.asarray(mask), ptr.numpy(), tab.numpy()
        assert ptr.shape == (mask.shape[0] + 1,) and ptr[0] == 0
        for p, row in enumerate(mask):
            walked = [t for t0, t1 in tab[ptr[p]:ptr[p + 1]]
                      for t in range(t0, t1)]
            assert walked == np.flatnonzero(row).tolist()


def test_chain_probe_plain_matches_reference(jprobes):
    """E1: the plain chain against the JAX probe's kernel (interpret)."""
    v0, a = pcp.probe_inputs("cpu")
    nj, vj = jprobes["chain_probe"].chain(jnp.asarray(v0.numpy()),
                                          jnp.asarray(a.numpy()), True)
    np_, vp = pcp.chain(v0, a)
    assert np_.shape == (pcp.K, 1) and vp.shape == (pcp.N, 128)
    nj, vj = np.asarray(nj), np.asarray(vj)
    assert np.abs(np_.numpy() - nj).max() <= 1e-5 * np.abs(nj).max()
    assert np.abs(vp.numpy() - vj).max() <= 1e-5 * np.abs(vj).max()


@functools.lru_cache(maxsize=None)
def _jax_chain_probe(kk):
    """The JAX probe module with K = kk steps (a fresh copy: its kernel and
    grid read the module's K when traced)."""
    mod = _load("chain_probe")
    mod.K = kk
    return mod


@pytest.mark.parametrize("kk", [1, 7])
def test_chain_probe_six_pass_plain_within_probe_gates(kk):
    """E1's plain version, the kernel's six-pass product, against the JAX
    probe's kernel (interpret) and against its f32 numpy chain, within the
    probe's gates: norms 1e-5, vout 1e-4 relative."""
    v0, a = pcp.probe_inputs("cpu")
    n_p, v_p = pcp.chain_plain(v0, a, kk)
    assert n_p.shape == (kk, 1) and v_p.shape == (pcp.N, 128)
    nj, vj = _jax_chain_probe(kk).chain(jnp.asarray(v0.numpy()),
                                        jnp.asarray(a.numpy()), True)
    n_r, v_r = pcp.reference(v0.numpy(), a.numpy(), kk)
    for n_ref, v_ref in ((np.asarray(nj).ravel(), np.asarray(vj)),
                         (n_r, v_r)):
        assert n_ref.shape == (kk,)
        assert (np.abs(n_p.numpy().ravel() - n_ref).max()
                <= 1e-5 * np.abs(n_ref).max())
        assert np.abs(v_p.numpy() - v_ref).max() <= 1e-4 * np.abs(v_ref).max()


def test_chain_probe_refuses_what_one_cluster_cannot_hold():
    """The wrapper raises, on the CPU too, on an n past one cluster (n =
    288 passed its checks while the kernel took multiples of 32), on
    mismatched shapes, a non-square A, other types and kk < 1."""
    v0, a = pcp.probe_inputs("cpu")
    big = torch.zeros((288, 128)), torch.zeros((288, 288))
    for args, kw in ((big, {}), ((v0[:64], a), {}), ((v0, a.double()), {}),
                     ((v0, a), {"kk": 0}), ((v0, a[:, :128]), {})):
        with pytest.raises(ValueError):
            pcp.chain(*args, **kw)
    # below the cluster's 256 rows the wrapper takes any n (it pads)
    n_s, v_s = pcp.chain(v0[:200].contiguous(), a[:200, :200].contiguous(),
                         3)
    n_r, v_r = pcp.reference(v0[:200].numpy(), a[:200, :200].numpy(), 3)
    assert v_s.shape == (200, 128)
    assert np.abs(n_s.numpy().ravel() - n_r).max() <= 1e-5 * n_r.max()


def test_chain_probe_aligns_offset_views():
    """The kernel reads v0 and A by 16-byte copies: a contiguous view at a
    storage offset of one float gets an aligned copy of the same values,
    an aligned tensor is passed as it is."""
    v0, _ = pcp.probe_inputs("cpu")
    buf = torch.zeros(v0.numel() + 1)
    view = buf[1:].view_as(v0)
    view.copy_(v0)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = pcp._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, v0)
    assert pcp._aligned(v0) is v0


def test_chain_probe_main_checks_on_cpu(capsys):
    out = pcp.main("cpu")
    assert out["err_norms"] < 1e-5 and out["err_vout"] < 1e-4
    assert out["us_per_step"] is None
    assert "PROBE OK" in capsys.readouterr().out


@pytest.mark.parametrize("form", pta.MODES + ("static_runs",))
def test_trim_ab_matches_reference(jprobes, interpret, form):
    """E2: each form's port (plain) against the JAX probe's kernel."""
    sec, op_j, op_p = _ops(*NB10)
    vj, vp = _start(sec, op_j, op_p, 3)
    scale = 0.7
    if form == "static_runs":
        cj, cp = jprobes["trim_ab"].make_static_runs(op_j), \
            pta.make_static_runs(op_p)
    else:
        cj, cp = jprobes["trim_ab"].make_variant(op_j, form), \
            pta.make_variant(op_p, form)
    yj, ssj = cj(vj, jnp.float32(scale))
    yp, ssp = cp(vp, scale)
    yj, ssj = np.asarray(yj), np.asarray(ssj)
    assert yp.shape == yj.shape and ssp.shape == ssj.shape == (4, 1)
    assert np.abs(yp.numpy() - yj).max() <= 1e-6 * np.abs(yj).max()
    np.testing.assert_allclose(ssp.numpy(), ssj, rtol=1e-5)


@pytest.mark.parametrize("form", ["static_runs", "both"])
def test_trim_ab_multi_run_panels(jprobes, interpret, form):
    """E2 at nbath = 11 (5,5), whose windows hold a panel of two runs."""
    sec, op_j, op_p = _ops(*NB11)
    vj, vp = _start(sec, op_j, op_p, 4)
    if form == "static_runs":
        cj, cp = jprobes["trim_ab"].make_static_runs(op_j), \
            pta.make_static_runs(op_p)
    else:
        cj, cp = jprobes["trim_ab"].make_variant(op_j, form), \
            pta.make_variant(op_p, form)
    yj, ssj = cj(vj, jnp.float32(1.0))
    yp, ssp = cp(vp, 1.0)
    yj = np.asarray(yj)
    assert np.abs(yp.numpy() - yj).max() <= 1e-6 * np.abs(yj).max()
    np.testing.assert_allclose(ssp.numpy(), np.asarray(ssj), rtol=1e-5)


@pytest.mark.parametrize("mode", ["3pass", "1pass", "nop1", "tileskip"])
def test_chain_breakdown_matches_reference(jprobes, interpret, mode):
    """E3: each form's plain chain against the JAX probe's kernel, kk = 8."""
    sec, op_j, op_p = _ops(*NB10)
    vj, vp = _start(sec, op_j, op_p, 5)
    kk = 8
    aj, bj = jprobes["chain_breakdown"].make_variant(op_j, mode)(vj, kk)
    ap, bp = pcb.make_variant(op_p, mode)(vp, kk)
    aj, bj = np.asarray(aj), np.asarray(bj)
    assert ap.shape == bp.shape == (kk, 1) and ap.dtype == torch.float32
    scale = max(1.0, np.abs(aj).max())
    assert np.abs(ap.numpy() - aj).max() <= 1e-5 * scale
    assert np.abs(bp.numpy() - bj).max() <= 1e-5 * scale


def test_chain_breakdown_bf16pair_near_3pass():
    """The port seeds bf16pair's planes (the JAX probe does not): its chain
    is the 3pass chain with every vector rounded to hi + lo."""
    sec, op_j, op_p = _ops(*NB10)
    _, vp = _start(sec, op_j, op_p, 5)
    a3, b3 = pcb.make_variant(op_p, "3pass")(vp, 16)
    ap, bp = pcb.make_variant(op_p, "bf16pair")(vp, 16)
    scale = max(1.0, float(a3.abs().max()))
    assert bool(torch.isfinite(ap).all() and torch.isfinite(bp).all())
    assert float((ap - a3).abs().max()) <= 1e-4 * scale
    assert float((bp - b3).abs().max()) <= 1e-4 * scale
    assert float((ap - a3).abs().max()) > 0.0     # the rounding is there


def test_split_matches_dense_split():
    """The slabs' split and the dense factors' split hold the same values
    in the windows (the plain versions multiply the dense one)."""
    _, _, op_p = _ops(*NB10)
    pop = op_p.pop
    sp, ds = bf16x3.split_op(pop), bf16x3.dense_split(pop)
    ddp = pop.padded_shape[0]
    for i in range(ddp // 128):
        t = min(max(i - pop.d_dw, 0), (ddp - pop.w_dw) // 128) * 128
        for part, dense in (("dw_hi", ds.hdw_hi), ("dw_lo", ds.hdw_lo)):
            assert torch.equal(getattr(sp, part)[i].float(),
                               dense[i * 128:(i + 1) * 128, t:t + pop.w_dw])
    x = torch.tensor([1.0 + 2 ** -10, -(3.0 + 2 ** -12)])
    xh, xl = bf16x3.split_bf16(x)
    assert torch.equal(xh.float(), torch.tensor([1.0, -3.0]))
    assert torch.equal(xh.float() + xl.float(), x)


@pytest.mark.parametrize("probe", [pcp, pta, pcb])
def test_probe_mains_need_the_card(probe, monkeypatch):
    """Each main() defaults to the card and raises without one, naming
    device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        probe.main()
