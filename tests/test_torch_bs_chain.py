"""PyTorch port, band-sparse chains (ops/bs_chain.py) against the JAX
package on CPU: the port runs its kernels' plain versions (CPU tensors),
the JAX package its Pallas kernels in interpret mode, both from the same
numpy start vectors.

Tolerances, each with its origin:
- B2's chain coefficients vs the f64 plain-Lanczos oracle: 5e-4 * scale,
  the JAX package's split-bf16 contract (test_bs_chain.py:49-52). Port vs
  JAX: 1e-4 * scale, down from 1e-3 * scale when the port's chain was f32
  and both sides' errors added: both now run the same three-pass split-bf16
  product and differ by summation order and by the scalar state (f32 in the
  Pallas kernel, f64 here), which 16 steps amplify to at most 2.1e-5 over
  the seeds tried; the gate leaves 5x. B3's filtered vectors, port vs JAX:
  2e-5 relative (measured 3e-7 to 1.8e-6). B4's plain version runs the
  six-pass product of the three-part split (24 significant bits a side,
  the TPU kernel's HIGHEST dots) and meets the f32 GF contract, 5e-5 *
  scale, against the oracle; its H u is within 1e-6 * max|H u| of the f64
  product (f32 accumulation of ~1e-7), and its chain within 1e-6 * scale of
  the true-f32 chain over a few steps;
- GF chains: first 8 coefficients 5e-5 * scale and continued-fraction
  G(iw) 2e-5 (test_bs_chain.py:126-139);
- two-stage ground states: Egs 1e-10 (the f64 polish gate, bench.py:51),
  eigenvector overlap 1 - 1e-8.
"""
import dataclasses

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.diag import _blocksparse_ground_state as jax_two_stage
from dmft_lanc_ed_tpu.ops import bs_chain as jbc
from dmft_lanc_ed_tpu.ops.blocksparse import build_blocksparse_op as jax_bs
from dmft_lanc_ed_tpu.ops.blocksparse import matvec_bs_exact_flat as jax_exact
from dmft_lanc_ed_tpu.ops.blocksparse import to_padded as jax_to_padded
from dmft_lanc_ed_tpu.ops.lanczos import lanczos_tridiag as jax_tridiag
from dmft_lanc_ed_tpu_torch.convert import hamiltonian_from_reference
from dmft_lanc_ed_tpu_torch.diag import _blocksparse_ground_state
from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
from dmft_lanc_ed_tpu_torch.ops.bf16x3 import (split3_bf16, split3_op,
                                               split_bf16, split_op)
from dmft_lanc_ed_tpu_torch.ops.blocksparse import (build_blocksparse_op,
                                                    from_padded, to_padded)
from dmft_lanc_ed_tpu_torch.ops.lanczos import tridiag_eigh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(nbath=6, nup=3, ndw=3):
    """(JAX cfg, port cfg, sector, JAX op, port op, dense H) of one sector
    of the default bath; the port's Hamiltonian is the JAX one carried
    across by convert.py."""
    kw = dict(norb=1, nbath=nbath, uloc=(2.0,))
    cfg_j, cfg_p = ed.read_input(None, **kw), pt.read_input(None, **kw)
    sec = ed.SectorTable(cfg_j).sector(ed.qn(nup, ndw))
    h_j = ed.build_sector_hamiltonian(cfg_j, sec, np.zeros((1,) * 4),
                                      ed.init_bath(cfg_j))
    h_p = hamiltonian_from_reference(
        {f.name: getattr(h_j, f.name) for f in dataclasses.fields(h_j)})
    return (cfg_j, cfg_p, sec, jax_bs(h_j), build_blocksparse_op(h_p, "cpu"),
            ed.dense_hamiltonian(h_j))


def _starts(op, n, seed):
    v = np.random.default_rng(seed).standard_normal((n, op.dim_dw, op.dim_up))
    return v / np.linalg.norm(v.reshape(n, -1), axis=1)[:, None, None]


def _assert_pad_zero(op, vp):
    vp = np.asarray(vp)
    assert np.all(vp[..., op.dim_dw:, :] == 0.0)
    assert np.all(vp[..., :, op.dim_up:] == 0.0)


def test_tridiag_chain_matches_reference_and_oracle():
    _, _, _, op_j, op_p, _ = _ops()
    v0 = _starts(op_p, 1, 3)[0]
    m = 16
    al_p, be_p, bout_p = bc.tridiag_chain(op_p, to_padded(op_p, v0), m)
    al_j, be_j, _ = jbc.tridiag_chain(op_j, jax_to_padded(op_j, v0), m)
    al_r, be_r = jax_tridiag(op_j, np.asarray(v0).reshape(-1), m, jax_exact)
    al_r, be_r = np.asarray(al_r), np.asarray(be_r)
    scale = max(1.0, float(np.abs(al_r).max()))
    for al, be in ((al_p, be_p), (al_j, be_j)):
        assert np.abs(al - al_r).max() < 5e-4 * scale
        assert np.abs(be - be_r).max() < 5e-4 * scale
    assert np.abs(al_p - al_j).max() < 1e-4 * scale
    assert np.abs(be_p - be_j).max() < 1e-4 * scale
    # B4's plain version is the same recurrence with six-pass products
    al_f, be_f = bc.gf_tridiag_batch_plain(
        op_p.pop, to_padded(op_p, v0)[None], m)
    assert np.abs(al_f[0].numpy() - al_r).max() < 5e-5 * scale
    assert np.abs(be_f[0].numpy()[:m - 1] - be_r[1:]).max() < 5e-5 * scale
    assert bout_p > 0.0


def test_cheb_chain_amplifies_ground_state_and_keeps_pad_zero():
    _, _, _, op_j, op_p, dense = _ops()
    w, v = np.linalg.eigh(dense)
    v0 = _starts(op_p, 1, 5)[0]
    b = float(w[-1]) + 0.05 * (w[-1] - w[0])
    cut = float(w[0]) + 0.4 * (w[1] - w[0])
    vf = bc.cheb_chain(op_p, to_padded(op_p, v0), 32, 0.5 * (b + cut),
                       0.5 * (b - cut))
    _assert_pad_zero(op_p, vf)
    vj = np.asarray(jbc.cheb_chain(op_j, jax_to_padded(op_j, v0), 32,
                                   0.5 * (b + cut), 0.5 * (b - cut)))
    assert np.linalg.norm(vf.numpy() - vj) < 2e-5 * np.linalg.norm(vj)
    vn = from_padded(op_p, vf).numpy().ravel()
    ov0 = abs(np.vdot(v0.ravel(), v[:, 0]))
    ovf = abs(np.vdot(vn / np.linalg.norm(vn), v[:, 0]))
    assert ovf > 0.99 and ovf > ov0 * 10


def test_ground_state_seed_and_two_stage_match_reference():
    cfg_j, cfg_p, sec, op_j, op_p, dense = _ops()
    w, v = np.linalg.eigh(dense)
    th, seed_p, eta = bc.ground_state_seed(op_p, m_tri=24, m_cheb=32,
                                           return_padded=True)
    _assert_pad_zero(op_p, seed_p)
    seed = from_padded(op_p, seed_p).numpy().ravel()
    ov = abs(np.vdot(seed / np.linalg.norm(seed), v[:, 0]))
    assert abs(th - w[0]) < 1e-3
    assert ov > 0.999
    assert np.sqrt(max(1.0 - ov * ov, 0.0)) <= max(eta, 1e-6) * 3
    e_p, vec_p = _blocksparse_ground_state(cfg_p, op_p, sec.dim, 1, 32)
    e_j, vec_j = jax_two_stage(cfg_j, op_j, sec.dim, 1, 32)
    assert abs(e_p[0] - e_j[0]) < 1e-10
    assert abs(e_p[0] - w[0]) < 1e-10
    assert abs(abs(np.vdot(vec_p[0], np.asarray(vec_j[0]))) - 1.0) < 1e-8


def test_tridiag_chain_breakdown():
    """Start vector = exact eigenvector: the chain dies after one step and
    the zero-beta truncation in ground_state_seed still returns it."""
    _, _, _, _, op_p, dense = _ops(nbath=4, nup=2, ndw=2)
    w, v = np.linalg.eigh(dense)
    v0 = to_padded(op_p, v[:, 0].reshape(op_p.dim_dw, op_p.dim_up))
    al, be, _ = bc.tridiag_chain(op_p, v0, 8)
    assert abs(al[0] - w[0]) < 1e-4          # f32 Rayleigh quotient
    assert be[1] < 1e-2
    _, seed, _ = bc.ground_state_seed(op_p, m_tri=8, m_cheb=8, v0=v0)
    assert abs(np.vdot(seed.numpy().ravel(), v[:, 0])) > 0.999


def test_gf_tridiag_batch_matches_reference():
    _, _, _, op_j, op_p, _ = _ops()
    m, nb = 24, 3
    vs = _starts(op_p, nb, 11).reshape(nb, -1)
    al_p, be_p = bc.gf_tridiag_batch(op_p, vs, m)
    al_j, be_j = jbc.gf_tridiag_batch(op_j, vs, m)
    z = 1j * np.linspace(0.05, 3.0, 20)

    def g_cf(al, be):
        th, s = tridiag_eigh(al, be)
        return ((s[0, :] ** 2)[None, :] / (z[:, None] - th)).sum(1)
    for i in range(nb):
        al_r, be_r = jax_tridiag(op_j, vs[i], m, jax_exact)
        al_r, be_r = np.asarray(al_r), np.asarray(be_r)
        scale = max(1.0, float(np.abs(al_r).max()))
        for al, be in ((al_p[i], be_p[i]), (al_r, be_r)):
            assert np.abs(al[:8] - al_j[i][:8]).max() < 5e-5 * scale
            assert np.abs(be[:8] - be_j[i][:8]).max() < 5e-5 * scale
            assert np.abs(g_cf(al, be) - g_cf(al_j[i], be_j[i])).max() < 2e-5


def _slab_apply(pop, u):
    """H_p u through the banded slabs with the CUDA kernel's window clamps
    (csrc/bs_panel_tc.cuh panel_stream), in numpy f64."""
    ddp, dup = pop.padded_shape
    dw, up = pop.dw_f32.double().numpy(), pop.up_f32.double().numpy()
    y = (pop.diag_a.double() @ pop.diag_b.double()).numpy() * u
    for i in range(ddp // 128):
        base = min(max(i - pop.d_dw, 0), (ddp - pop.w_dw) // 128) * 128
        y[i * 128:(i + 1) * 128] += dw[i] @ u[base:base + pop.w_dw]
    for j in range(dup // 128):
        s = min(max((j - pop.d_up) * 128, 0), dup - pop.w_up)
        y[:, j * 128:(j + 1) * 128] += u[:, s:s + pop.w_up] @ up[j]
    return y


@pytest.mark.parametrize("sqn", [(6, 6), (6, 5)])
def test_slab_windows_reproduce_padded_factors(sqn):
    """At nbath = 11 the RCM band clips (W < padded width), so the slab
    windows of the kernels must reproduce the dense padded factors that
    the plain versions apply — square (6,6) and non-square (6,5) grids."""
    cfg = pt.read_input(None, norb=1, nbath=11, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                    pt.init_bath(cfg))
    pop = build_blocksparse_op(h, "cpu").pop
    ddp, dup = pop.padded_shape
    assert pop.w_dw < ddp and pop.w_up < dup
    u = np.zeros((ddp, dup))
    u[:sec.dim_dw, :sec.dim_up] = np.random.default_rng(1).standard_normal(
        (sec.dim_dw, sec.dim_up))
    y_slab = _slab_apply(pop, u)
    y_plain = bc._hv_plain(pop, torch.as_tensor(u, dtype=torch.float32))
    y_exact = (pop.diag_p.numpy() * u + u @ pop.hup_p.numpy()
               + pop.hdw_p.numpy() @ u)
    scale = np.abs(y_exact).max()
    assert np.abs(y_slab - y_exact).max() < 1e-5 * scale
    assert np.abs(y_plain.double().numpy() - y_exact).max() < 1e-5 * scale
    assert np.all(y_slab[sec.dim_dw:] == 0) and \
        np.all(y_slab[:, sec.dim_up:] == 0)


@pytest.mark.parametrize("kernel", ["tridiag", "cheb", "gf_tridiag"])
def test_stored_pair_is_the_split_of_its_plane(kernel):
    """The planes of B2/B3 carry a stored bf16 hi/lo pair, and B4's a
    (hi, mid, lo) triple, that feeds the next product: after plain steps
    each equals split_bf16 / split3_bf16 of its f32 plane bit for bit (the
    kernels' epilogues write the same bits), and the pad stays exactly
    zero."""
    _, _, _, _, op_p, _ = _ops()
    v0 = to_padded(op_p, _starts(op_p, 1, 7)[0])
    out = {}
    split, hv, bits = split_bf16, bc.hv_split, 16
    if kernel == "tridiag":
        bc.tridiag_chain_plain(op_p.pop, v0[None], 5, out=out)
    elif kernel == "cheb":
        bc.cheb_chain_plain(op_p.pop, v0, 5, 0.3, 0.2, out=out)
    else:
        bc.gf_tridiag_batch_plain(op_p.pop, v0[None], 5, out=out)
        split, hv, bits = split3_bf16, bc.hv_split3, 24
    for plane, parts in zip(out["planes"], out["parts"]):
        assert len(parts) == bits // 8
        assert all(p.dtype == torch.bfloat16 for p in parts)
        assert all(torch.equal(p, r) for p, r in zip(parts, split(plane)))
        resid = plane.double() - sum(p.double() for p in parts)
        assert float(resid.abs().max()) <= \
            2.0 ** -bits * float(plane.abs().max())
        _assert_pad_zero(op_p, plane.numpy())
    # the stored parts and a fresh split give the same product
    u = out["planes"][0]
    assert torch.equal(hv(op_p.pop, u, out["parts"][0]), hv(op_p.pop, u))


def test_split3_reconstructs_its_input():
    """hi + mid + lo carries f32's 24 bits: |x - hi - mid - lo| <= 2^-24
    max|x| over values spread across many binades, and hi is bf16(x)."""
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal(4096)
                        * 10.0 ** rng.uniform(-6, 6, 4096), dtype=torch.float32)
    hi, mid, lo = split3_bf16(x)
    assert torch.equal(hi, x.to(torch.bfloat16))
    resid = x.double() - hi.double() - mid.double() - lo.double()
    assert float(resid.abs().max()) <= 2.0 ** -24 * float(x.abs().max())
    # each part is the rounding of what the parts before it leave
    assert torch.equal(mid, (x - hi.float()).to(torch.bfloat16))


def _hv_f64(pop, u):
    """H_p u in f64 over the f32 operator values the kernels multiply."""
    d = pop.diag_a.double() @ pop.diag_b.double()
    u = u.double()
    return d * u + pop.hdw_p32.double() @ u + u @ pop.hup_p32.double()


def test_six_pass_product_is_f32_close():
    """B4's plain H u (six passes of the three-part split) is within 1e-6 x
    max|H u| of the f64 product of the same u over the same f32 operator
    values. Its hop products, where the forms differ (the diagonal is the
    same f32 arithmetic in both: the op without it here), are at least 10x
    closer to f64 than B2's three-pass ones."""
    _, _, _, _, op_p, _ = _ops()
    pop = op_p.pop
    u = to_padded(op_p, _starts(op_p, 1, 13)[0])
    ref = _hv_f64(pop, u)
    err6 = float((bc.hv_split3(pop, u).double() - ref).abs().max())
    assert err6 <= 1e-6 * float(ref.abs().max())
    hops = dataclasses.replace(pop, diag_a=torch.zeros_like(pop.diag_a))
    ref = _hv_f64(hops, u)
    err6 = float((bc.hv_split3(hops, u).double() - ref).abs().max())
    err3 = float((bc.hv_split(hops, u).double() - ref).abs().max())
    assert err6 <= 1e-6 * float(ref.abs().max())
    assert 10.0 * err6 <= err3


def test_gf_plain_version_stays_f32():
    """B4's plain version is the recurrence over the six-pass product: over
    6 steps within 1e-6 x scale of the true-f32 chain (_hv_plain), and not
    the three-pass split product B2's plain version runs."""
    _, _, _, _, op_p, _ = _ops()
    vb = to_padded(op_p, _starts(op_p, 2, 9))
    al_g, be_g = bc.gf_tridiag_batch_plain(op_p.pop, vb, 6)
    al_f, be_f = bc.tridiag_chain_plain(op_p.pop, vb, 6, hv=bc._hv_plain)
    al_s, be_s = bc.tridiag_chain_plain(op_p.pop, vb, 6)
    scale = max(1.0, float(al_f.abs().max()))
    assert float((al_g - al_f).abs().max()) <= 1e-6 * scale
    assert float((be_g - be_f).abs().max()) <= 1e-6 * scale
    assert not torch.equal(al_g, al_s)
    assert float((al_s - al_f).abs().max()) < 5e-4 * scale


def test_seed_counts_count_reached_and_missed():
    _, _, _, _, op_p, _ = _ops()
    bc.reset_launch_counts()
    assert bc.seed_counts == {"reached": 0, "missed": 0}
    _, _, eta = bc.ground_state_seed(op_p, m_tri=24, m_cheb=32)
    assert eta <= 3e-3 and bc.seed_counts == {"reached": 1, "missed": 0}
    # one round cannot reach an eta no f32 chain reaches
    _, _, eta = bc.ground_state_seed(op_p, m_tri=8, m_cheb=16, max_rounds=1,
                                     eta_target=1e-12)
    assert eta > 1e-12 and bc.seed_counts == {"reached": 1, "missed": 1}
    # on the CPU the plain versions ran: no kernel launch, no kernel step
    assert all(n == 0 for n in bc.launch_counts.values())
    assert all(n == 0 for n in bc.step_counts.values())
    bc.reset_launch_counts()
    assert bc.seed_counts == {"reached": 0, "missed": 0}


@pytest.mark.parametrize("parts", [2, 3])
def test_chain_bytes_count_split_slabs_and_pair_planes(parts):
    """The footprint of a chain in the product form of `parts` bf16 parts
    a side (2: B2/B3, 3: B4) is what its kernel holds: per chain two f32
    planes and their parts, per op the split slabs and the diagonal."""
    _, _, _, _, op_p, _ = _ops()
    pop = op_p.pop
    ddp, dup = pop.padded_shape
    if parts == 2:
        sp = split_op(pop)
        slabs = (sp.dw_hi, sp.dw_lo, sp.up_hi, sp.up_lo)
    else:
        slabs = split3_op(pop).dw + split3_op(pop).up
    slab_split = sum(t.numel() * t.element_size() for t in slabs)
    assert slab_split == 2 * parts * (pop.dw_f32.numel() + pop.up_f32.numel())
    diag = 4 * (pop.diag_a.numel() + pop.diag_b.numel())
    per_chain = 2 * 4 * ddp * dup + 2 * parts * 2 * ddp * dup
    assert bc._chain_bytes(pop, 0, parts) == slab_split + diag
    assert bc._chain_bytes(pop, 3, parts) - bc._chain_bytes(pop, 0, parts) \
        == 3 * per_chain
    assert bc.chain_applicable(op_p) and bc.gf_chain_applicable(op_p, 200)


def test_gf_chain_gate_and_chunks_count_b4_footprint(monkeypatch):
    """The GF chain gate and gf_tridiag_batch's chunks count B4's own
    footprint (three-part planes and slabs), not B2's: with the budget at
    exactly two B4 chains, two fit a launch and three go out in 2 + 1."""
    _, _, _, _, op_p, _ = _ops()
    pop = op_p.pop
    one = bc._chain_bytes(pop, 1, parts=3)
    monkeypatch.setattr(bc, "CHAIN_DEVICE_BUDGET", one)
    assert bc.gf_chain_applicable(op_p, 24)
    monkeypatch.setattr(bc, "CHAIN_DEVICE_BUDGET", one - 1)
    assert not bc.gf_chain_applicable(op_p, 24)
    monkeypatch.setattr(bc, "CHAIN_DEVICE_BUDGET",
                        bc._chain_bytes(pop, 2, parts=3))
    batches = []
    call = bc.gf_tridiag_call

    def spy(op, v32p, kk):
        batches.append(v32p.shape[0])
        return call(op, v32p, kk)
    monkeypatch.setattr(bc, "gf_tridiag_call", spy)
    vs = _starts(op_p, 3, 4).reshape(3, -1)
    al, be = bc.gf_tridiag_batch(op_p, vs, 6)
    assert batches == [2, 1] and al.shape == be.shape == (3, 6)
    al_1, _ = bc.gf_tridiag_batch(op_p, vs[2:], 6)
    assert np.array_equal(al[2], al_1[0])
