"""The CUDA kernels (the chains B2, B3, B4 and the per-call matvec B1)
against their plain PyTorch versions on the card. Marked ``gpu``: without
a CUDA device every test skips (the CPU tests hold the plain versions
against the JAX package instead). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q

(``--noconftest``: tests/conftest.py imports jax, which the port's
machine need not have).

Tolerances: both sides are f32 recurrences over the same operator with
f32 products summed in different orders, so the first chain coefficients
agree to ~1e-6 relative; the bounds below are the B4 contract, 5e-5 *
scale (test_bs_chain.py:126-139), and 1e-4 relative for the filtered
vectors.
"""
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
from dmft_lanc_ed_tpu_torch.ops.blocksparse import (build_blocksparse_op,
                                                    to_padded)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _op(cuda, nbath, sqn):
    cfg = pt.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1,) * 4),
                                    pt.init_bath(cfg))
    return build_blocksparse_op(h, cuda)


def _starts(op, n, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, op.dim_dw, op.dim_up))
    v /= np.linalg.norm(v.reshape(n, -1), axis=1)[:, None, None]
    return to_padded(op, v)


GEOMETRIES = [(6, (3, 3)), (9, (5, 4)), (11, (6, 5))]


@pytest.mark.parametrize("nbath,sqn", GEOMETRIES)
def test_tridiag_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    v0 = _starts(op, 1)[0]
    before = bc.launch_counts["tridiag"]
    al_k, be_k = bc.tridiag_call(op, v0, 32)
    assert bc.launch_counts["tridiag"] == before + 1
    al_p, be_p = bc.tridiag_chain_plain(op.pop, v0[None], 32)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_k[:12] - al_p[0, :12]).abs().max()) < 5e-5 * scale
    assert float((be_k[:12] - be_p[0, :12]).abs().max()) < 5e-5 * scale


@pytest.mark.parametrize("nbath,sqn", GEOMETRIES)
def test_cheb_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    v0 = _starts(op, 1, 1)[0]
    al, be = bc.tridiag_chain_plain(op.pop, v0[None], 32)
    th = np.linalg.eigvalsh(np.diag(al[0].cpu().numpy())
                            + np.diag(be[0, :-1].cpu().numpy(), 1)
                            + np.diag(be[0, :-1].cpu().numpy(), -1))
    c, e = 0.5 * (th[-1] + th[0]) + 0.1, 0.6 * (th[-1] - th[0])
    vk, nk = bc.cheb_call(op, v0, 32, c, 1.0 / e)
    vp, npl = bc.cheb_chain_plain(op.pop, v0, 32, c, 1.0 / e)
    rel = float((vk / nk - vp / npl).norm() / (vp / npl).norm())
    assert rel < 1e-4
    assert bool(torch.all(vk[op.dim_dw:] == 0))          # pad stays zero
    assert bool(torch.all(vk[:, op.dim_up:] == 0))


@pytest.mark.parametrize("nbath,sqn", GEOMETRIES)
def test_gf_tridiag_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    vb = _starts(op, 3, 2)
    al_k, be_k = bc.gf_tridiag_call(op, vb, 24)
    al_p, be_p = bc.gf_tridiag_batch_plain(op.pop, vb, 24)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_k[:, :8] - al_p[:, :8]).abs().max()) < 5e-5 * scale
    assert float((be_k[:, :8] - be_p[:, :8]).abs().max()) < 5e-5 * scale


def test_kernel_wrappers_refuse_bad_inputs(cuda):
    op = _op(cuda, 6, (3, 3))
    v0 = _starts(op, 1)[0]
    with pytest.raises(ValueError):
        bc.tridiag_call(op, v0.double(), 8)
    with pytest.raises(ValueError):
        bc.tridiag_call(op, v0[:, :64].contiguous(), 8)
    with pytest.raises(ValueError):
        bs.matvec_bs_padded(op, v0.double())
    with pytest.raises(ValueError):
        bs.matvec_bs_padded(op, _starts(op, 2))


B1_GEOMETRIES = [(6, (3, 3)), (11, (6, 6))]


@pytest.mark.parametrize("nbath,sqn", B1_GEOMETRIES)
def test_matvec_trimmed_equals_full_window(cuda, nbath, sqn):
    """B1a (trim runs) and B1b (whole windows) skip only exact-zero
    products, so they agree bit for bit; the pad stays exactly zero."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 3)[0]
    before = dict(bs.launch_counts)
    y_t, ss_t = bs._matvec_padded(op, v, 0.5, trim=True)
    y_f, ss_f = bs._matvec_padded(op, v, 0.5, trim=False)
    assert bs.launch_counts["matvec_runs"] == before["matvec_runs"] + 1
    assert bs.launch_counts["matvec_full"] == before["matvec_full"] + 1
    assert torch.equal(y_t, y_f) and torch.equal(ss_t, ss_f)
    assert bool(torch.all(y_t[op.dim_dw:] == 0))
    assert bool(torch.all(y_t[:, op.dim_up:] == 0))


@pytest.mark.parametrize("nbath,sqn", B1_GEOMETRIES)
def test_matvec_kernel_matches_plain(cuda, nbath, sqn):
    """Kernel vs plain version, both true f32 products in different
    orders: y to 1e-5 x max|y|, per-panel sums of squares 1e-5 relative."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 4)[0]
    y_k, ss_k = bs._matvec_padded(op, v, 0.5)
    y_p, ss_p = bs.matvec_bs_padded_plain(op.pop, v, 0.5)
    assert float((y_k - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    assert ss_k.shape == ss_p.shape
    assert float(((ss_k - ss_p).abs() / ss_p.abs().clamp(min=1e-30)).max()
                 ) <= 1e-5


@pytest.mark.parametrize("nbath,sqn", B1_GEOMETRIES)
def test_chain_step_normalizes_on_card(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 5)[0]
    y, r = bs.chain_step(op, v, torch.ones((), device=cuda))
    assert r.is_cuda and r.dim() == 0
    nrm = float(y.double().norm())
    assert abs(float(r) - 1.0 / nrm) <= 1e-6 / nrm
    y2, _ = bs.chain_step(op, y, r)
    y_ref, _ = bs.matvec_bs_padded_plain(op.pop, y, r)
    assert float((y2 - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
