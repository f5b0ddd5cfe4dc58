"""The CUDA kernels (the chains B2, B3, B4, the per-call matvec B1 and its
dw-sharded form B5, and the experiment probes' kernels E1-E3) against their
plain PyTorch versions on the card. Marked ``gpu``: without
a CUDA device every test skips (the CPU tests hold the plain versions
against the JAX package instead). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q

(``--noconftest``: tests/conftest.py imports jax, which the port's
machine need not have). The NCCL tests at the end need two cards (one
rank per card; NCCL refuses two ranks on one) and skip with fewer.

Tolerances: a kernel and its plain version run the same recurrence in
f32 over the same operator with the same product form (B2/B3: three-pass
split-bf16 products; B1, B4, B5: six passes over a three-part split; every
bf16 x bf16 term is exact in f32), summed in different orders, so the
first chain coefficients agree to ~1e-6 relative; the bounds below are the
B4 contract, 5e-5 * scale (test_bs_chain.py:126-139), and 1e-4 relative
for the filtered vectors. One product of a kernel against its plain
version: 1e-6 x max|H u|; B1/B5 against theirs 1e-5 x max|y|, panel sums
1e-5 relative. Where the same products are summed in the same order
(trimmed and whole windows, shards, tile widths, reruns) the bits agree.
"""
import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu_torch.experiments import chain_breakdown as cbd
from dmft_lanc_ed_tpu_torch.experiments import chain_probe as cpr
from dmft_lanc_ed_tpu_torch.experiments import trim_ab as tab
from dmft_lanc_ed_tpu_torch.ops import blocksparse as bs
from dmft_lanc_ed_tpu_torch.ops import bs_chain as bc
from dmft_lanc_ed_tpu_torch.ops.blocksparse import (build_blocksparse_op,
                                                    to_padded)
from dmft_lanc_ed_tpu_torch.parallel import bs_sharded as bsh
from dmft_lanc_ed_tpu_torch.parallel.mesh import make_mesh
from dmft_lanc_ed_tpu_torch.parallel.multihost import (allreduce_sites,
                                                       my_sites, rank_device,
                                                       run_local_ranks)

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
# B2/B3 pick their output tile from the grid and the card's SM count. On an
# H100 (132 SMs) these reach every instantiation: (11, (3, 4)) pads to
# 512 x 256, a grid far smaller than the card (64 x 32 tiles, as the first
# two); (11, (6, 5)) to 896 x 1024 (64 x 64); (12, (6, 6)) to 1792 x 1792,
# several waves (64 x 128)
TC_GEOMETRIES = GEOMETRIES + [(11, (3, 4)), (12, (6, 6))]


@pytest.mark.parametrize("nbath,sqn", TC_GEOMETRIES)
def test_tridiag_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    v0 = _starts(op, 1)[0]
    before = bc.launch_counts["tridiag"], bc.step_counts["tridiag"]
    al_k, be_k = bc.tridiag_call(op, v0, 32)
    assert bc.launch_counts["tridiag"] == before[0] + 1
    assert bc.step_counts["tridiag"] == before[1] + 32
    al_p, be_p = bc.tridiag_chain_plain(op.pop, v0[None], 32)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_k[:12] - al_p[0, :12]).abs().max()) < 5e-5 * scale
    assert float((be_k[:12] - be_p[0, :12]).abs().max()) < 5e-5 * scale
    al_r, be_r = bc.tridiag_call(op, v0, 32)             # rerun: same bits
    assert torch.equal(al_k, al_r) and torch.equal(be_k, be_r)


def _cheb_window(op, v0):
    al, be = bc.tridiag_chain_plain(op.pop, v0[None], 32)
    th = np.linalg.eigvalsh(np.diag(al[0].cpu().numpy())
                            + np.diag(be[0, :-1].cpu().numpy(), 1)
                            + np.diag(be[0, :-1].cpu().numpy(), -1))
    return 0.5 * (th[-1] + th[0]) + 0.1, 0.6 * (th[-1] - th[0])


@pytest.mark.parametrize("nbath,sqn", TC_GEOMETRIES)
def test_cheb_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    v0 = _starts(op, 1, 1)[0]
    c, e = _cheb_window(op, v0)
    before = bc.launch_counts["cheb"], bc.step_counts["cheb"]
    vk, nk = bc.cheb_call(op, v0, 32, c, 1.0 / e)
    assert bc.launch_counts["cheb"] == before[0] + 1
    assert bc.step_counts["cheb"] == before[1] + 32
    vp, npl = bc.cheb_chain_plain(op.pop, v0, 32, c, 1.0 / e)
    rel = float((vk / nk - vp / npl).norm() / (vp / npl).norm())
    assert rel < 1e-4
    assert bool(torch.all(vk[op.dim_dw:] == 0))          # pad stays zero
    assert bool(torch.all(vk[:, op.dim_up:] == 0))
    vr, nr = bc.cheb_call(op, v0, 32, c, 1.0 / e)        # rerun: same bits
    assert torch.equal(vk, vr) and torch.equal(nk, nr)


def test_chain_geometries_reach_every_output_tile(cuda):
    from dmft_lanc_ed_tpu_torch import _kernels
    lib = _kernels.lib()
    tiles = set()
    for nbath, sqn in TC_GEOMETRIES:
        cfg = pt.read_input(None, norb=1, nbath=nbath, uloc=(2.0,))
        sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
        tiles.add(lib.bs_chain_tc_tile(bs._pad128(sec.dim_dw),
                                       bs._pad128(sec.dim_up), 1, 2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert tiles == {32, 64, 128}
        # B4 (three parts) on (11, (3, 4)), 512 x 256: 64 x 32 tiles for
        # one chain, 64 x 128 for the five of the batch test below
        assert lib.bs_chain_tc_tile(512, 256, 1, 3) == 32
        assert lib.bs_chain_tc_tile(512, 256, 5, 3) == 128
    else:
        assert tiles <= {32, 64, 128}


def test_chain_kernel_stores_the_split_pair(cuda):
    """One B3 step with c = 0, e = 1 is r = H u: the kernel's product
    against the split plain product (the same bf16 x bf16 terms, summed in
    another order: 1e-6 x max|H u|), and near the true-f32 product (the
    split's ~1.5e-5)."""
    op = _op(cuda, 11, (5, 4))
    v0 = _starts(op, 1, 13)[0]
    hu, nrm = bc._run_cheb_tc(op.pop, v0, 1, 0.0, 1.0)
    ref = bc.hv_split(op.pop, v0)
    top = float(ref.abs().max())
    assert float((hu - ref).abs().max()) <= 1e-6 * top
    assert float((hu - bc._hv_plain(op.pop, v0)).abs().max()) <= 5e-5 * top
    assert abs(float(nrm) - float(ref.double().norm())) <= 1e-6 * float(nrm)


def _hv_f64(pop, u):
    """H_p u in f64 over the f32 operator values the kernels multiply."""
    d = pop.diag_a.double() @ pop.diag_b.double()
    u = u.double()
    return d * u + pop.hdw_p32.double() @ u + u @ pop.hup_p32.double()


@pytest.mark.parametrize("tile", [32, 128])
def test_six_pass_product_matches_plain(cuda, tile):
    """One H u of B4's product (six passes over the three-part split) at
    each of B4's output tile widths (a B4 ring of 64 x 64 would hold one
    block an SM, so the launcher never takes it: B4 has no such tile)
    against its plain version, within 1e-6 x max|H u|, and within 1e-6 x
    max|H u| of the f64 product."""
    op = _op(cuda, 11, (5, 4))
    v0 = _starts(op, 1, 13)[0]
    hu = bc._run_hv_tc(op.pop, v0, tile)
    ref = bc.hv_split3(op.pop, v0)
    top = float(ref.abs().max())
    assert float((hu - ref).abs().max()) <= 1e-6 * top
    assert float((hu.double() - _hv_f64(op.pop, v0)).abs().max()) <= \
        1e-6 * top
    assert bool(torch.all(hu[op.dim_dw:] == 0))          # pad stays zero
    assert bool(torch.all(hu[:, op.dim_up:] == 0))


@pytest.mark.parametrize("nbath,sqn", GEOMETRIES)
def test_gf_tridiag_kernel_matches_plain(cuda, nbath, sqn):
    op = _op(cuda, nbath, sqn)
    vb = _starts(op, 3, 2)
    bc.reset_launch_counts()
    al_k, be_k = bc.gf_tridiag_call(op, vb, 24)
    assert bc.launch_counts["gf_tridiag"] == 1
    assert bc.step_counts["gf_tridiag"] == 24
    assert bc.chains_per_launch["gf_tridiag"] == [3]
    al_p, be_p = bc.gf_tridiag_batch_plain(op.pop, vb, 24)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_k[:, :8] - al_p[:, :8]).abs().max()) < 5e-5 * scale
    assert float((be_k[:, :8] - be_p[:, :8]).abs().max()) < 5e-5 * scale
    al_r, be_r = bc.gf_tridiag_call(op, vb, 24)          # rerun: same bits
    assert torch.equal(al_k, al_r) and torch.equal(be_k, be_r)


# (11, (3, 4)) pads to 512 x 256: one chain takes 64 x 32 tiles, five take
# 64 x 128 (320 tiles of 64 x 32 exceed two blocks an SM on 132 SMs)
@pytest.mark.parametrize("nbath,sqn,nb", [(11, (3, 4), 5), (9, (5, 4), 3)])
def test_gf_tridiag_batch_equals_each_chain_alone(cuda, nbath, sqn, nb):
    """nb chains in one launch give each chain's bits run alone: every
    element's products and every partial sum of <u, y> are summed in an
    order that does not depend on the tile or on the other chains."""
    op = _op(cuda, nbath, sqn)
    vb = _starts(op, nb, 3)
    al_b, be_b = bc.gf_tridiag_call(op, vb, 32)
    for i in range(nb):
        al_1, be_1 = bc.gf_tridiag_call(op, vb[i:i + 1].contiguous(), 32)
        assert torch.equal(al_b[i], al_1[0]) and torch.equal(be_b[i], be_1[0])


def test_gf_tridiag_diagonal_and_mixed_chains_replica(cuda):
    """B4 on one GF target's batch of a replica bath (norb = 2, nbath = 3,
    the (4,4) target of 4,900 states): c+_0 v, c+_1 v and the mixed
    (c+_0 + c+_1) v in one launch, against the plain version; each chain's
    bits equal the chain run alone, and reruns are bit-identical."""
    from dmft_lanc_ed_tpu_torch.gf import apply_op
    cfg = pt.read_input(None, norb=2, nbath=3, bath_type="replica",
                        uloc=(2.0, 2.0), ust=1.0, jh=0.5)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = [[0.2, 0.1], [0.1, -0.2]]
    basis, lam = pt.decompose_hloc(cfg, hloc)
    bath = pt.init_bath(cfg, lam, basis)
    table = pt.SectorTable(cfg)
    sec_i, sec_j = table.sector(pt.qn(3, 4)), table.sector(pt.qn(4, 4))
    h = pt.build_sector_hamiltonian(cfg, sec_j, hloc, bath, h_basis=basis)
    op = build_blocksparse_op(h, cuda)
    v = np.random.default_rng(4).standard_normal(sec_i.dim)
    c = [apply_op(cfg, sec_i, sec_j, v, a, 0, True) for a in (0, 1)]
    vs = np.stack([c[0], c[1], c[0] + c[1]])
    vs /= np.linalg.norm(vs, axis=1)[:, None]
    vb = to_padded(op, vs.reshape(3, op.dim_dw, op.dim_up))
    bc.reset_launch_counts()
    al_b, be_b = bc.gf_tridiag_call(op, vb, 48)
    assert bc.chains_per_launch["gf_tridiag"] == [3]
    al_r, be_r = bc.gf_tridiag_call(op, vb, 48)
    assert torch.equal(al_b, al_r) and torch.equal(be_b, be_r)
    for i in range(3):
        al_1, be_1 = bc.gf_tridiag_call(op, vb[i:i + 1].contiguous(), 48)
        assert torch.equal(al_b[i], al_1[0]) and torch.equal(be_b[i], be_1[0])
    al_p, be_p = bc.gf_tridiag_batch_plain(op.pop, vb, 48)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_b[:, :8] - al_p[:, :8]).abs().max()) < 5e-5 * scale
    assert float((be_b[:, :8] - be_p[:, :8]).abs().max()) < 5e-5 * scale


def _kanamori3_chi_solve(cuda, nbath, sqn, **kw):
    """One T = 0 solve of the three-orbital Kanamori impurity with both
    susceptibilities, restricted to the sector `sqn`: (solver, result)."""
    from dmft_lanc_ed_tpu_torch.models import multiorb_kanamori as mk
    cfg = pt.EDConfig(nbath=nbath, beta=100.0, lmats=64, lreal=16,
                      chispin_flag=True, chidens_flag=True, ed_sectors=True,
                      ed_sectors_shift=0, **mk.DEFAULTS, **kw)
    solver = pt.EDSolver(cfg, np.zeros((1, 1, 3, 3)), device=cuda)
    solver.diag_state.sector_hint = [pt.qn(*sqn)]
    return solver, solver.solve(solver.init_bath())


def test_chi_chains_through_b4_on_the_card(cuda):
    """Every chi chain of a band-sparse sector through B4, 7 a launch (3
    diagonal, 3 mixed, the total) beside the GF's 3; chi on iv within B4's
    GF contract (2e-5 x max|chi|) of the dense f64 backend's solve on the
    card. nbath = 1: the half-filled (3,3) sector of 400 states has one
    ground state (at nbath = 2 the (4,4) ground state is four-fold
    degenerate, and the two of them a solve keeps make chi depend on the
    basis)."""
    from dmft_lanc_ed_tpu_torch import chi as pchi
    bc.reset_launch_counts()
    _, res = _kanamori3_chi_solve(cuda, 1, (3, 3), ed_backend="pallas",
                                  ed_batch_dim_max=100,
                                  ed_gf_chain_min_dim=100)
    k = res.state_list.size
    assert k == 1
    assert sorted(bc.chains_per_launch["gf_tridiag"]) == sorted(
        [3 * k, 3 * k, 7 * k, 7 * k])
    assert pchi.routing["spin"] == pchi.routing["dens"] == (7 * k, 0)
    _, ref = _kanamori3_chi_solve(cuda, 1, (3, 3), ed_backend="dense",
                                  ed_precision="f64")
    assert abs(ref.state_list.emin - res.state_list.emin) <= 1e-9
    vm = pt.solver.bosonic_grid(pt.EDConfig(beta=100.0, lmats=64))
    for kind in ("chi_spin", "chi_dens"):
        for key, want in getattr(ref, kind).items():
            a = getattr(res, kind)[key].matsubara(100.0, vm)
            b = want.matsubara(100.0, vm)
            assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max(), (kind, key)


def test_gf_tridiag_seven_chi_chains_equal_each_alone(cuda):
    """The 7 chi start vectors n_a|psi>, (n_a + n_b)|psi>, n|psi> of a
    ground state of the (4,4) sector at nbath = 2 (15,876 states) in one
    B4 launch: each chain's bits equal the chain run alone, and the batch
    agrees with the plain version (5e-5 x scale) over the first 8 steps
    (at nbath = 1 the total chain n|psi> of the (3,3) sector exhausts its
    Krylov space at step 6, beta ~ 1e-11 in f64, after which two runs
    follow their rounding)."""
    from dmft_lanc_ed_tpu_torch.chi import _diag_op_excite, _n_op
    solver, res = _kanamori3_chi_solve(cuda, 2, (4, 4), ed_backend="dense")
    cfg, st = solver.cfg, res.state_list.states[0]
    sec = solver.table.sector(st.qn)
    h = pt.build_sector_hamiltonian(cfg, sec, solver.hloc,
                                    pt.unpack_bath(cfg, solver.init_bath()))
    op = build_blocksparse_op(h, cuda)
    ops = [_n_op(cfg)(sec, a) for a in range(3)]
    ops += [ops[a] + ops[b] for a in range(3) for b in range(a + 1, 3)]
    ops.append(sum(ops[1:3], ops[0]))
    vs = np.stack([_diag_op_excite(sec, st.vec, o) for o in ops])
    vs /= np.linalg.norm(vs, axis=1)[:, None]
    vb = to_padded(op, vs.reshape(7, op.dim_dw, op.dim_up))
    bc.reset_launch_counts()
    al_b, be_b = bc.gf_tridiag_call(op, vb, 48)
    assert bc.chains_per_launch["gf_tridiag"] == [7]
    for i in range(7):
        al_1, be_1 = bc.gf_tridiag_call(op, vb[i:i + 1].contiguous(), 48)
        assert torch.equal(al_b[i], al_1[0]) and torch.equal(be_b[i], be_1[0])
    al_p, be_p = bc.gf_tridiag_batch_plain(op.pop, vb, 48)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_b[:, :8] - al_p[:, :8]).abs().max()) < 5e-5 * scale
    assert float((be_b[:, :8] - be_p[:, :8]).abs().max()) < 5e-5 * scale


def test_kernel_wrappers_refuse_bad_inputs(cuda):
    op = _op(cuda, 6, (3, 3))
    v0 = _starts(op, 1)[0]
    with pytest.raises(ValueError):
        bc.tridiag_call(op, v0.double(), 8)
    with pytest.raises(ValueError):
        bc.tridiag_call(op, v0[:, :64].contiguous(), 8)
    with pytest.raises(ValueError):
        bc.cheb_call(op, v0.double(), 8, 0.0, 1.0)
    with pytest.raises(ValueError):                       # not contiguous
        bc.tridiag_call(op, v0.t().contiguous().t(), 8)
    with pytest.raises(ValueError):
        bc.cheb_call(op, v0.t().contiguous().t(), 8, 0.0, 1.0)
    with pytest.raises(ValueError):                       # B4: f32 only
        bc.gf_tridiag_call(op, _starts(op, 2).double(), 8)
    with pytest.raises(ValueError):                       # B4: a batch
        bc.gf_tridiag_call(op, v0, 8)
    with pytest.raises(ValueError):
        bc.gf_tridiag_call(op, _starts(op, 2)[:, :, :64].contiguous(), 8)
    with pytest.raises(ValueError):
        bc.gf_tridiag_call(op, _starts(op, 2), 0)
    with pytest.raises(ValueError):                       # two vectors
        bc.tridiag_call(op, _starts(op, 2), 8)
    op_cpu = _op("cpu", 6, (3, 3))                       # slabs on the CPU
    with pytest.raises(ValueError):
        bc.tridiag_call(op_cpu, v0, 8)
    with pytest.raises(ValueError):
        bc.cheb_call(op_cpu, v0, 8, 0.0, 1.0)
    with pytest.raises(ValueError):
        bc.gf_tridiag_call(op_cpu, _starts(op, 2), 8)
    with pytest.raises(ValueError):
        bs.matvec_bs_padded(op, v0.double())
    with pytest.raises(ValueError):
        bs.matvec_bs_padded(op, _starts(op, 2))


B1_GEOMETRIES = [(6, (3, 3)), (11, (6, 6))]
# (6, (3, 0)): dim_dw = 1, so the dw panel holds one physical row and no
# nonzero tile: every block walks two stages (one up run of one tile);
# (6, (0, 0)): no run at all, the blocks walk one zero tile of the dw
# window; (10, (5, 5)): windows with two runs
B1_TRIM_GEOMETRIES = B1_GEOMETRIES + [(6, (3, 0)), (6, (0, 0)),
                                      (10, (5, 5))]


@pytest.mark.parametrize("nbath,sqn", B1_TRIM_GEOMETRIES)
def test_matvec_trimmed_equals_full_window(cuda, nbath, sqn):
    """B1a (trim runs) and B1b (whole windows) skip only exact-zero
    products, so they agree bit for bit, also where a block's run list is
    shorter than the pipeline's four stages or empty; the pad stays
    exactly zero."""
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


@pytest.mark.parametrize("nbath,sqn", B1_TRIM_GEOMETRIES)
def test_matvec_kernel_matches_plain(cuda, nbath, sqn):
    """Kernel vs plain version, both six-pass products in different
    orders: y to 1e-5 x max|y|, per-panel sums of squares 1e-5 relative."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 4)[0]
    y_k, ss_k = bs._matvec_padded(op, v, 0.5)
    y_p, ss_p = bs.matvec_bs_padded_plain(op.pop, v, 0.5)
    assert float((y_k - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    assert ss_k.shape == ss_p.shape
    assert float(((ss_k - ss_p).abs() / ss_p.abs().clamp(min=1e-30)).max()
                 ) <= 1e-5


def _tiles(op):
    """The tile widths of B1 on the op: the launcher's and the other."""
    from dmft_lanc_ed_tpu_torch import _kernels
    mine = _kernels.lib().bs_matvec_tile(*op.padded_shape)
    assert mine in (32, 128)
    return mine, 160 - mine


@pytest.mark.parametrize("nbath,sqn", B1_TRIM_GEOMETRIES)
def test_matvec_bits_across_tiles_and_reruns(cuda, nbath, sqn):
    """Every element's products are summed in one order whatever the tile
    width, and the panel sums from one partial per 64 x 32 sub-tile: y and
    ss are the same bits at 64 x 32 and 64 x 128 tiles, trimmed or not, and
    on a rerun."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 12)[0]
    mine, other = _tiles(op)
    for trim in (True, False):
        y, ss = bs._matvec_padded(op, v, 0.75, trim=trim)
        for tile in (mine, other, 0):
            y_t, ss_t = bs._matvec_padded(op, v, 0.75, trim=trim, tile=tile)
            assert torch.equal(y_t, y) and torch.equal(ss_t, ss)


def test_matvec_product_against_f64(cuda):
    """One B1b product at (11, (6, 6)) against the f64 product of the same
    u over the same f32 operator: within 1e-6 x max|H u| and within 2x the
    error of the FP32 product of cuBLAS (TF32 off)."""
    op = _op(cuda, 11, (6, 6))
    v = _starts(op, 1, 14)[0]
    ref = _hv_f64(op.pop, v)
    top = float(ref.abs().max())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        e32 = float((bs._hv_plain(op.pop, v).double() - ref).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    y = bs._matvec_padded(op, v, 1.0, trim=False)[0]
    e6 = float((y.double() - ref).abs().max())
    assert e6 <= 1e-6 * top and e6 <= 2 * e32


def test_split_kernel_matches_plain(cuda):
    """The split launch of B1/B5 gives torch's round-to-nearest-even split
    bit for bit, the three parts one after the other."""
    x = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (384, 256)) * np.logspace(-6, 3, 256), dtype=torch.float32,
        device=cuda)
    parts = bs.split3_rows(x)
    assert parts.shape == (3, 384, 256) and parts.dtype == torch.bfloat16
    assert torch.equal(parts, bs.split3_rows_plain(x))


def test_matvec_in_a_cuda_graph(cuda):
    """A B1 call (split, product, panel sums by the last block) and a B5
    call capture into a CUDA graph, whose replay gives the eager bits; the
    scale may be a device scalar."""
    op = _op(cuda, 10, (5, 5))
    v = _starts(op, 1, 16)[0]
    r = torch.full((), 0.5, device=cuda)
    sh = bsh.shard_bs_op(op, 2, 1, cuda)
    v_loc, v_ext = bsh.shard_rows(v, sh)
    y_e, ss_e = bs._matvec_padded(op, v, r)
    y5_e, ss5_e = bsh._local_call(sh, v_loc, v_ext)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bs._matvec_padded(op, v, r)
        bsh._local_call(sh, v_loc, v_ext)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, ss_g = bs._matvec_padded(op, v, r)
        y5_g, ss5_g = bsh._local_call(sh, v_loc, v_ext)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_g, y_e) and torch.equal(ss_g, ss_e)
        assert torch.equal(y5_g, y5_e) and torch.equal(ss5_g, ss5_e)


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


B5_GEOMETRIES = [(10, (5, 5)), (11, (6, 6))]     # the sectors B5 takes at n=2


@pytest.mark.parametrize("nbath,sqn", B5_GEOMETRIES)
def test_sharded_matvec_matches_plain(cuda, nbath, sqn):
    """B5 on each of 2 shards vs its plain version: y to 1e-5 x max|y|,
    panel sums of squares 1e-5 relative (six-pass products summed in other
    orders)."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 6)[0]
    for d in range(2):
        sh = bsh.shard_bs_op(op, 2, d, cuda)
        v_loc, v_ext = bsh.shard_rows(v, sh)
        before = bsh.launch_counts["sharded_matvec"]
        y_k, ss_k = bsh._local_call(sh, v_loc, v_ext)
        assert bsh.launch_counts["sharded_matvec"] == before + 1
        y_p, ss_p = bsh._local_call_plain(sh, v_loc, v_ext)
        assert float((y_k - y_p).abs().max()) <= \
            1e-5 * float(y_p.abs().max())
        assert float(((ss_k - ss_p).abs() / ss_p.abs().clamp(min=1e-30)
                      ).max()) <= 1e-5


@pytest.mark.parametrize("nbath,sqn", B5_GEOMETRIES)
def test_sharded_matvec_stitched_equals_whole_window(cuda, nbath, sqn):
    """The shards of B5 multiply B1b's window tiles in B1b's order, and no
    clamped window reaches an edge shard's zero halo: stitched, they equal
    B1b bit for bit."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 7)[0]
    y_b, ss_b = bs._matvec_padded(op, v, 1.0, trim=False)
    shards = [bsh.shard_bs_op(op, 2, d, cuda) for d in range(2)]
    for tile in (0, 32, 128):      # the shard's tile, then both widths
        parts = [bsh._local_call(sh, *bsh.shard_rows(v, sh), tile=tile)
                 for sh in shards]
        assert torch.equal(torch.cat([y for y, _ in parts]), y_b)
        assert torch.equal(torch.cat([ss for _, ss in parts]), ss_b)


def test_sharded_matvec_refuses_bad_inputs(cuda):
    op = _op(cuda, 10, (5, 5))
    sh = bsh.shard_bs_op(op, 2, 0, cuda)
    v_loc, v_ext = bsh.shard_rows(_starts(op, 1, 8)[0], sh)
    with pytest.raises(ValueError):
        bsh._local_call(sh, v_loc.double(), v_ext.double())
    with pytest.raises(ValueError):
        bsh._local_call(sh, v_loc, v_ext[:-128].contiguous())


@pytest.mark.parametrize("kk", [1, 7, 71])
def test_chain_probe_kernel_matches_plain(cuda, kk):
    """E1, one cluster launch of kk steps: one launch a call, reruns
    bit-identical, within the probe's gates (norms 1e-5, vout 1e-4
    relative) of its six-pass plain version and of the f32 chain."""
    v0, a = cpr.probe_inputs(cuda)
    before = cpr.launch_counts["chain_probe"]
    n_k, v_k = cpr.chain(v0, a, kk)
    assert cpr.launch_counts["chain_probe"] == before + 1
    n_r, v_r = cpr.chain(v0, a, kk)
    assert torch.equal(n_r, n_k) and torch.equal(v_r, v_k)
    n_p, v_p = cpr.chain_plain(v0, a, kk)
    assert float((n_k - n_p).abs().max()) <= 1e-5 * float(n_p.abs().max())
    assert float((v_k - v_p).abs().max()) <= 1e-4 * float(v_p.abs().max())
    n_f, v_f = cpr.reference(v0.cpu().numpy(), a.cpu().numpy(), kk)
    n_k, v_k = n_k.cpu().numpy().ravel(), v_k.cpu().numpy()
    assert np.abs(n_k - n_f).max() <= 1e-5 * np.abs(n_f).max()
    assert np.abs(v_k - v_f).max() <= 1e-4 * np.abs(v_f).max()


def test_chain_probe_clock_trace(cuda):
    """E1's clock trace: the step's four phases are shares, none negative,
    that add up to the step."""
    v0, a = cpr.probe_inputs(cuda)
    ph = cpr.step_phases(v0, a, 12)
    parts = [ph[k] for k in ("product", "epilogue", "barrier", "rest")]
    assert all(p >= 0 for p in parts) and abs(sum(parts) - 1) < 1e-9
    assert ph["step_clocks"] > 0


def test_chain_probe_refuses_unsupported_shapes(cuda):
    """E1's wrapper raises on a CUDA tensor it cannot take, launching
    nothing and not falling back; below 256 rows it pads, and the kernel's
    rows equal the full-size kernel's on a zero-padded input."""
    v0, a = cpr.probe_inputs(cuda)
    before = cpr.launch_counts["chain_probe"]
    for args in ((torch.zeros((320, 128), device=cuda),
                  torch.zeros((320, 320), device=cuda)),
                 (v0[:, :64].contiguous(), a), (v0.double(), a)):
        with pytest.raises(ValueError):
            cpr.chain(*args)
    assert cpr.launch_counts["chain_probe"] == before
    n = 192
    v0s, a_s = v0[:n].contiguous(), a[:n, :n].contiguous()
    n_s, v_s = cpr.chain(v0s, a_s, 5)
    pad = torch.zeros_like(v0)
    pad[:n] = v0s
    a_pad = torch.zeros_like(a)
    a_pad[:n, :n] = a_s
    n_f, v_f = cpr.chain(pad, a_pad, 5)
    assert torch.equal(n_s, n_f) and torch.equal(v_s, v_f[:n])
    assert not v_f[n:].any()


def test_chain_probe_takes_offset_views(cuda):
    """E1 on contiguous views at a storage offset of one float (not 16-byte
    aligned, which the kernel's bulk copy of A needs): the same bits as on
    the tensors themselves, no fault."""
    v0, a = cpr.probe_inputs(cuda)
    views = []
    for x in (v0, a):
        buf = torch.zeros(x.numel() + 1, device=cuda)
        view = buf[1:].view_as(x)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        views.append(view)
    n_k, v_k = cpr.chain(v0, a, 7)
    n_o, v_o = cpr.chain(*views, 7)
    assert torch.equal(n_o, n_k) and torch.equal(v_o, v_k)


E_GEOMETRIES = [(10, (5, 5)), (11, (5, 5))]
# E2 also where a dw panel lists no tile ((6, (3, 0)): dim_dw = 1) and where
# no block lists any ((6, (0, 0)): every block walks one zero tile)
E2_GEOMETRIES = E_GEOMETRIES + [(6, (3, 0)), (6, (0, 0))]


def _trim_forms(op):
    return [tab.make_variant(op, m) for m in tab.MODES] \
        + [tab.make_static_runs(op)]


@pytest.mark.parametrize("nbath,sqn", E2_GEOMETRIES)
def test_trim_forms_match_plain_bit_identical(cuda, nbath, sqn):
    """E2's five forms (tile lists in four modes, the trim runs) against
    the plain version (y 1e-5 x max|y|, panel sums 1e-5 relative; split-
    bf16 products summed in other orders), and bit-identical to each other:
    every form walks the same nonzero tiles in ascending order."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 9)[0]
    y_p, ss_p = tab.matvec_plain(op, v, 0.5)
    before = dict(tab.launch_counts)
    outs = [c(v, 0.5) for c in _trim_forms(op)]
    assert tab.launch_counts["trim_tiles"] == before["trim_tiles"] + 4
    assert tab.launch_counts["trim_static_runs"] == \
        before["trim_static_runs"] + 1
    y0, ss0 = outs[0]
    assert float((y0 - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    assert float(((ss0 - ss_p).abs() / ss_p.abs().clamp(min=1e-30)).max()
                 ) <= 1e-5
    for y, ss in outs[1:]:
        assert torch.equal(y, y0) and torch.equal(ss, ss0)


@pytest.mark.parametrize("nbath,sqn", E2_GEOMETRIES)
def test_trim_bits_across_tiles_and_reruns(cuda, nbath, sqn):
    """E2 sums every element's products in one order whatever the tile
    width, and its panel sums from one partial per 64 x 32 sub-tile: y and
    ss are the same bits at 64 x 32, 64 x 64 and 64 x 128 (the launcher's
    width among them) and on a rerun, in every form; a call is two
    launches (the split, the product)."""
    op = _op(cuda, nbath, sqn)
    v = _starts(op, 1, 18)[0]
    for call in _trim_forms(op):
        y, ss = call(v, 0.75)
        for tile in (32, 64, 128, 0):
            before = sum(tab.kernel_launches.values())
            y_t, ss_t = call(v, 0.75, tile=tile)
            assert sum(tab.kernel_launches.values()) == before + 2
            assert torch.equal(y_t, y) and torch.equal(ss_t, ss)


@pytest.mark.parametrize("mode", cbd.MODES)
def test_chain_breakdown_two_launches_a_step(cuda, mode):
    """E3 runs each step as two kernel launches (the product with its
    epilogue, then the orthogonalization), in every form, as counted by
    the launcher; a rerun gives the same bits."""
    op = _op(cuda, 10, (5, 5))
    v = _starts(op, 1, 19)[0]
    call = cbd.make_variant(op, mode)
    cbd.reset_launch_counts()
    al, be = call(v, 12)
    assert cbd.launch_counts["chain_breakdown"] == 1
    assert cbd.step_counts["chain_breakdown"] == 12
    assert cbd.kernel_launches["chain_breakdown"] == 2 * 12
    al_r, be_r = call(v, 12)
    assert torch.equal(al_r, al) and torch.equal(be_r, be)


def test_probes_in_a_cuda_graph(cuda):
    """An E2 call (split, product, panel sums by the last block; the scale
    a device scalar), an E3 chain (two launches a step, the state on the
    card) and an E1 chain (a cluster launch) capture into a CUDA graph,
    whose replay gives the eager bits."""
    op = _op(cuda, 10, (5, 5))
    v = _starts(op, 1, 20)[0]
    r = torch.full((), 0.5, device=cuda)
    e2 = tab.make_variant(op, "both")
    e3 = cbd.make_variant(op, "tileskip")
    p0, pa = cpr.probe_inputs(cuda)
    y_e, ss_e = e2(v, r)
    al_e, be_e = e3(v, 10)
    n_e, w_e = cpr.chain(p0, pa)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        e2(v, r)
        e3(v, 10)
        cpr.chain(p0, pa)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, ss_g = e2(v, r)
        al_g, be_g = e3(v, 10)
        n_g, w_g = cpr.chain(p0, pa)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_g, y_e) and torch.equal(ss_g, ss_e)
        assert torch.equal(al_g, al_e) and torch.equal(be_g, be_e)
        assert torch.equal(n_g, n_e) and torch.equal(w_g, w_e)


@pytest.mark.parametrize("mode", cbd.MODES)
def test_chain_breakdown_kernel_matches_plain(cuda, mode):
    """E3, each product form, against its plain version: the first 16
    alpha, beta within 1e-4 x max(1, |alpha|max) (phase 2's B2 gate)."""
    op = _op(cuda, 10, (5, 5))
    v = _starts(op, 1, 10)[0]
    before = cbd.launch_counts["chain_breakdown"]
    al_k, be_k = cbd.make_variant(op, mode)(v, 32)
    assert cbd.launch_counts["chain_breakdown"] == before + 1
    al_p, be_p = cbd.chain_plain(op, v, 32, mode)
    scale = max(1.0, float(al_p.abs().max()))
    assert float((al_k[:16] - al_p[:16]).abs().max()) <= 1e-4 * scale
    assert float((be_k[:16] - be_p[:16]).abs().max()) <= 1e-4 * scale


def test_chain_breakdown_forms_on_card(cuda):
    """tileskip skips only zero tiles: the same bits as 3pass; bf16pair is
    3pass with its vectors rounded to hi + lo: within 1e-4 x scale."""
    op = _op(cuda, 10, (5, 5))
    v = _starts(op, 1, 11)[0]
    a3, b3 = cbd.make_variant(op, "3pass")(v, 16)
    a_s, b_s = cbd.make_variant(op, "tileskip")(v, 16)
    assert torch.equal(a_s, a3) and torch.equal(b_s, b3)
    a_p, b_p = cbd.make_variant(op, "bf16pair")(v, 16)
    scale = max(1.0, float(a3.abs().max()))
    assert float((a_p - a3).abs().max()) <= 1e-4 * scale
    assert float((b_p - b3).abs().max()) <= 1e-4 * scale


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL takes one rank per card)")


def _nccl_sites_rank(rank):
    """Host arrays merged over NCCL: the mesh stages them through the
    rank's card."""
    local = {i: np.full((2, 3), 10.0 * i + 1.0) for i in my_sites(5)}
    return allreduce_sites(local, 5, (2, 3))


def _nccl_ground_state_rank(rank):
    """The sharded band-sparse ground state at nbath = 10, (5,5), each rank
    on its own card, the halo exchange and the sums over NCCL."""
    dev = rank_device()
    mesh = make_mesh(2, dev)
    op = _op("cpu", 10, (5, 5))
    cfg = pt.read_input(None, norb=1, nbath=10, uloc=(2.0,))
    before = bsh.launch_counts["sharded_matvec"]
    vals, vecs = bsh.bs_sharded_ground_state(cfg, op, mesh, 1, ncv=32)
    return (mesh.transport, str(dev), vals, vecs,
            bsh.launch_counts["sharded_matvec"] - before)


def test_sites_merge_over_nccl(cuda, two_cards):
    out = run_local_ranks(_nccl_sites_rank, 2, device="cuda", timeout=300)
    expect = np.stack([np.full((2, 3), 10.0 * i + 1.0) for i in range(5)])
    for merged in out:
        np.testing.assert_array_equal(merged, expect)


def test_sharded_ground_state_over_nccl(cuda, two_cards):
    """Two ranks, one card each: NCCL carries the collectives, B5 launches
    on both cards, and the ground state equals the one-card two-stage
    solve's to 1e-9 (the JAX sharded test's gate), the same bits on both
    ranks."""
    from dmft_lanc_ed_tpu_torch import _kernels
    from dmft_lanc_ed_tpu_torch.diag import _blocksparse_ground_state
    _kernels.build()                # once, before the ranks load it
    out = run_local_ranks(_nccl_ground_state_rank, 2, device="cuda",
                          timeout=300)
    op = _op(cuda, 10, (5, 5))
    cfg = pt.read_input(None, norb=1, nbath=10, uloc=(2.0,))
    e_ref, _ = _blocksparse_ground_state(cfg, op, op.dim, 1, ncv=32)
    assert [o[1] for o in out] == ["cuda:0", "cuda:1"]
    for transport, _, vals, vecs, launches in out:
        assert transport == "nccl" and launches > 0
        assert abs(vals[0] - e_ref[0]) <= 1e-9
        assert vals.tobytes() == out[0][2].tobytes()
        assert vecs.tobytes() == out[0][3].tobytes()


def test_lattice_sites_on_two_cards(cuda, two_cards):
    """The lattice bank's default, every visible card: two sites with
    band-sparse sectors (nbath = 7, sectors above 2,000 states; the two
    sites differ by their U) solve on cuda:0 and cuda:1 from one process.
    B2, B3 and B4 launch, and each site equals the same site solved on
    cuda:0 (Egs and dens 1e-10, G(iw) 1e-8)."""
    cfg = pt.EDConfig(norb=1, nspin=1, nbath=7, uloc=(2.0,), beta=50.0,
                      lmats=128, lreal=16, ed_backend="pallas",
                      ed_batch_dim_max=2000, ed_gf_chain_min_dim=2000)
    uloc_ii = np.array([[2.0], [3.0]])
    lat = pt.LatticeSolver(cfg, 2, uloc_ii=uloc_ii)
    assert [str(s.device) for s in lat.solvers] == ["cuda:0", "cuda:1"]
    baths = lat.init_baths()
    bc.reset_launch_counts()
    res = lat.solve(baths)
    assert all(n > 0 for n in bc.launch_counts.values()), bc.launch_counts
    ref = pt.LatticeSolver(cfg, 2, uloc_ii=uloc_ii,
                           device="cuda:0").solve(baths)
    np.testing.assert_allclose(res.dens, ref.dens, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.g_mats, ref.g_mats, rtol=0, atol=1e-8)
    for r, r0 in zip(res.results, ref.results):
        assert abs(r.observables.egs - r0.observables.egs) <= 1e-10
    assert abs(res.results[0].observables.egs
               - res.results[1].observables.egs) > 1e-3


def test_kanamori_driver_on_the_band_sparse_path(cuda):
    """The three-orbital Kanamori driver, one loop on the card with its
    sectors above 4,000 states band-sparse (nbath = 2: (4,4) of 15,876
    states and its neighbours): B2, B3 and B4 launch, every chain seed
    reaches its eta_target, the orbitals stay degenerate, and loop 1's Egs
    equals the dense f64 backend's solve of the same bath on the card
    (1e-9)."""
    from dmft_lanc_ed_tpu_torch.models import multiorb_kanamori as mk
    kw = dict(nbath=2, beta=50.0, lmats=128, lfit=64, lreal=16, nloop=1,
              **mk.DEFAULTS)
    cfg = pt.EDConfig(ed_backend="pallas", ed_batch_dim_max=4000,
                      ed_gf_chain_min_dim=4000, **kw)
    bc.reset_launch_counts()
    res = mk.run_dmft(cfg, device=cuda, verbose=False)
    assert all(n > 0 for n in bc.launch_counts.values()), bc.launch_counts
    assert bc.seed_counts["missed"] == 0 and bc.seed_counts["reached"] > 0
    ent = res.history[0]
    assert ent["routing"][0] > 0
    assert ent["timings"]["kernel_matvecs"] >= sum(bc.step_counts.values())
    assert np.ptp(ent["dens"]) < 1e-6 and np.ptp(ent["docc"]) < 1e-6
    dense = pt.EDSolver(pt.EDConfig(ed_backend="dense", ed_precision="f64",
                                    **kw), np.zeros((1, 1, 3, 3)),
                        device=cuda)
    assert abs(dense.solve(ent["bath"]).observables.egs - ent["egs"]) <= 1e-9


def test_finite_t_solve_on_the_band_sparse_path(cuda):
    """A finite-T solve (ten states, two a sector) of a two-orbital
    impurity with a crystal field, nbath = 3, its (4,4) sector of 4,900
    states band-sparse and its GF targets of 3,920 through B4: B2, B3 and
    B4 launch, every chain seed reaches its eta_target, each Krylov
    sector's k lowest values equal those of its dense matrix by f64 eigh
    on the card (1e-9; the (3,3) ground state is two-fold, which a
    single-vector f64 Lanczos solve from one random start finds once: it
    is no reference here), and G(iw) and chi(iv) meet B4's contract (2e-5
    x max|f|) against f64 chains from the same states and start
    vectors."""
    from dmft_lanc_ed_tpu_torch import chi as pchi
    from dmft_lanc_ed_tpu_torch import gf as pgf
    from dmft_lanc_ed_tpu_torch.ops.factory import exact_apply
    kw = dict(norb=2, nbath=3, uloc=(2.0, 2.0), ust=1.0, jh=0.3, beta=50.0,
              lmats=128, lreal=16, ed_finite_temp=True,
              lanc_nstates_total=10, chispin_flag=True)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.diag([0.2, -0.2])
    cfg = pt.EDConfig(ed_backend="pallas", ed_batch_dim_max=4000,
                      ed_gf_chain_min_dim=3000, **kw)
    solver = pt.EDSolver(cfg, hloc, device=cuda)
    packed = solver.init_bath()
    bc.reset_launch_counts()
    res = solver.solve(packed)
    assert all(n > 0 for n in bc.launch_counts.values()), bc.launch_counts
    assert bc.seed_counts["missed"] == 0 and bc.seed_counts["reached"] > 0
    assert res.gf.routing[0] > 0
    bath = pt.unpack_bath(cfg, packed)
    for q, e, krylov in res.state_list.diag_log:
        if not krylov:
            continue
        h = pt.build_sector_hamiltonian(cfg, solver.table.sector(q), hloc,
                                        bath)
        w = torch.linalg.eigvalsh(torch.as_tensor(pt.dense_hamiltonian(h),
                                                  device=cuda))
        np.testing.assert_allclose(e, w[:len(e)].cpu().numpy(), rtol=0,
                                   atol=1e-9, err_msg=str(q))

    class F64(pgf.HCache):
        def _build(self, sec):
            op, _ = super()._build(sec)
            return op, exact_apply(op)
    cfg64 = cfg.replace(ed_gf_chain_min_dim=1 << 62)
    cache = F64(cfg64, solver.table, solver.hloc,
                pt.unpack_bath(cfg, packed), device=cuda)
    gf64 = pgf.build_gf_normal(cfg64, solver.table, cache, res.state_list)
    g64 = gf64.evaluate(cfg, 1j * pt.matsubara_grid(cfg))
    assert np.abs(res.g_mats - g64).max() <= 2e-5 * np.abs(g64).max()
    chi64 = pchi.build_chi_spin(cfg64, solver.table, cache, res.state_list)
    vm = pt.solver.bosonic_grid(cfg)
    for key, b in chi64.items():
        a = res.chi_spin[key].matsubara(cfg.beta, vm)
        b = b.matsubara(cfg.beta, vm)
        assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max(), key


def test_lattice_dryrun_two_ranks_share_the_card(cuda):
    """The two-rank lattice dryrun with both ranks on the one card (gloo,
    staged through host memory): the merged arrays identical on both ranks
    and equal to the one-process bank on the card (dens, Egs 1e-10, Sigma
    1e-7, the fitted baths 1e-8: tests/test_multihost.py's gates)."""
    from dmft_lanc_ed_tpu_torch.parallel import multihost_dryrun as dry
    r0, r1 = run_local_ranks(dry.dryrun_rank, 2, args=("cuda",),
                             device="cuda", timeout=300)
    assert r0["device"].startswith("cuda") and r1["device"].startswith("cuda")
    for k in ("sigma_mats", "g_mats", "dens", "docc", "egs", "fitted"):
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    arrays, fitted = dry.solve_merged(cuda)
    np.testing.assert_allclose(r0["dens"], arrays.dens, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r0["egs"], arrays.egs, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r0["sigma_mats"], arrays.sigma_mats, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(r0["fitted"], fitted, rtol=0, atol=1e-8)


@pytest.mark.parametrize("sqn", [(4, 4), (5, 3)])
def test_ell_direct_and_band_applies_agree(cuda, sqn):
    """At nbath = 7 on the card: the ELL and direct applies against the
    f64-exact band apply on three random vectors, max|d| <= 1e-12 x
    max|Hv| (the f64 backends' contract)."""
    from dmft_lanc_ed_tpu_torch.ops.direct import (build_direct_op,
                                                   matvec_direct_flat)
    from dmft_lanc_ed_tpu_torch.ops.matvec import ell_op, matvec_flat
    cfg = pt.read_input(None, norb=1, nbath=7, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    hloc, bath = np.zeros((1,) * 4), pt.init_bath(cfg)
    h = pt.build_sector_hamiltonian(cfg, sec, hloc, bath)
    op = build_blocksparse_op(h, cuda)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (3, sec.dim)), device=cuda)
    y_ref = bs.matvec_bs_exact_flat(op, x)
    scale = float(y_ref.abs().max())
    y_ell = matvec_flat(ell_op(h, cuda), x)
    y_dir = matvec_direct_flat(build_direct_op(cfg, sec, hloc, bath, cuda),
                               x)
    assert y_ell.device.type == y_dir.device.type == "cuda"
    assert float((y_ell - y_ref).abs().max()) <= 1e-12 * scale
    assert float((y_dir - y_ref).abs().max()) <= 1e-12 * scale


# the sharded direct and Jx/Jp dense operators (ROADMAP A10): (config
# kwargs, sector) of each apply
A10_APPLY = {
    "direct": (dict(norb=1, nbath=9, uloc=(2.0,), ed_backend="direct"),
               (5, 5)),
    "jxjp": (dict(norb=2, nbath=3, uloc=(2.0, 2.0), ust=1.0, jh=0.5, jx=0.5,
                  jp=0.5, ed_backend="dense"), (4, 4)),
}


def _a10_inputs(name):
    kw, sqn = A10_APPLY[name]
    cfg = pt.read_input(None, **kw)
    sec = pt.SectorTable(cfg).sector(pt.qn(*sqn))
    x = np.random.default_rng(11).standard_normal((2, sec.dim))
    return cfg, sec, np.zeros((1, 1, cfg.norb, cfg.norb)), x


def _a10_apply_rank(rank):
    """The sharded direct apply and the Jx/Jp dense applies (f64 and the
    production mixed one) of two vectors, each rank on its device."""
    from dmft_lanc_ed_tpu_torch.parallel import production as prod
    mesh = make_mesh(2, rank_device())
    out = {"transport": mesh.transport, "device": str(mesh.device)}
    for name in A10_APPLY:
        cfg, sec, hloc, x = _a10_inputs(name)
        sop = prod.shard_sector_op(cfg, sec, hloc, pt.init_bath(cfg), None,
                                   mesh)
        xp = sop.pad_flat_batch(x)
        out[name] = {f.__name__: sop.unpad_gather(f(sop, xp))
                     for f in {sop.exact_nd, sop.apply_nd}}
    return out


def test_a10_applies_over_nccl_equal_gloo(cuda, two_cards, monkeypatch):
    """Two ranks, one card each over NCCL, against two ranks sharing one
    card over gloo: the sharded direct and Jx/Jp dense applies bit-equal
    (the collectives move the same numbers, and the sums run in rank
    order), and their f64 applies within 1e-12 x max|Hv| of the one-card
    unsharded apply."""
    from dmft_lanc_ed_tpu_torch.ops.dense import (build_dense_op,
                                                  matvec_dense_flat)
    from dmft_lanc_ed_tpu_torch.ops.direct import (build_direct_op,
                                                   matvec_direct_flat)
    nccl = run_local_ranks(_a10_apply_rank, 2, device="cuda", timeout=300)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    gloo = run_local_ranks(_a10_apply_rank, 2, device="cuda", timeout=300)
    assert [o["transport"] for o in nccl] == ["nccl", "nccl"]
    assert [o["device"] for o in nccl] == ["cuda:0", "cuda:1"]
    assert [o["transport"] for o in gloo] == ["gloo", "gloo"]
    for name, (build, apply) in (("direct", (build_direct_op,
                                             matvec_direct_flat)),
                                 ("jxjp", (build_dense_op,
                                           matvec_dense_flat))):
        cfg, sec, hloc, x = _a10_inputs(name)
        op = build(cfg, sec, hloc, pt.init_bath(cfg), cuda)
        y_ref = apply(op, torch.as_tensor(x, device=cuda)).cpu().numpy()
        scale = np.abs(y_ref).max()
        for key, y in nccl[0][name].items():
            for o in nccl[1:] + gloo:
                assert o[name][key].tobytes() == y.tobytes(), (name, key)
        exact = ("apply_direct_sharded" if name == "direct"
                 else "matvec_dense_sharded")
        assert np.abs(nccl[0][name][exact] - y_ref).max() <= 1e-12 * scale
        if name == "jxjp":       # the production apply is the mixed one
            assert np.abs(nccl[0][name]["matvec_dense_sharded_mixed"]
                          - y_ref).max() <= 1e-6 * scale


def _large_direct_rank(rank):
    """The 2.9M-state (6,7) sector of nbath = 12 over the sharded direct
    backend: this rank's payload and the f64 ground state."""
    from dmft_lanc_ed_tpu_torch.ops.direct import build_direct_op
    from dmft_lanc_ed_tpu_torch.parallel import production as prod
    cfg = pt.read_input(None, norb=1, nbath=12, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(6, 7))
    mesh = make_mesh(2, rank_device())
    sop = prod.shard_direct_op(build_direct_op(
        cfg, sec, np.zeros((1,) * 4), pt.init_bath(cfg), "cpu"), mesh, cfg)
    v0 = sop.pad_flat(np.random.default_rng(1).standard_normal(sec.dim))
    evals, _ = prod.sharded_ground_state(sop, 1, 24, 1e-12, v0)
    return sop.op.nbytes, float(evals[0]), mesh.transport


def test_sharded_direct_large_sector_ground_state(cuda):
    """nbath = 12: the 2.9M-state (6,7) sector over two ranks (one card
    each over NCCL, or sharing one over gloo): each rank's payload under
    half the dense hdw's bytes, E < 0, and, beyond the JAX test's bar
    (test_production_sharding.py:132-165), within 1e-9 of the one-card
    direct solve."""
    from dmft_lanc_ed_tpu_torch.ops.direct import (build_direct_op,
                                                   matvec_direct_flat)
    from dmft_lanc_ed_tpu_torch.ops.lanczos import lanczos_ground_state
    out = run_local_ranks(_large_direct_rank, 2, device="cuda", timeout=600)
    cfg = pt.read_input(None, norb=1, nbath=12, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(6, 7))
    op = build_direct_op(cfg, sec, np.zeros((1,) * 4), pt.init_bath(cfg),
                         cuda)
    e_one, _ = lanczos_ground_state(op, matvec_direct_flat, sec.dim, 1,
                                    ncv=24, tol=1e-12)
    for payload, e, _ in out:
        assert payload < sec.dim_dw ** 2 * 8 / 2
        assert e < 0.0 and abs(e - e_one[0]) <= 1e-9
        assert e == out[0][1]
