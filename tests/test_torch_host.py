"""PyTorch port, host layer: the same inputs through the JAX package and the
port give identical sector tables, Hamiltonian factor tables and
band-sparse operators; the state converters round-trip; the port never
imports JAX.

Host numpy code is copied or re-expressed without changing its arithmetic,
so these comparisons are exact (np.array_equal), except the f32 slabs and
diagonal factors, which both packages round from the same f64 arrays and
therefore also compare exactly.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.ops.blocksparse import \
    build_blocksparse_op as jax_build_bs
from dmft_lanc_ed_tpu_torch.convert import (bath_from_reference,
                                            hamiltonian_from_reference)
from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: one intra-op thread is as
    fast and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = [
    dict(norb=1, nbath=5, uloc=(1.8,)),
    dict(norb=1, nbath=6, uloc=(2.0,)),
    dict(norb=2, nbath=2, uloc=(1.0, 1.5), ust=0.3, jh=0.05),
]


def _random_packed_bath(cfg, seed):
    """A packed normal bath from numpy (the layout both packages share)."""
    rng = np.random.default_rng(seed)
    n = cfg.nspin * cfg.norb * cfg.nbath
    return np.concatenate([rng.normal(size=n), 0.5 * rng.normal(size=n)])


def _both_hamiltonians(kw, sqn, seed=0):
    cfg_j, cfg_p = ed.read_input(None, **kw), pt.read_input(None, **kw)
    packed = _random_packed_bath(cfg_j, seed)
    hloc = np.zeros((1, 1, cfg_j.norb, cfg_j.norb))
    sec_j = ed.SectorTable(cfg_j).sector(sqn)
    sec_p = pt.SectorTable(cfg_p).sector(sqn)
    h_j = ed.build_sector_hamiltonian(cfg_j, sec_j, hloc,
                                      ed.unpack_bath(cfg_j, packed))
    h_p = pt.build_sector_hamiltonian(cfg_p, sec_p, hloc,
                                      bath_from_reference(packed, cfg_p))
    return h_j, h_p


@pytest.mark.parametrize("kw", CONFIGS)
def test_sector_tables_equal(kw):
    tab_j = ed.SectorTable(ed.read_input(None, **kw))
    tab_p = pt.SectorTable(pt.read_input(None, **kw))
    assert tab_j.all_qns() == tab_p.all_qns()
    for sqn in tab_j.all_qns():
        s_j, s_p = tab_j.sector(sqn), tab_p.sector(sqn)
        assert (s_j.dim_up, s_j.dim_dw, s_j.dim) == \
            (s_p.dim_up, s_p.dim_dw, s_p.dim)
        for a, b in zip(s_j.states_up + s_j.states_dw,
                        s_p.states_up + s_p.states_dw):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert tab_j.cdg_sector(sqn, 0, 0) == tab_p.cdg_sector(sqn, 0, 0)
        assert tab_j.c_sector(sqn, 0, 0) == tab_p.c_sector(sqn, 0, 0)


@pytest.mark.parametrize("kw,sqn", [
    (CONFIGS[0], ((3,), (3,))), (CONFIGS[0], ((2,), (4,))),
    (CONFIGS[1], ((3,), (4,))), (CONFIGS[2], ((3,), (2,)))])
def test_sector_hamiltonian_factor_tables_equal(kw, sqn):
    h_j, h_p = _both_hamiltonians(kw, sqn)
    for f in dataclasses.fields(h_p):
        a, b = getattr(h_j, f.name), getattr(h_p, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert np.array_equal(ed.dense_hamiltonian(h_j), pt.dense_hamiltonian(h_p))


@pytest.mark.parametrize("kw,sqn", [
    (CONFIGS[0], ((3,), (3,))), (CONFIGS[0], ((2,), (4,))),
    (CONFIGS[1], ((3,), (4,))), (CONFIGS[2], ((3,), (2,)))])
def test_blocksparse_op_equal(kw, sqn):
    """Same RCM permutations, f32 slabs, geometry and diagonal factors."""
    h_j, h_p = _both_hamiltonians(kw, sqn, seed=3)
    op_j = jax_build_bs(h_j)
    op_p = build_blocksparse_op(h_p, "cpu")
    for name in ("perm_dw", "perm_up", "iperm_dw", "iperm_up"):
        assert np.array_equal(np.asarray(getattr(op_j, name)),
                              getattr(op_p, name).numpy()), name
    pj, pp = op_j.pop, op_p.pop
    assert (pj.w_dw, pj.d_dw, pj.w_up, pj.d_up) == \
        (pp.w_dw, pp.d_dw, pp.w_up, pp.d_up)
    assert op_j.padded_shape == op_p.padded_shape
    for name in ("dw_f32", "up_f32", "diag_a", "diag_b", "diag_p", "hup_p",
                 "hdw_p", "hup_p32", "hdw_p32"):
        assert np.array_equal(np.asarray(getattr(pj, name)),
                              getattr(pp, name).numpy()), name


def test_convert_round_trips():
    kw = CONFIGS[2]
    cfg = pt.read_input(None, **kw)
    packed = _random_packed_bath(cfg, 7)
    bath = bath_from_reference(packed, cfg)
    assert np.array_equal(pt.pack_bath(cfg, bath), packed)
    h_j, h_p = _both_hamiltonians(kw, ((3,), (2,)))
    fields = {f.name: (None if getattr(h_j, f.name) is None
                       else np.asarray(getattr(h_j, f.name)))
              for f in dataclasses.fields(h_j)}
    h_c = hamiltonian_from_reference(fields)
    for f in dataclasses.fields(h_p):
        a, b = getattr(h_c, f.name), getattr(h_p, f.name)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b) and a.dtype == b.dtype
    back = hamiltonian_from_reference(dataclasses.asdict(h_c))
    assert np.array_equal(back.diag, h_c.diag)
    with pytest.raises(KeyError):
        hamiltonian_from_reference({"not_a_field": np.zeros(1)})


def test_port_imports_no_jax():
    """Importing the port (every module of the slice) pulls in no JAX."""
    code = ("import sys; import dmft_lanc_ed_tpu_torch, "
            "dmft_lanc_ed_tpu_torch.models.hm_bethe, "
            "dmft_lanc_ed_tpu_torch.ops.bs_chain, "
            "dmft_lanc_ed_tpu_torch.convert, dmft_lanc_ed_tpu_torch._kernels, "
            "dmft_lanc_ed_tpu_torch.parallel.multihost, "
            "dmft_lanc_ed_tpu_torch.parallel.mesh, "
            "dmft_lanc_ed_tpu_torch.parallel.bs_sharded, "
            "dmft_lanc_ed_tpu_torch.parallel.production; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dmft_lanc_ed_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_tf32_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_config_cli_values_parse_like_the_input_file():
    from dmft_lanc_ed_tpu_torch.models.hm_bethe import _cli_value
    assert _cli_value("ed_batch_sectors", "F") is False
    assert _cli_value("ed_sectors", ".true.") is True
    assert _cli_value("nbath", "11") == 11
    assert _cli_value("uloc", "2.0,0.5") == (2.0, 0.5)
    assert _cli_value("ed_backend", "pallas") == "pallas"


def test_unported_options_raise():
    # ROADMAP A5 and A10 landed: the sharded direct backend and
    # dw-sharded phonon and Jx/Jp sectors build their sharded operators
    # (run on ranks in tests/test_torch_sharding_a10.py). What still
    # raises is the JAX package's own refusal: ShardedLanczos, the ELL
    # oracle of parallel/matvec.py, on a phonon sector.
    from types import SimpleNamespace
    from dmft_lanc_ed_tpu_torch.parallel.matvec import ShardedLanczos
    from dmft_lanc_ed_tpu_torch.parallel.production import (
        ShardedDirectOp, shard_sector_op)
    mesh = SimpleNamespace(device=torch.device("cpu"), size=2, rank=0)
    for kw, direct in ((dict(norb=1, nbath=3, ed_sparse_h=False), True),
                       (dict(norb=1, nbath=3, ed_backend="direct"), True),
                       (dict(norb=1, nbath=2, nph=2, g_ph=(0.3,),
                             w0_ph=0.5), False),
                       (dict(norb=2, nbath=1, uloc=(2.0, 2.0), ust=1.0,
                             jh=0.3, jx=0.3, jp=0.3), False)):
        cfg = pt.read_input(None, **kw)
        sec = pt.SectorTable(cfg).sector(pt.qn(1, 1))
        hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
        sop = shard_sector_op(cfg, sec, hloc, pt.init_bath(cfg), None, mesh)
        assert isinstance(sop.op, ShardedDirectOp) == direct
        assert sop.vshape[-2] % 2 == 0 and sop.dim == sec.dim
        if cfg.nph:
            h = pt.build_sector_hamiltonian(cfg, sec, hloc, pt.init_bath(cfg))
            with pytest.raises(NotImplementedError,
                               match="phonon sectors use the replicated"):
                ShardedLanczos(h, mesh)