"""PyTorch port, the hybrid and replica baths: hloc decomposition, the bath
layer (init / pack / unpack / dimension / levels / symmetry helpers), the
Anderson bath functions and the sector Hamiltonians, each against the JAX
package on the same numpy inputs.

Tolerances, each with its origin:
- hloc helpers, packed baths, bath_levels, sector tables: exact (the same
  numpy arithmetic; packed baths move byte for byte between the packages);
- Delta, G0^-1, G0: 1e-13 relative (complex128 einsums and LAPACK
  inverses summed in another order);
- densified sector Hamiltonians: 1e-12 (test_hamiltonian.py's bar).
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu import bath as jbath
from dmft_lanc_ed_tpu import bath_functions as jbf
from dmft_lanc_ed_tpu import hloc as jhloc
from dmft_lanc_ed_tpu.dmft.hk import hk_bhz_2d as jhk_bhz_2d
from dmft_lanc_ed_tpu_torch import bath as pbath
from dmft_lanc_ed_tpu_torch import bath_functions as pbf
from dmft_lanc_ed_tpu_torch import hloc as phloc
from dmft_lanc_ed_tpu_torch.convert import bath_from_reference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The matrices here are small: one torch intra-op thread and one BLAS
    thread (the host eigh of every sector, in both packages) are as fast
    alone and keep parallel test workers from oversubscribing the cores
    (a BHZ run took 62 s against 13 s beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _hloc_hybrid():
    """The hybrid tests' off-diagonal impurity Hamiltonian
    (test_hamiltonian.py:test_hybrid_bath)."""
    h = np.zeros((1, 1, 2, 2))
    h[0, 0] = [[0.0, 0.15], [0.15, 0.1]]
    return h


def _replica_case():
    """test_hamiltonian.py:test_replica_bath's basis: identity + orbital
    sigma_x."""
    h = np.zeros((1, 1, 2, 2))
    h[0, 0] = [[0.2, 0.1], [0.1, -0.2]]
    basis = np.zeros((2, 1, 1, 2, 2))
    basis[0, 0, 0] = np.eye(2)
    basis[1, 0, 0] = [[0.0, 1.0], [1.0, 0.0]]
    return h, basis, np.array([0.0, 0.1])


def _bhz_case(cfg):
    """The BHZ driver's hloc (nk = 6) and its decomposition (4 symmetries)."""
    from dmft_lanc_ed_tpu_torch.dmft.hk import hloc_from_hk
    hloc = hloc_from_hk(jhk_bhz_2d(6), 2, 2)
    basis, lam = phloc.decompose_hloc(cfg, hloc)
    return hloc, basis, lam


# name -> (config kwargs, builder of (hloc, h_basis, lambda_imp))
CASES = {
    "hybrid": (dict(norb=2, nbath=3, uloc=(1.4, 1.4), ust=0.5, jh=0.1,
                    bath_type="hybrid"),
               lambda cfg: (_hloc_hybrid(), None, None)),
    "hybrid-nspin2": (dict(norb=2, nbath=2, nspin=2, uloc=(1.4, 1.4),
                           ust=0.5, jh=0.1, bath_type="hybrid"),
                      lambda cfg: (np.stack([np.stack([_hloc_hybrid()[0, 0],
                                                       np.zeros((2, 2))]),
                                             np.stack([np.zeros((2, 2)),
                                                       _hloc_hybrid()[0, 0]])]),
                                   None, None)),
    "replica": (dict(norb=2, nbath=2, uloc=(1.0, 1.0), ust=0.4, jh=0.1,
                     bath_type="replica"),
                lambda cfg: _replica_case()),
    "replica-bhz": (dict(norb=2, nbath=2, nspin=2, uloc=(2.0, 2.0), ust=1.0,
                         jh=0.5, bath_type="replica"),
                    _bhz_case),
}


def _setup(name, seed=3):
    """Both configs, hloc, basis and a packed bath: the default guess,
    perturbed from a numpy seed (replica: its N_dec head kept)."""
    kw, make = CASES[name]
    cfg_p, cfg_j = pt.EDConfig(**kw), ed.EDConfig(**kw)
    hloc, basis, lam = make(cfg_p)
    packed = ed.pack_bath(cfg_j, ed.init_bath(cfg_j, lam, basis))
    rng = np.random.default_rng(seed)
    head = cfg_j.nbath if cfg_j.bath_type == "replica" else 0
    packed[head:] += 0.2 * rng.normal(size=len(packed) - head)
    return cfg_p, cfg_j, hloc, basis, lam, packed


def test_hloc_helpers_match_reference():
    rng = np.random.default_rng(5)
    for nspin, norb in ((1, 2), (2, 2), (1, 3), (2, 1)):
        cfg_p = pt.EDConfig(norb=norb, nspin=nspin)
        cfg_j = ed.EDConfig(norb=norb, nspin=nspin)
        nso = nspin * norb
        m = rng.normal(size=(nso, nso))
        drop = rng.random((nso, nso)) < 0.4
        m = np.where(drop | drop.T, 0.0, m + m.T)
        h = jhloc.so2nn(m, nspin, norb)
        assert np.array_equal(phloc.so2nn(m, nspin, norb), h)
        assert np.array_equal(phloc.nn2so(h, nspin, norb),
                              jhloc.nn2so(h, nspin, norb))
        b_p, l_p = phloc.decompose_hloc(cfg_p, h)
        b_j, l_j = jhloc.decompose_hloc(cfg_j, h)
        assert np.array_equal(b_p, b_j) and np.array_equal(l_p, l_j)
        assert np.array_equal(phloc.h_from_sym(b_p, l_p),
                              jhloc.h_from_sym(b_j, l_j))
        phloc.validate_basis(cfg_p, b_p)
    # the identity fallback of an empty hloc, and the refusals
    cfg_p, cfg_j = pt.EDConfig(norb=2), ed.EDConfig(norb=2)
    zero = np.zeros((1, 1, 2, 2))
    for a, b in zip(phloc.decompose_hloc(cfg_p, zero),
                    jhloc.decompose_hloc(cfg_j, zero)):
        assert np.array_equal(a, b)
    asym = np.zeros((1, 1, 2, 2))
    asym[0, 0, 0, 1] = 1.0
    with pytest.raises(ValueError):
        phloc.decompose_hloc(cfg_p, asym)
    with pytest.raises(ValueError):
        phloc.validate_basis(cfg_p, asym[None])


@pytest.mark.parametrize("name", list(CASES))
def test_bath_layout_matches_reference(name):
    """init_bath, pack/unpack and bath_dimension: byte-identical packed
    arrays; bath_levels exact."""
    cfg_p, cfg_j, hloc, basis, lam, packed = _setup(name)
    nsym = None if basis is None else basis.shape[0]
    assert pbath.bath_dimension(cfg_p, nsym) == \
        jbath.bath_dimension(cfg_j, nsym) == len(packed)
    init_p = pt.pack_bath(cfg_p, pt.init_bath(cfg_p, lam, basis))
    init_j = ed.pack_bath(cfg_j, ed.init_bath(cfg_j, lam, basis))
    assert init_p.tobytes() == init_j.tobytes()
    b_p = pt.unpack_bath(cfg_p, packed, nsym)
    b_j = ed.unpack_bath(cfg_j, packed, nsym)
    assert pt.pack_bath(cfg_p, b_p).tobytes() == packed.tobytes()
    for f in ("e", "v", "lam", "v_rep"):
        a, b = getattr(b_p, f), getattr(b_j, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, np.asarray(b))
    for a, b in zip(pbath.bath_levels(cfg_p, b_p, basis),
                    jbath.bath_levels(cfg_j, b_j, basis)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and np.array_equal(a, b)
    c = bath_from_reference(packed, cfg_p, nsym)
    assert pt.pack_bath(cfg_p, c).tobytes() == packed.tobytes()
    if cfg_p.bath_type == "replica":
        with pytest.raises(ValueError):       # N_dec read from arr[0]
            pt.unpack_bath(cfg_p, packed, nsym + 1)
        with pytest.raises(ValueError):
            pbath.bath_dimension(cfg_p)


@pytest.mark.parametrize("name", list(CASES))
def test_bath_symmetry_helpers_match_reference(name):
    """The user bath operations on e/v blocks: byte-identical for the
    hybrid bath. The replica bath has no e/v blocks: the port refuses
    each; the JAX package raises an indexing error or returns no block."""
    cfg_p, cfg_j, _, _, _, packed = _setup(name, seed=4)
    calls = [("break_symmetry_bath", (0.1, -1.0)), ("orb_symmetrize_bath", ()),
             ("orb_equality_bath", (1,)), ("ph_symmetrize_bath", ()),
             ("ph_trans_bath", ()), ("get_bath_component", ("e",)),
             ("get_bath_component", ("v",))]
    if cfg_p.nspin == 2:
        calls.append(("spin_symmetrize_bath", ()))
    for fn, args in calls:
        if cfg_p.bath_type == "replica":
            try:
                out_j = getattr(jbath, fn)(cfg_j, packed, *args)
            except (IndexError, np.exceptions.AxisError):
                pass
            else:
                assert np.asarray(out_j).item() is None, fn
            with pytest.raises(ValueError):
                getattr(pbath, fn)(cfg_p, packed, *args)
            continue
        out_p = getattr(pbath, fn)(cfg_p, packed, *args)
        out_j = getattr(jbath, fn)(cfg_j, packed, *args)
        assert np.asarray(out_p).tobytes() == np.asarray(out_j).tobytes(), fn


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("fn", ["delta_bath", "invg0_bath", "g0and_bath"])
def test_bath_functions_match_reference(name, fn):
    cfg_p, cfg_j, hloc, basis, lam, packed = _setup(name)
    nsym = None if basis is None else basis.shape[0]
    b_p = pt.unpack_bath(cfg_p, packed, nsym)
    b_j = ed.unpack_bath(cfg_j, packed, nsym)
    z = np.concatenate([1j * pt.matsubara_grid(cfg_p)[:24],
                        np.linspace(-2, 2, 9) + 0.05j])
    args = () if fn == "delta_bath" else (hloc,)
    got = getattr(pbf, fn)(cfg_p, *args, b_p, z, basis).numpy()
    ref = np.asarray(getattr(jbf, fn)(cfg_j, *args, b_j, z, basis))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())
    # the orbital-off-diagonal blocks are really filled (the BHZ hloc and
    # so its basis are orbital-diagonal)
    if name != "replica-bhz":
        assert np.abs(got[0, 0, 0, 1]).max() > 1e-3


@pytest.mark.parametrize("name,sqns", [
    ("hybrid", [(2, 2), (3, 1)]), ("hybrid-nspin2", [(2, 3)]),
    ("replica", [(2, 2), (3, 2)]), ("replica-bhz", [(3, 3), (2, 4)])])
def test_sector_hamiltonians_match_reference(name, sqns):
    """The configurations of test_hamiltonian.py (hybrid, replica) and the
    BHZ replica bath, densified."""
    cfg_p, cfg_j, hloc, basis, _, packed = _setup(name, seed=9)
    nsym = None if basis is None else basis.shape[0]
    b_p = pt.unpack_bath(cfg_p, packed, nsym)
    b_j = ed.unpack_bath(cfg_j, packed, nsym)
    for sqn in sqns:
        sec_p = pt.SectorTable(cfg_p).sector(pt.qn(*sqn))
        sec_j = ed.SectorTable(cfg_j).sector(ed.qn(*sqn))
        h_p = pt.build_sector_hamiltonian(cfg_p, sec_p, hloc, b_p,
                                          h_basis=basis)
        h_j = ed.build_sector_hamiltonian(cfg_j, sec_j, hloc, b_j,
                                          h_basis=basis)
        d_p = pt.dense_hamiltonian(h_p)
        d_j = ed.dense_hamiltonian(h_j)
        assert d_p.shape == d_j.shape == (sec_p.dim, sec_p.dim)
        np.testing.assert_allclose(d_p, d_j, atol=1e-12)
        # hopping inside the replicas / to the shared levels is present
        assert np.count_nonzero(d_p - np.diag(np.diag(d_p))) > 0
