"""The frozen roofline arithmetic against hand counts (CPU)."""
import numpy as np
import pytest

from edbench import roofline, tracing


def test_hand_count_small_operator():
    # a 384 x 256 padded grid: dw panels with 2, 1 and 3 nonzero tiles,
    # up panels with 1 and 2
    runs = ((((0, 2),), ((1, 2),), ((0, 1), (2, 4))), (((0, 1),), ((0, 2),)))
    assert roofline.kept_tiles(runs) == (6, 3)
    flops = roofline.hop_flops((384, 256), 6, 3)
    assert flops == 2 * 128 * 128 * (256 * 6 + 384 * 3)
    sec, by = roofline.launch_seconds((384, 256), 4, (6, 3), 100, 1,
                                      "lanczos")
    t_tc = 100 * flops / 989e12
    t_fp = 100 * (2 * 4 + 12) * 384 * 256 / 67e12
    nbytes = (4 * 128 * 128 * 9 + 4 * 4 * (384 + 256) + 4 * 384 * 256
              + 16 * 100)
    assert sec == pytest.approx(max(t_tc, t_fp, nbytes / 3.35e12))
    assert by == "tensor"


def test_port_operator_tiles_match_hand_count():
    import dmft_lanc_ed_tpu_torch as pt
    from dmft_lanc_ed_tpu_torch.ops.blocksparse import build_blocksparse_op
    cfg = pt.EDConfig(norb=1, nbath=11, uloc=(2.0,))
    sec = pt.SectorTable(cfg).sector(pt.qn(3, 4))
    h = pt.build_sector_hamiltonian(cfg, sec, np.zeros((1, 1, 1, 1)),
                                    pt.init_bath(cfg))
    pop = build_blocksparse_op(h, "cpu").pop

    def nonzero_tiles(m):
        m = m.numpy()
        n0, n1 = m.shape[0] // 128, m.shape[1] // 128
        return sum(bool(np.any(m[i * 128:(i + 1) * 128,
                                 j * 128:(j + 1) * 128]))
                   for i in range(n0) for j in range(n1))
    assert roofline.kept_tiles(pop.trim_runs) == (
        nonzero_tiles(pop.hdw_p), nonzero_tiles(pop.hup_p))


def test_bound_ignores_the_pass_count():
    """B2 runs its product in three split-bf16 passes and B4 in six; one
    chain of the same operator and steps has the same least time."""
    shape, rank, tiles = (1024, 1024), 8, (40, 40)
    b2 = roofline.launch_seconds(shape, rank, tiles, 96, 1, "lanczos")
    b4 = roofline.launch_seconds(shape, rank, tiles, 96, 1, "lanczos")
    assert b2 == b4
    # and it is linear in the chains a B4 launch carries, bytes aside
    b4x3 = roofline.launch_seconds(shape, rank, tiles, 96, 3, "lanczos")
    assert b4x3[0] == pytest.approx(3 * b4[0], rel=1e-9)


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::tc_step<64, 0, 2>((anonymous namespace)"
     "::ChainArgs, int, float, float, int)", "B2"),
    ("void (anonymous namespace)::tc_pass1<2>((anonymous namespace)"
     "::ChainArgs, double*, int, int)", "B2"),
    ("void (anonymous namespace)::tc_step<64, 1, 2>(ChainArgs)", "B3"),
    ("void tc_step<128, 0, 3>(ChainArgs, int, float, float, int)", "B4"),
    ("tc_pass1<3>", "B4"),
    ("_ZN12_GLOBAL__N_17tc_stepILi32ELi0ELi3EEEvNS_9ChainArgsEiffi", "B4"),
    ("void tc_step<64, 2, 3>(ChainArgs)", None),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize128x64x32", None),
])
def test_kernel_class(name, kernel):
    assert tracing.kernel_class(name) == kernel


def test_summary_busy_and_idle():
    ev = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60)]
    s = tracing.summarize(ev, 0, 100, spans=[("fit", 30, 80)], offset=0)
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["idle_by_phase"]["fit"] == pytest.approx(40e-9)
    assert s["idle_by_phase"]["between phases"] == pytest.approx(30e-9)
