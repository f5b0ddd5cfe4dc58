"""The check's control and its faults (CPU, tiny sizes): the float32
reference in the program's place, and a run with the timed path broken
underneath, each come out not correct; a sound run comes out correct."""
import numpy as np
import pytest

from edbench import check, control, spec
from edbench.tests import toycell


@pytest.mark.parametrize("traffic", ["t0-steady", "cold-scan"])
def test_control_is_not_correct(tmp_path, traffic):
    root, parts = toycell.make(tmp_path)
    cell = spec.load_cell("toy." + traffic, root, parts)
    verdict = check.judge(control.control_numbers(cell, 2 ** 31 + 5,
                                                  workers=2), cell.limits)
    failed = [k for k, (_, _, ok) in verdict.items() if not ok]
    assert failed, verdict
    assert "dE" in failed


def _unchanged_fit(monkeypatch):
    import dmft_lanc_ed_tpu_torch.fit as fit
    monkeypatch.setattr(fit, "chi2_fitgf",
                        lambda cfg, target, bath, *a, **k:
                        np.asarray(bath, np.float64).copy())


def _half_the_sectors(monkeypatch):
    import dmft_lanc_ed_tpu_torch.diag as diag
    scan = diag._scan_sectors
    monkeypatch.setattr(diag, "_scan_sectors",
                        lambda *a: scan(*a)[::2])


def _g_altered(monkeypatch):
    import dmft_lanc_ed_tpu_torch.solver as solver
    build = solver.build_sigma

    def altered(cfg, hloc, bath, gf, z, *a):
        sigma, g = build(cfg, hloc, bath, gf, z, *a)
        return sigma, g * (1.0 + 1e-3)
    monkeypatch.setattr(solver, "build_sigma", altered)


@pytest.mark.parametrize("fault", [_unchanged_fit, _half_the_sectors,
                                   _g_altered],
                         ids=["state-unchanged", "half-the-batch",
                              "answer-altered"])
@pytest.mark.parametrize("traffic", ["t0-steady", "cold-scan"])
def test_fault_makes_the_run_not_correct(tmp_path, capsys, monkeypatch,
                                         fault, traffic):
    root, parts = toycell.make(tmp_path)
    fault(monkeypatch)
    rc, out = toycell.run(root, parts, "toy." + traffic, capsys)
    assert rc == 0
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("traffic", ["t0-steady", "cold-scan"])
def test_sound_run_is_correct(tmp_path, capsys, traffic):
    root, parts = toycell.make(tmp_path)
    rc, out = toycell.run(root, parts, "toy." + traffic, capsys,
                          seed=4000000001)
    assert rc == 0 and out["correct"], out["checks"]
