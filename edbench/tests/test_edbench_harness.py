"""The harness's own checks (CPU, tiny sizes)."""
import hashlib
import json
import os
import subprocess
import sys

import pytest

from edbench import harness, spec
from edbench.tests import toycell

BENCH = os.path.join(spec.ROOT, "BENCHMARK.json")


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


def test_every_part_is_found_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) >= {"scan", "dE", "dG", "dMix"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith("edbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]


def _digest(folder):
    h = hashlib.sha256()
    for dirpath, dirs, files in sorted(os.walk(folder)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_cell_config_traffic_metric_added_by_files_alone(tmp_path, capsys):
    before = _digest(spec.HERE), open(BENCH, "rb").read()
    reader = ('"""Toy: milliseconds of fit per iteration."""\n'
              "def read(run):\n"
              "    return 1e3 * sum(r['fit_s'] for r in run.window)"
              " / len(run.window)\n")
    root, parts = toycell.make(
        tmp_path, {"toy_fit_ms": reader},
        [{"name": "toy_fit_ms", "unit": "ms", "better": "lower",
          "bound": 0.25, "source": "host_clock",
          "workloads": ["toy.t0-steady"]}])
    rc, out = toycell.run(root, parts, "toy.t0-steady", capsys)
    assert rc == 0 and out["correct"], out
    assert set(out["metrics"]) == {"iter_s", "setup_s", "toy_fit_ms"}
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["device"]["platform"] == "cpu"
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert all(len(v) == 2 for v in out["checks"].values())
    assert (_digest(spec.HERE), open(BENCH, "rb").read()) == before


def test_traced_cold_cell_reports_its_per_layer_metrics(tmp_path, capsys):
    root, parts = toycell.make(tmp_path)
    rc, out = toycell.run(root, parts, "toy.cold-scan", capsys, trace=1)
    assert rc == 0 and out["correct"], out
    # on the CPU there is no device trace: those readers return nothing
    assert set(out["metrics"]) == {"diag_s.first"}


_PROBE = r"""
import sys, json
sys.path.insert(0, sys.argv[1])
from edbench import harness, check, control, loop, spec, tracing
from edbench.reference import iteration, dmft, model, solve
from edbench.tests import toycell
import dmft_lanc_ed_tpu_torch
cell = spec.load_cell("bethe11.t0-steady")
cfg = dict(cell.config); cfg["ed"] = dict(cfg["ed"], **toycell.TOY_ED)
lp = loop.Loop(cfg, cell.traffic, 5, "cpu")
lp.run_warmup()
lp.window_iteration()
print(json.dumps(harness.forbidden_modules()))
"""


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE, spec.ROOT],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmft_lanc_ed_tpu_torch_x", sys)
    assert harness.forbidden_modules() == [] or \
        "dmft_lanc_ed_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_sources_import_no_jax_and_read_no_jax_bench_file():
    import ast
    banned = ("bench" + ".py", "bench_matrix" + ".py", "BEN" + "CH_",
              "chip_" + "smoke")
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith((".py", ".json")):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                text = fh.read()
            assert not [b for b in banned if b in text], f
            if not f.endswith(".py"):
                continue
            for node in ast.walk(ast.parse(text)):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in harness.FORBIDDEN, (f, n)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join("edbench", "run.py"), "--workload",
         "bethe11.t0-steady", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_steady_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join("edbench", "run.py"), "--workload",
         "bethe11.t0-steady", "--seed", "3000000123", "--seconds", "5",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_no_file_shares_a_name_with_the_repo_tests():
    here = set(os.listdir(os.path.dirname(__file__)))
    theirs = set(os.listdir(os.path.join(spec.ROOT, "tests")))
    assert not (here & theirs) - {"__pycache__"}


def test_seeds_draw_the_jitter():
    import numpy as np
    from edbench.loop import JITTER, seeded_bath
    init = np.r_[np.linspace(-2, 2, 6), np.full(6, 0.4)]
    a = seeded_bath(init, 2, 3, 2.0, 11)
    b = seeded_bath(init, 2, 3, 2.0, 2 ** 33 + 5)
    assert not np.array_equal(a, b)
    assert np.array_equal(a, seeded_bath(init, 2, 3, 2.0, 11))
    for x in (a, b):
        assert np.abs(x[:6] - init[:6]).max() <= JITTER * 2.0
        assert np.abs(x[6:] / init[6:] - 1.0).max() <= JITTER
