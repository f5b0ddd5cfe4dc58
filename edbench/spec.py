"""Where the benchmark finds its parts, by the names in BENCHMARK.json:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py`` under this folder. A
cell, configuration, traffic mix or metric is added by files and entries
alone."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    parts: str = HERE


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def load_cell(name: str, root: str = ROOT, parts: Optional[str] = None
              ) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files, read from
    `parts` (this folder unless given)."""
    parts = parts or HERE
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(parts, "configs", w["config"] + ".json")),
        traffic=_json(os.path.join(parts, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(parts, "limits", name + ".json")),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name), parts=parts)


def reader(metric: str, parts: Optional[str] = None) -> Callable:
    """The `read(run)` function of metrics/<metric>.py."""
    path = os.path.join(parts or HERE, "metrics", metric + ".py")
    mod_name = "edbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
