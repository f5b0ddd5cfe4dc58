"""A toy cell for the CPU tests: the benchmark's own files copied into a
temporary directory, with a small Bethe configuration and a cell of each
traffic mix added beside them, as a later change adds its own."""
import json
import os
import shutil

from edbench import spec

TOY_ED = {"nbath": 3, "lmats": 128, "lfit": 64, "lreal": 50}


def make(tmp, metric_files=None, end_to_end=()):
    """(root, parts) of a benchmark in `tmp` that has toy.<traffic> cells
    for every traffic mix; `metric_files` {name: source} adds readers,
    `end_to_end` entries add metrics to BENCHMARK.json."""
    root = str(tmp)
    parts = os.path.join(root, "parts")
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, d), os.path.join(parts, d))
    with open(os.path.join(spec.HERE, "configs", "bethe11.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "toy"
    cfg["ed"].update(TOY_ED)
    with open(os.path.join(parts, "configs", "toy.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    traffic_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    for traffic in sorted(os.listdir(os.path.join(parts, "traffic"))):
        traffic = traffic[:-len(".json")]
        name = "toy." + traffic
        bench["workloads"].append({"name": name, "config": "toy",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
        # the toy cell reads what the benchmark's cells of its mix read
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(traffic_of.get(w) == traffic
                                        for w in m["workloads"]):
                m["workloads"].append(name)
        shutil.copy(os.path.join(parts, "limits", "bethe11.t0-steady.json"),
                    os.path.join(parts, "limits", name + ".json"))
    for name, src in (metric_files or {}).items():
        with open(os.path.join(parts, "metrics", name + ".py"), "w") as fh:
            fh.write(src)
    bench["end_to_end"] += list(end_to_end)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root, parts


def run(root, parts, cell, capsys, seed=2 ** 31 + 77, seconds=1.0,
        trace=0):
    """harness.main on the CPU, past the look for a card; returns (exit
    code, the result line as a dict or None)."""
    import time
    from edbench import harness
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      time.perf_counter(), root=root, parts=parts,
                      device="cpu", require_card=False, workers=2)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
