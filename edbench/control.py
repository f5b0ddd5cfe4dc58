"""The check's control: the plain reference computed in float32, one step
below the float64 the configurations state, put in the program's place
and judged as the program is. It has to come out not correct.

    python3 edbench/control.py --workload <cell> --seeds 11,12,13

For each seed it runs the reference in float64 for the run's first
iteration from the seeded bath (as the set-up's warm iteration), hands
the mixed bath on as a window iteration would take it, and there puts
the float32 reference against the float64 one. It prints each number
beside the cell's limit. The benchmark's own runs never run it.
"""
import os
import sys


def control_numbers(cell, seed: int, workers: int = 0):
    import numpy as np
    from edbench import check
    from edbench.loop import fill_sector, start_bath
    from edbench.reference import iteration as ref
    t = cell.traffic
    ed = cell.config["ed"]
    ns = ed["norb"] * (ed["nbath"] + 1)
    fills = t.get("warmup_hint_fill", t.get("hint_fill"))
    rec1 = {"bath_in": start_bath(cell.config, t, seed), "first_mix": True,
            "hint": None if fills is None else
            [fill_sector(ns, f) for f in fills]}
    p1 = check.problem(cell.config, t, rec1)
    s1 = ref.solve_iteration(p1, seed, np.float64, workers)
    _, mixed = ref.fit_and_mix(p1, s1.weiss, None)
    hint = None
    if t["solver"] == "keep":
        hint = s1.ground
    elif t.get("hint_fill") is not None:
        hint = [fill_sector(ns, f) for f in t["hint_fill"]]
    rec2 = {"bath_in": mixed, "first_mix": False, "hint": hint}
    return check.control_record(cell.config, t, rec2, seed + 1,
                                workers=workers)


def main(argv=None) -> int:
    import argparse
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    from edbench import check, spec
    ap = argparse.ArgumentParser(prog="edbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, root)
    failing = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        verdict = check.judge(control_numbers(cell, seed), cell.limits)
        bad = [k for k, (_, _, ok) in verdict.items() if not ok]
        failing += bool(bad)
        print(f"control {cell.name} seed {seed}: " + ", ".join(
            f"{k} {v!r} (limit {lim})" for k, (v, lim, _) in
            verdict.items()) + f"; fails {bad}", flush=True)
    print(f"control {cell.name}: {failing} of the seeds not correct")
    return 0


if __name__ == "__main__":
    sys.exit(main())
