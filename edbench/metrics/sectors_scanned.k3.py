"""Mean sectors the scan solved per window iteration of kanamori3: len(record["sectors"]), the solve's diag_log (program counter). It grows when the ground state leaves (6,6)."""
from edbench import readers


def read(run):
    if not run.window:
        return None
    return float(sum(len(r["sectors"]) for r in run.window)
                 / len(run.window))
