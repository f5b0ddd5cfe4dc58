"""Mean chains a B4 launch carried in the kanamori3 window (three orbitals a target): ops.bs_chain.chains_per_launch["gf_tridiag"] (program counter)."""
import numpy as np


def read(run):
    chains = [c for r in run.window for c in r["chains"]]
    return float(np.mean(chains)) if chains else None
