"""Run one cell of the benchmark once, on the card this machine holds.

    python3 edbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository root. The last line of standard output is the
result as one JSON object; the numbers the check compared, each with its
limit, are the last lines of standard error. Without a card, or with
fewer than the cell asks for, it exits 2 and prints no result.
"""
import os
import sys
import time

T_START = time.perf_counter()


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, ".edbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    from edbench import harness
    return harness.main(sys.argv[1:], T_START, root=root)


if __name__ == "__main__":
    sys.exit(main())
