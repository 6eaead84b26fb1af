"""Run one cell of the benchmark once; see ``harness.py``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    # The repository root for ``portbench``, ``src`` for the program; not
    # this folder, whose module names would shadow others.
    sys.path[0:1] = [str(repo), str(repo / "src")]
    from portbench import harness
    sys.exit(harness.main(t0=T0))
