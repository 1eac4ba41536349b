"""Run one cell of BENCHMARK.json once on this machine's CUDA cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object (see
``portbench/harness.py``); exit code 3 without enough cards, 4 where a
module of JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], harness.Path(ROOT), T0))
