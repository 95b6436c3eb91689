"""The benchmark of raysnail_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the
cell asks for; `benchmark/harness.py` says what a run does. The last line
of standard output is one JSON object with the keys correct, attempted,
failed, metrics, device (breakdown with --trace 1) and checks.
"""

import os
import sys
import time

T0 = time.time()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], time.perf_counter() - (time.time() - T0)))
