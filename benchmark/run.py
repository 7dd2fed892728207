"""Run one cell of the benchmark of ``spectral_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, then ``check``: each
number compared with the reference beside its limit) and exits 0; exits
non-zero with no result when there is no CUDA card, too few of them, a
file of the cell is missing, or the run loaded JAX or the JAX package.
"""

import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout: the benchmark's package and the program
os.environ.setdefault("USE_FLAX", "0")
# host math on one thread: one process, few threads, so that runs agree
os.environ.setdefault("OMP_NUM_THREADS", "1")

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
