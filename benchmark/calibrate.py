"""The readings that a cell's limits are set from, on the card, in one
process: for each seed a whole run of the cell as ``run.py`` makes it,
with its ``pixel_gap`` and ``correct``. With ``--control`` every run is
the control (``benchmark/harness/control.py``): the program's RGB fold
switched to TF32 after set-up, judged by the harness's own comparison,
which has to come out not correct. One JSON line per seed.

    python3 benchmark/calibrate.py --workload <cell> --seconds 2 --seeds 11 12 13 [--control]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ.setdefault("USE_FLAX", "0")
# host math on one thread: one process, few threads, so that runs agree
os.environ.setdefault("OMP_NUM_THREADS", "1")

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from benchmark.harness import control, core  # noqa: E402


def main(argv=None, root=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    for seed in args.seeds:
        t0 = time.monotonic()
        with pytest.MonkeyPatch.context() as mp:  # undoes the control's switch after each run
            hook = (lambda d: control.program_in_tf32(d, mp.setattr)) if args.control else None
            out = core.run_cell(root, args.workload, seed, args.seconds, False, device=device,
                                driver_hook=hook)
        row = {"cell": args.workload, "seed": seed, "control": args.control,
               "correct": out["correct"], "attempted": out["attempted"],
               "failed": out["failed"], "pixel_gap": out["check"]["pixel_gap"]["value"],
               "limit": out["check"]["pixel_gap"]["limit"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "seconds": time.monotonic() - t0}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
