"""The readings that the correctness limits are set from, on the chip: the
program's numbers over many seeds, and the control's (the plain reference
in TF32, put in the program's place) over a few, in one process.

    python3 eebench/readings.py --workload <cell> --seeds 1 2 3 --control-seeds 4 5 6 \
        [--seconds 3]

Prints one JSON line a run: the cell, the side, the seed and each number
compared. Not part of a benchmark run.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main() -> int:
    import argparse

    import torch

    from eebench import harness, program

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    sides = [("program", program.port(), s) for s in args.seeds]
    sides += [("control", program.reference(tf32=True), s) for s in args.control_seeds]
    for cell in args.workload:
        for side, prog, seed in sides:
            t0 = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", prog)
            print(json.dumps({"cell": cell, "side": side, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()},
                              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
