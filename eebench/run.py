"""Entry point of the benchmark: run one cell once.

    python3 eebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The compile caches stay inside it: the
port's kernel libraries under ``build/kernels``, PyTorch's and Triton's
under ``build/``.
"""

import time

T_START = time.perf_counter()  # set-up starts here: importing torch is part of it

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"  # one host thread for PyTorch's CPU work: steadier runs
sys.path[0] = str(ROOT)  # the checkout's root, not eebench/ (whose names would shadow others)

from eebench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
