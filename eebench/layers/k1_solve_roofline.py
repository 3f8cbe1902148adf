"""K1 solve and safety (``ops/solve_kernel.py``: ``k1_solve``,
``k1_solve_block``, ``k1_safety``): the share of the roofline, the least
time of the ticks' solve and safety work (``eebench/work/k1_solve.py``) over
these kernels' device time. Moves ``solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import k1_solve

UNIT, MOVES, LAYER = "%", "solves_per_s", "K1 solve and safety"
MATCH = re.compile(r"k1_(solve|safety)")


def read(trace):
    return roofline(trace, MATCH, k1_solve.count, "tick")
