"""K3 (``ops/mi_kernel.py``: ``k3_phik``, ``k3_finish``): the share of the
roofline of the MI target recomputed every tick (``eebench/work/k3.py``)
over these kernels' device time. Moves ``replan_solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import k3

UNIT, MOVES, LAYER = "%", "replan_solves_per_s", "K3"
MATCH = re.compile(r"k3_(phik|finish)")


def read(trace):
    return roofline(trace, MATCH, k3.count, "tick")
