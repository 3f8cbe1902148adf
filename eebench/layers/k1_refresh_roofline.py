"""K1 refresh (``k1_refresh`` + ``k1_finish``): the share of the roofline of
the GMM target refresh inside K1 (``eebench/work/k1_refresh.py``) over these
kernels' device time. Moves ``replan_solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import k1_refresh

UNIT, MOVES, LAYER = "%", "replan_solves_per_s", "K1 refresh"
MATCH = re.compile(r"k1_(refresh|finish)")


def read(trace):
    return roofline(trace, MATCH, k1_refresh.count, "tick")
