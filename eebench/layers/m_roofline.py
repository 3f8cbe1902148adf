"""M (``ops/mi_dense_kernel.py``: ``m_phik_dense``, ``m_columns``,
``m_finish``): the share of the roofline of the mapping refresh's dense MI
target (``eebench/work/m.py``) over these kernels' device time. Moves
``solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import m

UNIT, MOVES, LAYER = "%", "solves_per_s", "map refresh: M, R, E"
MATCH = re.compile(r"\bm_(phik_dense|columns|finish)")


def read(trace):
    return roofline(trace, MATCH, m.count, "refresh")
