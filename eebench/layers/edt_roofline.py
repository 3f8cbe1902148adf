"""E (``ops/edt_kernel.py``: ``edt_kernel``, or ``edt_rows``,
``edt_columns``, ``edt_finish``): the share of the roofline of the world
rebuild (``eebench/work/edt.py``) over these kernels' device time. Moves
``solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import edt

UNIT, MOVES, LAYER = "%", "solves_per_s", "map refresh: M, R, E"
MATCH = re.compile(r"edt_(kernel|rows|columns|finish)")


def read(trace):
    return roofline(trace, MATCH, edt.count, "refresh")
