"""R (``ops/reveal_kernel.py``: ``reveal_kernel``): the share of the
roofline of the ray-cast reveal (``eebench/work/reveal.py``) over its
device time. Moves ``solves_per_s``."""

import re

from eebench.trace import roofline
from eebench.work import reveal

UNIT, MOVES, LAYER = "%", "solves_per_s", "map refresh: M, R, E"
MATCH = re.compile(r"reveal_kernel")


def read(trace):
    return roofline(trace, MATCH, reveal.count, "refresh")
