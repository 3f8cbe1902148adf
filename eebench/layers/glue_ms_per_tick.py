"""Tick glue G (``ops/tick_glue.py``): device time of the ``glue_pre*`` and
``glue_post*`` kernels per tick, from the device trace. Moves
``solves_per_s``."""

import re

UNIT, MOVES, LAYER = "ms", "solves_per_s", "tick glue G"
MATCH = re.compile(r"glue_(pre|post)")


def read(trace):
    n, seconds = trace.kernel_time(MATCH)
    if not n or not trace.ticks:
        return None
    return 1e3 * seconds / trace.ticks
