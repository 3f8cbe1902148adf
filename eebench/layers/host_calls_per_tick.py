"""Engine API and graphs: the CUDA runtime calls the host made in the
traced window (kernel and graph launches, copies, synchronisations; the
profiler's host events named ``cu*``), per tick. Moves ``solves_per_s``."""

UNIT, MOVES, LAYER = "calls/tick", "solves_per_s", "engine API and graphs"


def read(trace):
    if not trace.ticks or not trace.kernels:
        return None
    return trace.runtime_calls / trace.ticks
