"""The device (H100): the share of the traced window in which no device
operation ran, from the device trace (the union of the kernels', copies'
and sets' intervals). Moves ``solves_per_s``."""

UNIT, MOVES, LAYER = "%", "solves_per_s", "device"


def read(trace):
    if not trace.kernels or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
