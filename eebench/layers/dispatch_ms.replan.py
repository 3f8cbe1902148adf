"""Engine API and graphs: the host time of one replan entry call
(``Engine.replan_refresh`` or ``replan_refresh_mi``: its checks, the copy
of the inputs into the graph's buffers, the replay's launch and the copy of
the outputs), by the harness's clock around the call, averaged over the
window's ticks. Moves ``replan_p95_ms``."""

UNIT, MOVES, LAYER = "ms", "replan_p95_ms", "engine API and graphs"


def read(trace):
    if not trace.dispatch_s:
        return None
    return 1e3 * sum(trace.dispatch_s) / len(trace.dispatch_s)
