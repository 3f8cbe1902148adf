"""The traced run's reduction: a ``torch.profiler`` window turned into the
numbers the per-layer readers take (device time by kernel, busy time, CUDA
runtime calls) and the ``breakdown`` of the result line.

Busy time is the union of the intervals in which a device operation ran
(kernels, copies, sets), so overlapping operations are not counted twice.
An idle gap is a stretch of the traced window with no device operation; it
is named by what the host was doing at its middle: the innermost of the
harness's own spans (``eebench.*``) and the innermost host operation inside
it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


class Trace:
    """What one traced window holds. Times in seconds."""

    def __init__(self, window_s: float, requests: int, ticks: int, refreshes: int = 0):
        self.window_s = window_s
        self.requests = requests
        self.ticks = ticks
        self.refreshes = refreshes
        self.kernels: Dict[str, List[float]] = {}  # name -> [launches, seconds]
        self.busy_s = 0.0
        self.runtime_calls = 0  # CUDA runtime API calls on the host
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.dispatch_s: List[float] = []  # the harness's clock around each entry call
        self.facts: dict = {}  # counts the driver read from the cell's inputs
        self.ctx = None  # the run's context (configuration, traffic, scale)

    def kernel_time(self, match) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name ``match``
        (a compiled regex) finds."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if match.search(name):
                n, s = n + c, s + t
        return int(n), s


def _union(intervals):
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(prof, trace: Trace) -> Trace:
    """Fill ``trace`` from the profiler ``prof`` over its ``eebench.window``
    span (the measured window)."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == "eebench.window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} eebench.window spans, not 1")
    t0_us, t1_us = window[0].time_range.start, window[0].time_range.end
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    calls = 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if b < t0_us or a > t1_us or e.name.startswith("eebench."):
                continue  # (the harness's spans also show on the device's timeline)
            dev.append((a, b))
            k = kernels[e.name]
            k[0] += 1
            k[1] += (b - a) * 1e-6
        else:
            if b < t0_us or a > t1_us:
                continue
            if e.name.startswith("cuda") or e.name.startswith("cu"):
                calls += 1
            host.append((a, b, e.name))
    trace.kernels = dict(kernels)
    busy_us, merged = _union((max(a, t0_us), min(b, t1_us)) for a, b in dev)
    trace.busy_s = busy_us * 1e-6
    trace.runtime_calls = calls
    trace.device_ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    # idle gaps: between merged device intervals, and at the window's ends
    edges = [t0_us] + [x for ab in merged for x in ab] + [t1_us]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    by_what = defaultdict(float)
    for length, a, b in gaps[:500]:
        by_what[_host_at(host, starts, 0.5 * (a + b))] += length * 1e-6
    trace.idle_gaps = sorted(by_what.items(), key=lambda kv: -kv[1])[:10]
    return trace


def _host_at(host, starts, t) -> str:
    """What the host was doing at ``t``: its innermost ``eebench.*`` span and
    the innermost other operation that covers ``t``."""
    i = bisect.bisect_right(starts, t)
    span, op = None, None
    span_len = op_len = float("inf")
    for a, b, name in host[max(0, i - 4000):i]:
        if b < t:
            continue
        if name == "eebench.window":
            continue
        if name.startswith("eebench."):
            if b - a < span_len:
                span, span_len = name, b - a
        elif b - a < op_len:
            op, op_len = name, b - a
    if span is None and op is None:
        return "host idle or untraced"
    return " > ".join(x for x in (span, op) if x)


def roofline(trace: Trace, match, count, per: str = "tick"):
    """A kernel's share of its roofline, in %: the least time the window's
    work could take on the card (``count(cfg, S, facts)`` for one tick or
    one refresh, times the window's ticks or refreshes) over the device time
    of the kernels ``match`` finds. None where the window ran none of them.
    The work is counted per unit of the traffic, not per launch, so a
    kernel split into more launches is held to the same count."""
    from eebench.work import least_seconds

    _, seconds = trace.kernel_time(match)
    units = trace.ticks if per == "tick" else trace.refreshes
    if not units or seconds <= 0.0:
        return None
    ctx = trace.ctx
    flops, nbytes = count(ctx.engine_config, ctx.scenarios, trace.facts)
    return 100.0 * units * least_seconds(flops, nbytes) / seconds
