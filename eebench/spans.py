"""The program's own spans and counters in a traced window, and the idle
gaps named by them: the reduction of the port's ``ee.*`` host events
(``ergodic_exploration_tpu_torch/utils/profiling.py``: the entry calls, and
inside them the graph cache's lookup, copy-in, capture or replay and
copy-out) and of a snapshot of its counters taken on each side of the
window.

``trace.reduce`` does not call this module: a traced run's result line
carries none of these numbers. ``chip_spans.py`` at the root of the
checkout runs a cell's window under the profiler and reduces it with both.

A program span is a host event whose name starts with ``ee.``; the port
records it at an operator's scope, so it has no copy on the device's
timeline, and a device event of that name (a ``record_function`` span's
copy there) is skipped as the harness's own ``eebench.*`` copies are. Its
parent is its nearest ``ee.*`` ancestor among the profiler's host events.
An idle gap is a stretch of the window with no device operation; every gap
is named, by the host events that cover its middle:
``<innermost eebench.* span> > <innermost ee.* span> > <innermost other
host event>``, the parts that exist (``host idle or untraced`` where none
does). Times in seconds, per-tick values in ms.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from eebench.trace import _union

ENTRIES = ("ee.replan", "ee.replan_refresh", "ee.replan_refresh_mi", "ee.explore",
           "ee.explore_mapping_fused")
STAGES = ("ee.graph.lookup", "ee.graph.copy_in", "ee.graph.replay", "ee.graph.copy_out")
REBUILDS = ("graphs_made", "operand_builds", "libraries_loaded")
UNTRACED = "host idle or untraced"


class Span(NamedTuple):
    name: str
    start: float  # s on the profiler's clock
    end: float
    parent: Optional[int]  # index of the nearest ee.* ancestor in the list, or None


def _window(events) -> Tuple[float, float]:
    from torch.autograd import DeviceType

    window = [e for e in events
              if e.name == "eebench.window" and e.device_type != DeviceType.CUDA]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} eebench.window spans, not 1")
    return window[0].time_range.start, window[0].time_range.end


class Reduced(NamedTuple):
    window: Tuple[float, float]  # s
    spans: List[Span]  # the program's spans in the window, in order of start
    busy_intervals: List[Tuple[float, float]]  # merged device intervals, s
    idle_gaps: Dict[str, float]  # every gap's seconds by its name


def reduce(events) -> Reduced:
    """The program's spans, the device's busy intervals and every idle gap,
    named, over the ``eebench.window`` span of the profiler's ``events``."""
    from torch.autograd import DeviceType

    t0, t1 = _window(events)
    dev, host = [], []
    index = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b < t0 or a > t1:
            continue
        if e.device_type == DeviceType.CUDA:
            if not (e.name.startswith("eebench.") or e.name.startswith("ee.")):
                dev.append((max(a, t0), min(b, t1)))
        elif e.name != "eebench.window":
            host.append(e)
    spans = sorted((e for e in host if e.name.startswith("ee.")),
                   key=lambda e: e.time_range.start)
    for i, e in enumerate(spans):
        index[id(e)] = i
    out = []
    for e in spans:
        p = e.cpu_parent
        while p is not None and id(p) not in index:
            p = p.cpu_parent
        out.append(Span(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                        None if p is None else index[id(p)]))
    _, busy = _union(dev)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    named = _name_gaps(gaps, [(e.time_range.start, e.time_range.end, e.name) for e in host])
    return Reduced((t0 * 1e-6, t1 * 1e-6), out, [(a * 1e-6, b * 1e-6) for a, b in busy], named)


def _name_gaps(gaps: Sequence[Tuple[float, float]], host) -> Dict[str, float]:
    """Seconds of idle by name (module docstring): one sweep over the gaps'
    middles and the host events, both in order of time."""
    host = sorted(host)
    named: Dict[str, float] = defaultdict(float)
    active: list = []
    j = 0
    for a, b in gaps:
        t = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= t:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= t]
        best = {"eebench": None, "ee": None, "op": None}
        for s, e, name in active:
            kind = ("eebench" if name.startswith("eebench.") else
                    "ee" if name.startswith("ee.") else "op")
            if best[kind] is None or e - s < best[kind][0]:
                best[kind] = (e - s, name)
        parts = [best[k][1] for k in ("eebench", "ee", "op") if best[k] is not None]
        named[" > ".join(parts) if parts else UNTRACED] += (b - a) * 1e-6
    return dict(named)


def stage_seconds(red: Reduced) -> Dict[str, float]:
    """Seconds of each ``ee.*`` span name in the window, and under
    ``entry_self`` the entry spans' time less that of their child spans."""
    out: Dict[str, float] = defaultdict(float)
    for s in red.spans:
        out[s.name] += s.end - s.start
        if s.name in ENTRIES:
            out["entry_self"] += s.end - s.start
        if s.parent is not None and red.spans[s.parent].name in ENTRIES:
            out["entry_self"] -= s.end - s.start
    return dict(out)


def idle_in_program_pct(red: Reduced) -> Optional[float]:
    """The share of the window's device-idle time that lies inside an entry
    span, in %; None where the window has no idle time or no entry span."""
    t0, t1 = red.window
    edges = [t0] + [x for ab in red.busy_intervals for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    idle = sum(b - a for a, b in gaps)
    _, entries = _union((s.start, s.end) for s in red.spans if s.name in ENTRIES)
    if idle <= 0.0 or not entries:
        return None
    starts = [a for a, _ in entries]
    inside = 0.0
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(entries) and entries[i][0] < b:
            inside += max(0.0, min(b, entries[i][1]) - max(a, entries[i][0]))
            i += 1
    return 100.0 * inside / idle


def metrics(red: Reduced, ticks: int, counts: Optional[Dict[str, int]]) -> Dict[str, float]:
    """The per-tick readings of a window of ``ticks`` ticks: each stage's ms
    (``entry_self_ms``, ``lookup_ms``, ``copy_in_ms``, ``replay_ms``,
    ``copy_out_ms``, ``capture_ms``), the idle share inside entry calls and,
    from ``counts`` (the program's counters after the window less before),
    the KB copied in and out a tick and the rebuilds in the window."""
    if not ticks:
        return {}
    sec = stage_seconds(red)
    out = {"entry_self_ms": 1e3 * sec.get("entry_self", 0.0) / ticks}
    for name in STAGES + ("ee.graph.capture",):
        out[name.rsplit(".", 1)[1] + "_ms"] = 1e3 * sec.get(name, 0.0) / ticks
    share = idle_in_program_pct(red)
    if share is not None:
        out["idle_in_program_pct"] = share
    if counts is not None:
        out["copy_in_kb_per_tick"] = counts["copy_in_bytes"] / 1024 / ticks
        out["copy_out_kb_per_tick"] = counts["copy_out_bytes"] / 1024 / ticks
        out["rebuilds_in_window"] = sum(counts[k] for k in REBUILDS)
    return out
