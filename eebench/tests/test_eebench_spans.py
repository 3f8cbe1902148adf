"""The program's spans in a traced window (``eebench/spans.py``) on
synthetic profiler events, and what they leave unchanged in the harness's
own reduction (``eebench/trace.py``) and its readers.

The window (µs): an ``eebench.replan`` request holding the port's entry
span ``ee.replan_refresh``, whose children are the graph cache's lookup,
copy-in, replay (a ``cudaGraphLaunch`` inside) and copy-out (a
``cudaMemcpyAsync`` inside); the device runs two kernels and a copy; then
the harness's plant. Hand-computed: busy 140 of 1000 µs; idle gaps
[0, 200) (its middle in the request, before the entry call), [250, 270)
(in the replay's graph launch), [350, 360) (in the copy-out) and
[370, 1000) (its middle, 685, in the plant).
"""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from eebench import harness, spans
from eebench import trace as trace_mod

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, a, b, dev=CPU, parent=None):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b),
                           cpu_parent=parent)


def _events(program_spans=True, device_copy=False):
    """The window's events; ``program_spans`` False leaves out the port's
    ``ee.*`` host events (the parent's program); ``device_copy`` adds a
    device-side copy of the replay span, as ``record_function`` draws one."""
    w = _ev("eebench.window", 0.0, 1000.0)
    req = _ev("eebench.replan", 90.0, 400.0, parent=w)
    ev = [w, req]
    if program_spans:
        entry = _ev("ee.replan_refresh", 110.0, 390.0, parent=req)
        lookup = _ev("ee.graph.lookup", 120.0, 140.0, parent=entry)
        copy_in = _ev("ee.graph.copy_in", 140.0, 160.0, parent=entry)
        replay = _ev("ee.graph.replay", 160.0, 300.0, parent=entry)
        copy_out = _ev("ee.graph.copy_out", 300.0, 380.0, parent=entry)
        ev += [entry, lookup, copy_in, replay, copy_out]
        up, down = replay, copy_out
    else:
        up = down = req
    ev += [_ev("cudaGraphLaunch", 170.0, 290.0, parent=up),
           _ev("cudaMemcpyAsync", 310.0, 330.0, parent=down),
           _ev("k1_refresh", 200.0, 250.0, CUDA), _ev("k1_solve", 270.0, 350.0, CUDA),
           _ev("Memcpy DtoD", 360.0, 370.0, CUDA),
           _ev("eebench.plant", 500.0, 900.0, parent=w)]
    if device_copy:
        ev.append(_ev("ee.graph.replay", 200.0, 370.0, CUDA))
    return ev


BUSY = [200e-6, 250e-6, 270e-6, 350e-6, 360e-6, 370e-6]


def _flat(intervals):
    return [x for ab in intervals for x in ab]


def _trace(events, ticks=1):
    tr = trace_mod.Trace(1e-3, ticks, ticks)
    tr.dispatch_s = [280e-6]
    return trace_mod.reduce(SimpleNamespace(events=lambda: events), tr)


def test_a_device_side_copy_of_a_span_is_not_busy_time():
    plain, copied = spans.reduce(_events()), spans.reduce(_events(device_copy=True))
    assert plain.busy_intervals == copied.busy_intervals
    assert _flat(plain.busy_intervals) == pytest.approx(BUSY)
    assert plain.idle_gaps == copied.idle_gaps


def test_program_spans_leave_the_harness_reduction_unchanged():
    """Host-only ``ee.*`` spans (as the port records them) change neither the
    busy time, the kernels nor the runtime calls, and every reader that the
    replan cells report reads what it read without them."""
    with_spans, without = _trace(_events()), _trace(_events(program_spans=False))
    assert with_spans.busy_s == without.busy_s == pytest.approx(140e-6)
    assert with_spans.kernels == without.kernels
    assert with_spans.runtime_calls == without.runtime_calls == 2
    bench = harness.load("cart_gmm_replan")[0]
    _, layer = harness.cell_metrics(bench, "cart_gmm_replan")
    for m in layer:
        if "roofline" in m["name"]:
            continue  # the work counts need the check's facts, not the trace
        read = harness.layer_reader(m["name"]).read
        assert read(with_spans) == read(without), m["name"]
    assert _flat(spans.reduce(_events()).busy_intervals) == pytest.approx(BUSY)


def test_every_gap_is_named_and_the_names_sum_to_the_idle():
    red = spans.reduce(_events())
    idle = 1e-3 - sum(b - a for a, b in red.busy_intervals)
    assert sum(red.idle_gaps.values()) == pytest.approx(idle, rel=1e-9)
    assert red.idle_gaps == pytest.approx({
        "eebench.replan": 200e-6, "eebench.replan > ee.graph.replay > cudaGraphLaunch": 20e-6,
        "eebench.replan > ee.graph.copy_out": 10e-6, "eebench.plant": 630e-6})
    bare = spans.reduce([_ev("eebench.window", 0.0, 10.0)])
    assert bare.idle_gaps == {spans.UNTRACED: pytest.approx(10e-6)}


def test_span_parents_and_the_readings_per_tick():
    red = spans.reduce(_events())
    names = [s.name for s in red.spans]
    assert names == ["ee.replan_refresh", "ee.graph.lookup", "ee.graph.copy_in",
                     "ee.graph.replay", "ee.graph.copy_out"]
    assert [s.parent for s in red.spans] == [None, 0, 0, 0, 0]
    counts = {"graphs_made": 0, "operand_builds": 1, "libraries_loaded": 0,
              "copy_in_bytes": 4096, "copy_out_bytes": 2048}
    got = spans.metrics(red, 2, counts)
    # entry 280 µs less its children 20 + 20 + 140 + 80: 20 µs; all over 2 ticks
    assert got == pytest.approx({
        "entry_self_ms": 0.010, "lookup_ms": 0.010, "copy_in_ms": 0.010, "replay_ms": 0.070,
        "copy_out_ms": 0.040, "capture_ms": 0.0, "copy_in_kb_per_tick": 2.0,
        "copy_out_kb_per_tick": 1.0, "rebuilds_in_window": 1,
        # idle inside [110, 390]: 90 + 20 + 10 + 20 of 860 µs
        "idle_in_program_pct": 100.0 * 140.0 / 860.0})
    assert spans.metrics(red, 0, counts) == {}
    assert "copy_in_kb_per_tick" not in spans.metrics(red, 2, None)
