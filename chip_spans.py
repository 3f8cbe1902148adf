"""The port's spans and counters on the card, for one cell of the benchmark,
beside the harness's own reduction (PERF.md section 5).

    python3 chip_spans.py --workload cart_gmm_replan --seed 7 --seconds 10 --trace 1
    python3 chip_spans.py --workload cart_gmm_replan --seed 7 --calls 6000 --trace 0
    python3 chip_spans.py ... --program build/parent      # the port of another tree

``--trace 1``: set-up as ``eebench/run.py`` makes it, then the window under
``torch.profiler`` as its traced run takes it, the program's counters read
on each side of it, then the check. Prints one JSON line: the cell's
per-layer metrics as ``eebench/layers`` reads them, the program's span and
counter readings (``eebench/spans.py``: entry self, lookup, copy-in,
replay, copy-out ms a tick, KB in and out a tick, rebuilds, the idle share
inside entry calls), the harness clock's ms a call, the idle named gap by
gap, and ``correct``.

``--trace 0``: ``--calls`` requests with no profiler running; prints the
host time of each entry call by the harness's clock around it (what
``dispatch_ms.replan`` averages): median, quartiles and mean, in ms.

``--program <tree>``: the port comes from that checkout (a parent unpacked
with ``git archive`` into a directory ``.gitignore`` lists); the harness
and the kernel libraries' build directory stay this checkout's. The card
only: without one it exits 2, unless ``--cpu`` (a rehearsal of the
plumbing at 4 scenarios on the CPU, which times nothing of the card).
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as eebench/run.py
sys.path[0] = str(ROOT)


def _counters():
    """The program's ``counters()``, or None where its port has none."""
    try:
        from ergodic_exploration_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters


def _diff(after, before):
    return None if after is None else {k: after[k] - before.get(k, 0) for k in after}


def main() -> int:
    import argparse
    import importlib
    import json
    import statistics

    import torch

    from eebench import harness, program, spans
    from eebench import trace as trace_mod

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--calls", type=int, default=6000)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--program", default=None)
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    p.add_argument("--cpu", action="store_true", help="rehearse on the CPU at 4 scenarios")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    sync = (lambda: None) if args.cpu else torch.cuda.synchronize
    if not args.cpu and not torch.cuda.is_available():
        print("chip_spans.py needs a CUDA device", file=sys.stderr)
        return 2
    if args.program:
        sys.path.insert(0, str(Path(args.program).resolve()))
    bench, entry, config, traffic, cell = harness.load(args.workload)
    _, layer = harness.cell_metrics(bench, args.workload)
    drv_mod = importlib.import_module(f"eebench.drivers.{traffic['driver']}")
    ctx = harness.Ctx(args.workload, args.seed, device, config, traffic, cell, program.port(),
                      scale={"scenarios": 4, "samples": 1} if args.cpu else None)
    drv = drv_mod.Driver(ctx)
    drv.setup()
    sync()
    import ergodic_exploration_tpu_torch as port

    counters = _counters()
    read = (lambda: counters()) if counters else (lambda: None)
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "port_dir": str(Path(port.__file__).resolve().parents[1]),
           "device": "cpu" if args.cpu else torch.cuda.get_device_name()}
    before = read()
    dispatch, attempted, ticks = [], 0, 0
    if args.trace == 0:
        while attempted < args.calls:
            r = drv.request()
            attempted += 1
            if r.dispatch_s is not None:
                dispatch.append(r.dispatch_s)
        sync()
        out["counts"] = _diff(read(), before)
        if dispatch:
            q = statistics.quantiles(dispatch, n=4)
            out.update(calls=len(dispatch), dispatch_median_ms=1e3 * q[1],
                       dispatch_q1_ms=1e3 * q[0], dispatch_q3_ms=1e3 * q[2],
                       dispatch_mean_ms=1e3 * statistics.fmean(dispatch))
    else:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([] if args.cpu else [ProfilerActivity.CUDA]))
        prof.__enter__()
        t0 = time.perf_counter()
        with torch.profiler.record_function("eebench.window"):
            while True:
                r = drv.request()
                attempted += 1
                if r.dispatch_s is not None:
                    dispatch.append(r.dispatch_s)
                if time.perf_counter() - t0 >= args.seconds:
                    break
            sync()
        window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        counts = _diff(read(), before)
        drv.release()
        if not args.cpu:
            torch.cuda.empty_cache()
        checks = drv.check()
        ticks = attempted * drv.ticks_per_request
        tr = trace_mod.Trace(window_s, attempted, ticks, attempted * drv.refreshes_per_request)
        tr.dispatch_s, tr.facts, tr.ctx = dispatch, drv.facts, ctx
        events = prof.events()
        if not args.cpu:
            trace_mod.reduce(prof, tr)
        t_red = time.perf_counter()
        red = spans.reduce(events)
        reduce_s = time.perf_counter() - t_red
        idle = (red.window[1] - red.window[0]) - sum(b - a for a, b in red.busy_intervals)
        named = sorted(red.idle_gaps.items(), key=lambda kv: -kv[1])
        out.update(
            correct=all(v <= lim for _, v, lim in checks), window_s=window_s, ticks=ticks,
            layers={m["name"]: harness.layer_reader(m["name"]).read(tr) for m in layer},
            busy_s=tr.busy_s, busy_s_spans=sum(b - a for a, b in red.busy_intervals),
            program=spans.metrics(red, ticks, counts), counts=counts,
            dispatch_mean_ms=1e3 * sum(dispatch) / len(dispatch) if dispatch else None,
            idle_s=idle, idle_named_s=sum(red.idle_gaps.values()), idle_gap_names=len(named),
            idle_gaps_top=named[:12], breakdown_idle_gaps=tr.idle_gaps,
            spans_reduce_s=reduce_s)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
