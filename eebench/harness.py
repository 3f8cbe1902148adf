"""Run one cell of the benchmark once and print its result line.

    python3 eebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``eebench/configs/<config>.json``) under a traffic mix
(``eebench/traffic/<traffic>.json``, whose ``driver`` names the module
``eebench/drivers/<driver>.py`` that drives the program with it). The
cell's own file ``eebench/workloads/<cell>.json`` holds the limits of its
correctness check. A per-layer metric is read by
``eebench/layers/<metric>.py``. Nothing here names a cell, a configuration
or a metric: a new one is a new file and an entry in ``BENCHMARK.json``.

A run: set-up (import, build or load the kernel libraries, make the inputs
from the seed, capture and replay every graph the cell uses once), the
window (whole requests until ``--seconds`` have passed; the request running
at the deadline completes and counts), then the check against the plain
reference, once the program's state is freed. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` (a run of its own, the window
under ``torch.profiler``) its per-layer metrics and a breakdown. The last
line of standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error and the last key of the
result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "ergodic_exploration_tpu")  # whole top-level names


class Ctx:
    """What a driver is given: the cell's files, the seed, the device, the
    program to drive and, in tests only, a smaller ``scale``."""

    def __init__(self, name, seed, device, config, traffic, cell, program, scale=None):
        self.name, self.seed, self.device = name, seed, device
        self.config, self.traffic, self.cell = config, traffic, cell
        self.program = program
        self.scale = dict(scale or {})

    @property
    def scenarios(self) -> int:
        return int(self.scale.get("scenarios", self.config["fleet"]["scenarios"]))

    def param(self, key):
        """A traffic parameter (a test's ``scale`` may shrink it)."""
        return self.scale.get(key, self.traffic[key])

    @property
    def engine_config(self) -> dict:
        """The configuration's engine settings with the traffic's layout
        settings (``engine`` in the traffic file) on top."""
        return dict(self.config["engine"], **self.traffic.get("engine", {}))


def load(name: str, root: Path = ROOT):
    """(benchmark, cell entry, configuration, traffic, cell file) of the
    cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "eebench" / "traffic" / f"{entry['traffic']}.json").read_text())
    cell = json.loads((root / "eebench" / "workloads" / f"{name}.json").read_text())
    return bench, entry, config, traffic, cell


def cell_metrics(bench: dict, name: str):
    """(end-to-end metrics, per-layer metrics) that the cell ``name`` reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in names
             and name in m.get("workloads", [name])]
    return e2e, layer


def layer_reader(metric: str, root: Path = ROOT):
    """The module ``eebench/layers/<metric>.py`` (a name may hold dots)."""
    path = root / "eebench" / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"eebench_layer_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, program,
             scale: Optional[dict] = None, t_start: Optional[float] = None,
             root: Path = ROOT) -> dict:
    """Run the cell once; returns the result line as a dict (its last key,
    ``checks``, holds each number compared with its limit)."""
    import numpy as np
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, entry, config, traffic, cell = load(name, root)
    e2e, layer = cell_metrics(bench, name)
    driver_mod = importlib.import_module(f"eebench.drivers.{traffic['driver']}")
    ctx = Ctx(name, seed, device, config, traffic, cell, program, scale)
    on_card = str(device).startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    drv = driver_mod.Driver(ctx)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    attempted = failed = solves = 0
    latencies, dispatch = [], []
    t0 = time.perf_counter()
    with torch.profiler.record_function("eebench.window"):
        while True:
            r = drv.request()
            attempted += 1
            failed += 0 if r.ok else 1
            solves += r.solves
            if r.latency_s is not None:
                latencies.append(r.latency_s)
            if r.dispatch_s is not None:
                dispatch.append(r.dispatch_s)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    found = banned_modules()
    if found:
        raise RuntimeError(f"modules loaded in this process that the benchmark may not load: "
                           f"{found}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check()
    print(f"the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in checks)

    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": {}, "device": device_record(device, peak)}
    if not trace:
        # the rate of every cell: solves completed over the window's seconds; the
        # replan cells report it under a name of its own, with its own bound
        rate = solves / window_s
        values = {"solves_per_s": rate, "replan_solves_per_s": rate, "setup_s": setup_s}
        if latencies:
            values["replan_p95_ms"] = 1e3 * float(np.percentile(latencies, 95))
        for m in e2e:
            if m["name"] not in values:
                raise RuntimeError(f"the cell reports no {m['name']}")
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from eebench import trace as trace_mod

        tr = trace_mod.Trace(window_s, attempted, attempted * drv.ticks_per_request,
                             attempted * drv.refreshes_per_request)
        tr.dispatch_s = dispatch
        tr.facts = drv.facts
        tr.ctx = ctx
        if prof is not None and on_card:
            trace_mod.reduce(prof, tr)
        for m in layer:
            reader = layer_reader(m["name"], root)
            v = reader.read(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def device_record(device, peak: int) -> dict:
    import torch

    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").exists():
        print("no BENCHMARK.json beside eebench/", file=sys.stderr)
        return 2
    _, entry, _, _, _ = load(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("the benchmark needs a CUDA device; none is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 2
    from eebench import program

    prog = program.port()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", prog,
                      t_start=t_start)
    found = banned_modules()
    if found:
        print(f"loaded in this process, which the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
