#!/usr/bin/env python3
"""Where a tick's time goes on the card: a ``torch.profiler`` window over the
port's loops on one NVIDIA GPU.

    python3 chip_profile.py

Each loop below is first timed by CUDA events (every loop, before any
profiler session: a session leaves hooks behind that slow later launches),
then profiled. For each it prints the time a tick (or a refresh), the
device's busy time (the sum of its kernels', copies' and memsets' durations)
and its share of the unprofiled and of the profiled time, the kernels the
device ran and the
host's CUDA runtime calls a tick, and the kernels that take most of the
device time:

  A  the bench tick (``replan_refresh``, shared map, K1 with the refresh),
     one tick a call: the graph replay (the entry point) and the eager
     function (``_refresh_and_replan_fn``)
  B  ``explore`` with K1 on 4096 distinct maps (the quick-start loop, fused),
     10 ticks a call: the graph replays and the plain loop (``_explore_loop``)
  C  the same for the default configuration (the eager step: glue_pre, K1
     without its safety stage, k1_safety, glue_post), S=512
  E  the MI tick (disc reveal + ``replan_refresh_mi`` with K3 + pose advance),
     graph replay and eager function (``_refresh_mi_and_replan_fn``); the
     same with the dense path (M, ``use_mi_kernel=False``) in K3's place
  F  the mapping loop: 10 ticks of ``explore`` on the beliefs' world after a
     ray-cast reveal, graphs and loop; two whole refreshes of
     ``explore_mapping_fused``, graphs and ``_explore_mapping_fused_loop``
     (the reveal, the dense MI target M and the world rebuild, its free mask
     included, one kernel each a refresh, M two with its finish, their times
     printed; a refresh lists every kernel it ran)
  Q  the same for the quality run (``default_config("omni")``, S=256, its
     spawns)

A, B, C and Q's ticks run twice more as graphs: with the tick's glue
(``ops/tick_glue.py``, two kernels a tick) and with its plain versions in
their place (``chip_smoke.with_plain_glue``: the glue as plain PyTorch
ops), each on an engine of its own, so each captures its own graphs; the
glue's share of the device time is printed where its kernels run.

The cases are those of ``chip_smoke.py``. Needs a CUDA device.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the profiler's name of a glue kernel: "glue_pre_kernel(...)", or with
# template arguments "void glue_post_kernel<false, true>(...)"
GLUE_KERNEL = re.compile(r"(?:void )?glue_(?:pre|post)_kernel\b")
# the map kernels: "void reveal_kernel<false>(...)", "void edt_kernel<unsigned char, false,
# true>(...)"
REVEAL_KERNEL = re.compile(r"(?:void )?reveal_kernel\b")
EDT_KERNEL = re.compile(r"(?:void )?edt_kernel\b")
# M, the dense MI target: "m_phik_dense(MParams, MBuffers)" and its "m_finish(...)"
DENSE_KERNEL = re.compile(r"(?:void )?m_(?:phik_dense|finish)\b")
CALLS = 10  # calls of a one-tick loop timed and profiled, after as many warm ones
BLOCK = 10  # ticks a call of B, C, F and Q


def timed(fn, calls=CALLS) -> float:
    """ms a call of ``fn`` by CUDA events, after ``calls`` warm calls."""
    import torch

    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def profile(name, fn, ms_call, card, units, unit="tick", calls=CALLS):
    """Profile ``calls`` calls of ``fn`` (``units`` ticks or refreshes each)
    and print its split beside ``ms_call``, its unprofiled time a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name, host = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        elif e.name.startswith("cu"):
            host += 1
    n = calls * units
    kernels = {k: v for k, v in by_name.items() if not k.startswith(("Memcpy", "Memset"))}
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    glue_ms = sum(us for k, (_, us) in by_name.items() if GLUE_KERNEL.match(k)) / 1e3
    reveal_ms = sum(us for k, (_, us) in by_name.items() if REVEAL_KERNEL.match(k)) / 1e3
    edt_ms = sum(us for k, (_, us) in by_name.items() if EDT_KERNEL.match(k)) / 1e3
    dense_ms = sum(us for k, (_, us) in by_name.items() if DENSE_KERNEL.match(k)) / 1e3
    launches = sum(c for c, _ in kernels.values()) / n
    print(f"== {name}: {ms_call / units:.4f} ms a {unit} (CUDA events, unprofiled); device busy "
          f"{busy_ms / n:.4f} ms a {unit} ({100 * busy_ms / n / (ms_call / units):.1f} % of the "
          f"unprofiled {unit}, {100 * busy_ms / wall_ms:.1f} % of the profiled run); "
          f"kernels run {launches:.1f} a {unit}; host CUDA runtime calls {(host - 3) / n:.2f} a "
          f"{unit}; the glue kernels {glue_ms / n:.4f} ms a {unit} "
          f"({100 * glue_ms / max(busy_ms, 1e-9):.1f} % of busy); the map kernels: the reveal "
          f"{reveal_ms / n:.4f} ms, E (the world rebuild, its free mask inside) {edt_ms / n:.4f} "
          f"ms a {unit}; M (the dense MI target) {dense_ms / n:.4f} ms a {unit} {card}")
    if not by_name:
        print("   the profiler recorded no device time")
    # a refresh lists every kernel it ran (which shows what plain torch is left)
    shown = len(by_name) if unit == "refresh" else 8
    for key, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:shown]:
        print(f"   {us / 1e3 / n:9.4f} ms/{unit}  x{c / n:6.1f}  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.tools import quality

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = f"[{smi.stdout.strip().splitlines()[0]}]"
    print(card)
    loops = []  # (name, fn, ticks or refreshes a call, unit)

    def plain_glue(call):
        return lambda: cs.with_plain_glue(call)

    engine, sc, world, gmm, domain = cs.build_engine(cs.S_MAIN, dev)
    engine_p = cs.build_engine(cs.S_MAIN, dev)[0]  # its graph holds the plain glue
    for kind, eng_a, run, wrap in (
            ("graph replay", engine, engine.replan_refresh, None),
            ("eager", engine, engine._refresh_and_replan_fn, None),
            ("graph replay, the glue's plain versions", engine_p, engine_p.replan_refresh,
             plain_glue)):
        state = [sc]

        def tick_a(run=run, state=state, eng_a=eng_a):
            s, u, _ = run(state[0], gmm, domain, world)
            state[0] = cs.advance(eng_a, s, u)

        loops.append((f"A bench tick, S={cs.S_MAIN}, {kind}", wrap(tick_a) if wrap else tick_a,
                      1, "tick"))

    def explore_pair(tag, eng, sc, phik, world, eng_plain=None):
        """``explore`` (graphs) and ``_explore_loop``, BLOCK ticks a call,
        each carrying its own state on; with ``eng_plain`` also ``explore``
        on that engine with the glue's plain versions."""
        runs = [("graphs", eng.explore, None), ("plain loop", eng._explore_loop, None)]
        if eng_plain is not None:
            runs.append(("graphs, the glue's plain versions", eng_plain.explore, plain_glue))
        for kind, run, wrap in runs:
            st = [sc]

            def call(run=run, st=st):
                st[0] = run(st[0], phik, world, BLOCK).scenarios

            loops.append((f"{tag}, {kind}", wrap(call) if wrap else call, BLOCK, "tick"))

    def refresh_pair(tag, eng, sc, truth, every):
        for kind, run in (("graphs", eng.explore_mapping_fused),
                          ("plain loop", eng._explore_mapping_fused_loop)):
            st = [sc]

            def call(run=run, st=st):
                st[0] = run(st[0], truth, 2, every)[0]

            loops.append((f"{tag}, {kind}", call, 2, "refresh"))

    for name, S, kw in ((f"B explore, K1 on distinct maps, S={cs.S_MAIN}", cs.S_MAIN, {}),
                        ("C explore, default configuration (eager), S=512", 512,
                         dict(use_fused_solve=False))):
        cfg, x0, grids, gmm_b, dom_b = cs.distinct_case(S, dev, **kw)
        eng = Engine(cfg)
        world_b = eng.prepare_world(grids)
        explore_pair(name, eng, eng.init_scenarios(x0),
                     eng.phik_from_gmm(gmm_b, dom_b, world_b), world_b, Engine(cfg))

    engine_e, sc_e, belief, truth_e, world_e, domain_e = cs.mi_case(cs.S_MAIN, dev)
    for use_k3, tag in ((True, "K3 + K1"), (False, "the dense path: M + K1")):
        for kind, run in (("graph replay", engine_e.replan_refresh_mi),
                          ("eager", engine_e._refresh_mi_and_replan_fn)):
            st_e = [sc_e, belief]

            def tick_e(run=run, st_e=st_e, use_k3=use_k3):
                b = sensor.reveal(st_e[1], truth_e, st_e[0].x, 0.75)
                s, u, _ = run(st_e[0], b, world_e, cs.MI_RADIUS, domain_e, use_mi_kernel=use_k3)
                st_e[:] = [cs.advance(engine_e, s, u), b]

            loops.append((f"E MI tick ({tag}), S={cs.S_MAIN}, {kind}", tick_e, 1, "tick"))

    def mapping_loops(tag, eng, x0, truth, every, eng_plain=None):
        """After one refresh from unknown beliefs: BLOCK ticks on its world
        (with ``eng_plain`` also on the glue's plain versions), then whole
        refreshes from unknown beliefs."""
        sc, belief, _, _, _ = eng.explore_mapping_fused(eng.init_scenarios(x0), truth,
                                                        n_refreshes=1, refresh_every=every)
        world = eng.prepare_world(belief)
        phik = eng.phik_from_grid(belief, domain=Domain(truth.origin[0],
                                                         truth.domain().lengths[0]))
        explore_pair(f"{tag}: ticks on the beliefs' world", eng, sc, phik, world, eng_plain)
        refresh_pair(f"{tag}: refreshes from unknown beliefs (reveal + MI target + world + "
                     f"{every} ticks)", eng, eng.init_scenarios(x0), truth, every)

    cfg, x0, truth = cs.mapping_case(cs.S_MAIN, dev)
    mapping_loops(f"F mapping loop, S={cs.S_MAIN}", Engine(cfg), x0, truth, cs.MAP_EVERY)
    eng_q = Engine(default_config("omni"))
    truth_q = quality.build_truth(cs.Q_S, dev)
    mapping_loops(f"Q quality run (omni, eager), S={cs.Q_S}", eng_q,
                  quality.spawn_poses(eng_q.config, truth_q, cs.Q_S), truth_q, cs.Q_EVERY,
                  Engine(default_config("omni")))

    # every loop timed before the first profiler session; a call of B, C,
    # F or Q holds 10 ticks or 2 refreshes, so one call is profiled
    ms = [timed(fn, CALLS if units == 1 else 2) for _, fn, units, _ in loops]
    for (name, fn, units, unit), ms_call in zip(loops, ms):
        profile(name, fn, ms_call, card, units, unit, CALLS if units == 1 else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
