#!/usr/bin/env python3
"""Where a tick's time goes on the card: a ``torch.profiler`` window over the
port's closed loops on one NVIDIA GPU.

    python3 chip_profile.py

For each of six loops of ``ergodic_exploration_tpu_torch`` it runs 10 warm
ticks, then profiles 10 ticks and prints the tick time (CUDA events), the
device-busy time per tick (sum of the kernels' device time), the kernel
launches per tick and the kernels that take most of the device time:

  A  the bench tick (``replan_refresh``, shared map, K1 with the refresh)
  B  ``explore`` with K1 on 4096 distinct maps (the quick-start loop, fused)
  C  ``explore`` of the default configuration (eager step + fused_safety), S=512
  E  the MI tick (disc reveal + ``replan_refresh_mi`` with K3 + pose advance)
  F  one tick of the mapping loop (``explore`` on the beliefs' world after a
     ray-cast reveal), and one whole map refresh of it in a single window
  Q  one eager tick of the quality run (``default_config("omni")``, S=256,
     its spawns) after a ray-cast reveal, and one whole refresh of it

The cases are those of ``chip_smoke.py``. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TICKS = 10


def profile(name, tick, card, ticks=TICKS):
    """Profile ``ticks`` calls of ``tick`` (after as many warm ones)."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(ticks):
        tick()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ticks):
        tick()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / ticks
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, memsets), by their own duration
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    kernels = {k: v for k, v in by_name.items() if not k.startswith(("Memcpy", "Memset"))}
    busy_ms = sum(us for _, us in by_name.values()) / 1e3 / ticks
    launches = sum(n for n, _ in kernels.values()) / ticks
    print(f"== {name}: tick {ms:.4f} ms (CUDA events, unprofiled); device busy "
          f"{busy_ms:.4f} ms per tick ({100 * busy_ms / ms:.1f} %); kernel launches per tick "
          f"{launches:.1f} {card}")
    if not by_name:
        print("   the profiler recorded no device time")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"   {us / 1e3 / ticks:9.4f} ms/tick  x{n / ticks:6.1f}  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = f"[{smi.stdout.strip().splitlines()[0]}]"
    print(card)

    engine, sc, world, gmm, domain = cs.build_engine(cs.S_MAIN, dev)
    state = [sc]

    def tick_a():
        s, u, _ = engine.replan_refresh(state[0], gmm, domain, world)
        state[0] = cs.advance(engine, s, u)

    profile(f"A bench tick, S={cs.S_MAIN}", tick_a, card)

    for name, S, kw in ((f"B explore, K1 on distinct maps, S={cs.S_MAIN}", cs.S_MAIN, {}),
                        ("C explore, default configuration (eager), S=512", 512,
                         dict(use_fused_solve=False))):
        cfg, x0, grids, gmm, domain = cs.distinct_case(S, dev, **kw)
        eng = Engine(cfg)
        world = eng.prepare_world(grids)
        phik = eng.phik_from_gmm(gmm, domain, world)
        st = [eng.init_scenarios(x0)]

        def tick_b():
            st[0] = eng.explore(st[0], phik, world, 1).scenarios

        profile(name, tick_b, card)

    from ergodic_exploration_tpu_torch.ops import sensor

    engine, sc, belief, truth, world, domain = cs.mi_case(cs.S_MAIN, dev)
    st_e = [sc, belief]

    def tick_e():
        b = sensor.reveal(st_e[1], truth, st_e[0].x, 0.75)
        s, u, _ = engine.replan_refresh_mi(st_e[0], b, world, sensor_radius_cells=cs.MI_RADIUS,
                                           domain=domain, use_mi_kernel=True)
        st_e[:] = [cs.advance(engine, s, u), b]

    profile(f"E MI tick (K3 + K1), S={cs.S_MAIN}", tick_e, card)
    del engine, sc, belief, truth, world, st_e
    torch.cuda.empty_cache()

    cfg, x0, truth = cs.mapping_case(cs.S_MAIN, dev)
    eng = Engine(cfg)
    sc, belief, _, _, _ = eng.explore_mapping_fused(eng.init_scenarios(x0), truth, n_refreshes=1,
                                                    refresh_every=cs.MAP_EVERY)
    world = eng.prepare_world(belief)
    phik = eng.phik_from_grid(belief, domain=Domain(truth.origin[0],
                                                     truth.domain().lengths[0]))
    st_f = [sc]

    def tick_f():
        st_f[0] = eng.explore(st_f[0], phik, world, 1).scenarios

    profile(f"F one tick of the mapping loop, S={cs.S_MAIN}", tick_f, card)

    def refresh_f():
        st_f[0] = eng.explore_mapping_fused(st_f[0], truth, n_refreshes=1,
                                            refresh_every=cs.MAP_EVERY)[0]

    profile(f"F one map refresh from unknown beliefs (reveal + MI target + world + "
            f"{cs.MAP_EVERY} ticks), S={cs.S_MAIN}", refresh_f, card, ticks=2)
    del eng, sc, belief, truth, world, phik, st_f
    torch.cuda.empty_cache()

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.tools import quality

    eng = Engine(default_config("omni"))
    truth = quality.build_truth(cs.Q_S, dev)
    sc, belief, _, _, _ = eng.explore_mapping_fused(
        eng.init_scenarios(quality.spawn_poses(eng.config, truth, cs.Q_S)), truth,
        n_refreshes=1, refresh_every=cs.Q_EVERY)
    world = eng.prepare_world(belief)
    phik = eng.phik_from_grid(belief, domain=Domain(truth.origin[0], truth.domain().lengths[0]))
    st_q = [sc]

    def tick_q():
        st_q[0] = eng.explore(st_q[0], phik, world, 1).scenarios

    profile(f"Q one eager tick of the quality run (omni), S={cs.Q_S}", tick_q, card)

    def refresh_q():
        st_q[0] = eng.explore_mapping_fused(st_q[0], truth, n_refreshes=1,
                                            refresh_every=cs.Q_EVERY)[0]

    profile(f"Q one refresh of the quality run from unknown beliefs (reveal + MI target + "
            f"world + {cs.Q_EVERY} ticks), S={cs.Q_S}", refresh_q, card, ticks=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
