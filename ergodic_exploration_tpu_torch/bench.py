"""Headline benchmark of the port: batched ergodic-MPC solves/s/chip and the
replan latency of one robot (twin of the JAX package's root ``bench.py``).

    python -m ergodic_exploration_tpu_torch.bench

Prints ONE JSON line with the metric "ergodic-MPC solves/s/chip at H=20,
10k grid samples; p50 replan latency", measured on the CUDA device. It has
no CPU mode: without a CUDA device it exits non-zero and prints no metric,
since a number from a CPU run is never printed under these names. Any
exception exits non-zero with its traceback.

Each benchmarked solve is the full per-tick work of ``Engine``'s fused tick:
the GMM target refresh over the 10 000-point lattice, the RK4 rollout
(H = 20), the history-augmented c_k, the ergodic gradient, the barrier
against a real obstacle map's distance field, the co-state sweep, the
saturated update, validation and the DWA fallback. With the fused solve on
a shared map the refresh runs inside K1, so a tick is one launch. Each tick
is a call of the engine's entry point, which on the card replays the CUDA
graph of the tick (``Engine._graph_tick``): the twin of the JAX bench's
``jax.jit(engine._refresh_and_replan_fn, donate_argnums=(0,))``. Three
things are timed:

- ``bench_throughput``: ``Engine.replan_refresh`` at S = 4096, by host clock
  over ``iters`` dependent ticks that end in one read of the controls' sum;
- ``bench_throughput_mi``: the config-4 tick, ``Engine.replan_refresh_mi``
  at S = 4096, the MI target recomputed from the beliefs every tick by K3
  (frontier-masked), then K1;
- ``bench_latency``: the replan latency at S = 1, each replan timed alone
  from the call to the controls on the host.

Each takes ``eager=True`` to time the eager functions instead
(``_refresh_and_replan_fn``, ``_refresh_mi_and_replan_fn``), which dispatch
every operation from Python; ``chip_smoke.py`` prints those beside the
graphs' numbers, never in the headline line.

How it differs from the JAX ``bench.py``:

- The latency estimator. The JAX bench takes a chain difference
  (t(2n) - t(n)) / n, which cancels a fixed round trip of its device
  attachment. That round trip does not exist here, and a robot's replan
  latency is the time from the call to the controls on the host, so each
  sample here is ONE replan ending in ``u.cpu()``.
- No ``vs_baseline``: its denominator is a per-chip target set for another
  accelerator's slice (BASELINE.md), not a number of this card.
- Not ported: ``pad_beliefs`` (lane padding for the Pallas MI kernel; K3
  takes the (S, h, w) beliefs as they are); the deadline watchdog thread of
  ``main`` (it guards a device-claim hang of the JAX attachment that CUDA
  does not have); ``newest_recorded_bench`` / ``_last_recorded_run`` (they
  read the JAX runs' ``BENCH_r*.json`` records, which would put another
  device's numbers beside this card's).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ergodic_exploration_tpu_torch.config import EngineConfig, default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils.device import resolve_device

CELLS, RES = 100, 0.05  # the shared map: 100 x 100 cells of 0.05 m, a 5 m domain
BUDGET_MS = 100.0  # the robot's 10 Hz loop
UNIT = "solves/s/chip (H=20, 10k grid samples, obstacles+DWA)"


class CaseArrays(NamedTuple):
    """The bench inputs, drawn with numpy in the JAX bench's order."""

    x0: np.ndarray  # (S, 3) start poses
    data: np.ndarray  # (100, 100) the shared map: a wall and a pillar
    means: np.ndarray  # (S, 2, 2) two GMM components a scenario
    covs: np.ndarray  # (S, 2, 2, 2) 0.3 I
    weights: np.ndarray  # (S, 2) ones


def case_arrays(S: int, seed: int = 0) -> CaseArrays:
    rng = np.random.default_rng(seed)
    x0 = np.concatenate(
        [rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))], axis=1
    ).astype(np.float32)
    data = np.zeros((CELLS, CELLS), np.float32)
    data[45:50, 20:80] = 1.0
    data[70:78, 60:68] = 1.0
    means = rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    return CaseArrays(x0, data, means, covs, np.ones((S, 2), np.float32))


def belief_array() -> np.ndarray:
    """The config-4 beliefs: the left 55 columns known (free, and the known
    part of the wall), the rest unknown."""
    belief = np.full((CELLS, CELLS), -1.0, np.float32)
    belief[:, :55] = 0.0
    belief[45:50, 20:55] = 1.0
    return belief


def bench_config() -> EngineConfig:
    """K = 10, H = 20, dt = 0.1, a 100 x 100 lattice; the fused solve on one
    shared map with one shared history draw."""
    cfg = default_config("cart").replace(use_fused_solve=True, shared_maps=True,
                                         shared_history_draw=True)
    assert cfg.horizon == 20 and cfg.grid_samples == (100, 100)
    return cfg


def shared_grids(data: np.ndarray, S: int, device) -> GridMap:
    """One (h, w) map seen by all S scenarios, at the origin, 0.05 m a cell."""
    return GridMap(torch.from_numpy(data).to(device).expand(S, *data.shape),
                   torch.zeros((S, 2), device=device), torch.full((S,), RES, device=device))


def _engine_case(S: int, seed: int, device):
    a = case_arrays(S, seed)
    engine = Engine(bench_config(), device=device)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0, device=engine.device)
    return a, engine, engine.init_scenarios(a.x0), domain


def build_case(S: int, seed: int = 0, device=None):
    """(engine, scenarios, gmm, domain, world): S scenarios on the shared
    wall-and-pillar map, the world prepared over each map's extent."""
    a, engine, sc, domain = _engine_case(S, seed, device)
    world = engine.prepare_world(shared_grids(a.data, S, engine.device), domain=None)
    gmm = GaussianMixture.create(a.means, a.covs, a.weights, device=engine.device)
    return engine, sc, gmm, domain, world


def build_case_mi(S: int, seed: int = 0, device=None):
    """(engine, scenarios, beliefs, world, domain): the config-4 case, the
    world prepared from the beliefs. The beliefs stay static across the
    timed ticks."""
    _, engine, sc, domain = _engine_case(S, seed, device)
    grids = shared_grids(belief_array(), S, engine.device)
    return engine, sc, grids, engine.prepare_world(grids), domain


def _gmm_tick(engine, world, eager: bool):
    """The timed GMM tick: ``Engine.replan_refresh`` (a graph replay on the
    card), or with ``eager`` its checks and then ``_refresh_and_replan_fn``."""
    if not eager:
        return engine.replan_refresh
    engine._check_shared_world(world)
    return engine._refresh_and_replan_fn


def _run_chain(step, sc, *args, iters):
    """Time ``iters`` dependent ticks by host clock; the one read of the
    controls' sum at the end waits for the whole chain."""
    t0 = time.perf_counter()
    u = None
    for _ in range(iters):
        sc, u, _ = step(sc, *args)
    total = float(u.sum())
    dt = time.perf_counter() - t0
    if not math.isfinite(total):
        raise RuntimeError("non-finite controls")
    return dt, sc


def bench_throughput(S: int = 4096, iters: int = 50, device=None, reached=None,
                     eager: bool = False) -> float:
    """Solves/s of ``Engine.replan_refresh`` (the GMM refresh and the solve
    in one K1 launch; ``eager``: ``_refresh_and_replan_fn``) at S scenarios.
    The poses are not advanced. ``reached``: a dict that receives the case
    and the state the timed loop reached."""
    engine, sc, gmm, domain, world = build_case(S, device=device)
    step = _gmm_tick(engine, world, eager)
    sc, u, _ = step(sc, gmm, domain, world)  # builds the libraries; captures the graph
    sc, u, _ = step(sc, gmm, domain, world)  # warm
    float(u.sum())
    dt, sc = _run_chain(step, sc, gmm, domain, world, iters=iters)
    if reached is not None:
        reached.update(engine=engine, sc=sc, gmm=gmm, domain=domain, world=world)
    return S * iters / dt


def bench_throughput_mi(S: int = 4096, iters: int = 50, sensor_radius_cells: int = 3,
                        device=None, reached=None, eager: bool = False):
    """(solves/s, mi_frontier_cells) of the config-4 tick,
    ``Engine.replan_refresh_mi`` (``eager``: ``_refresh_mi_and_replan_fn``):
    the MI target recomputed from the beliefs every tick by K3, then K1 on
    it. The frontier cells are read from the engine that was benched."""
    engine, sc, grids, world, domain = build_case_mi(S, device=device)
    tick = engine.replan_refresh_mi
    if eager:  # the entry point's checks, then its eager function
        engine._check_shared_world(world)
        engine._check_shared_grids(grids)
        tick = engine._refresh_mi_and_replan_fn

    def step(s, g, w):
        return tick(s, g, w, sensor_radius_cells, domain, use_mi_kernel=True)

    sc, u, _ = step(sc, grids, world)  # builds the libraries; captures the graph
    sc, u, _ = step(sc, grids, world)  # warm
    float(u.sum())
    dt, sc = _run_chain(step, sc, grids, world, iters=iters)
    if reached is not None:
        reached.update(engine=engine, sc=sc, grids=grids, world=world, domain=domain)
    return S * iters / dt, engine.config.mi_frontier_cells


def bench_latency(reps: int = 24, group: int = 8, chain: int = 32, device=None,
                  reached=None, eager: bool = False) -> dict:
    """Replan latency at S = 1 in ms of ``Engine.replan_refresh``
    (``eager``: ``_refresh_and_replan_fn``): ``reps`` runs of ``chain``
    dependent replans after a warm-up, each replan timed alone by host clock
    from the call to its controls on the host (``u.cpu()``). p50 and p99 are
    over all replans; the spread is the least and the greatest median of the
    ``reps // group`` groups of ``group`` runs. Each run starts from the
    warm state."""
    if reps % group:
        raise ValueError(f"reps {reps} is not a multiple of group {group}")
    engine, sc, gmm, domain, world = build_case(1, device=device)
    step = _gmm_tick(engine, world, eager)
    sc, u, _ = step(sc, gmm, domain, world)  # builds the libraries; captures the graph
    _run_chain(step, sc, gmm, domain, world, iters=chain)  # warm
    ms = np.empty((reps, chain))
    for i in range(reps):
        s = sc
        for j in range(chain):
            t0 = time.perf_counter()
            s, u, _ = step(s, gmm, domain, world)
            u = u.cpu()
            ms[i, j] = 1e3 * (time.perf_counter() - t0)
            if not torch.isfinite(u).all():
                raise RuntimeError("non-finite controls")
    if reached is not None:
        reached.update(engine=engine, sc=s, gmm=gmm, domain=domain, world=world)
    medians = np.median(ms.reshape(reps // group, group * chain), axis=1)
    return {"p50": float(np.median(ms)), "p99": float(np.percentile(ms, 99)),
            "min": float(medians.min()), "max": float(medians.max()), "reps": reps,
            "chain": chain}


def device_info(device) -> dict:
    """The device a run measured: ``device`` the platform word ("gpu" for a
    CUDA device), ``card`` its name and power limit as nvidia-smi prints
    them (None off the card), ``device_count``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device": dev.type, "card": None, "device_count": 1}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"device": "gpu", "card": smi.stdout.strip(),
            "device_count": torch.cuda.device_count()}


def _call(name, fn, **kw):
    return fn(**kw)


def _run(device=None, S: int = 4096, iters: int = 50, reps: int = 24, group: int = 8,
         chain: int = 32, watch=_call) -> dict:
    """The headline line as a dict. ``watch(name, fn, **kw)`` makes each of
    the three timed calls (``fn(**kw)``; name "throughput", "mi" or
    "latency"), so that a caller can count launches around each."""
    solves = watch("throughput", bench_throughput, S=S, iters=iters, device=device)
    mi_solves, mi_fc = watch("mi", bench_throughput_mi, S=S, iters=iters, device=device)
    lat = watch("latency", bench_latency, reps=reps, group=group, chain=chain, device=device)
    return {
        "metric": "ergodic_mpc_solves_per_s_per_chip",
        "value": solves,
        "unit": UNIT,
        "mi_solves_per_s_per_chip": mi_solves,
        "mi_vs_gmm_tick": mi_solves / solves,
        # the MI target is frontier-masked; the benched engine's own value
        "mi_frontier_cells": mi_fc,
        "p50_replan_latency_ms": lat["p50"],
        "p99_replan_latency_ms": lat["p99"],
        "latency_spread_ms": [lat["min"], lat["max"]],
        "latency_reps": lat["reps"],
        "latency_chain": lat["chain"],
        "latency_budget_ms": BUDGET_MS,
        "batch": S,
        **device_info(device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("the headline benchmark needs a CUDA device; none is available", file=sys.stderr)
        return 2
    print(json.dumps(_run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
