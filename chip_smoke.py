#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds it
against its plain PyTorch version on the card at the main path's shapes,
then drives the main path — ``Engine.replan_refresh`` of
``ergodic_exploration_tpu_torch`` at the bench configuration (cart, K=10,
H=20, 100 x 100 lattice, shared map, shared history draw, safety on) — at
S=4096 scenarios and at S=1, and checks what comes out. Any failed phase
exits non-zero. Without a CUDA device it exits non-zero before printing any
result. The last two lines are a JSON line describing each kernel of the
path (launches in the main-path run, error against the plain version, times)
and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S_MAIN = 4096
WARM_TICKS = 120  # history depth of the state the kernel is checked on
TIMED_TICKS = 50
LATENCY_TICKS = 200
CODE_MISMATCH_LIMIT = 2  # scenarios whose code / feasible / u_dwa may differ

# kernel vs plain tolerances (same inputs, same card): controls at the
# parity budget of tests/test_solve_kernel.py; the metric, barrier and
# ck_sum are float32 sums taken in another order (atol covers zeros)
TOL = dict(U_new=dict(rtol=0.0, atol=5e-5), metric=dict(rtol=1e-5, atol=1e-7),
           barrier=dict(rtol=1e-5, atol=1e-7), ck_sum=dict(rtol=1e-5, atol=5e-6))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bench_case(S: int, device, seed: int = 0):
    """bench.py's build_case, in numpy: poses uniform in [0.5, 4.5]^2 x
    (-pi, pi), a wall and a pillar on one shared 100 x 100 map of a 5 m
    domain, a two-component GMM per scenario (means uniform in [1, 4],
    covariance 0.3 I)."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    cfg = default_config("cart").replace(use_fused_solve=True, shared_maps=True,
                                         shared_history_draw=True)
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((100, 100), np.float32)
    data[45:50, 20:80] = 1.0
    data[70:78, 60:68] = 1.0
    grids = GridMap(torch.from_numpy(data).to(device).expand(S, 100, 100),
                    torch.zeros((S, 2), device=device), torch.full((S,), 0.05, device=device))
    means = rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    gmm = GaussianMixture.create(means, covs, np.ones((S, 2), np.float32), device=device)
    return cfg, x0, grids, gmm, Domain.create(0.0, 0.0, 5.0, 5.0, device=device)


def advance(engine, sc, u):
    """One dt of real motion through the port's rollout."""
    from ergodic_exploration_tpu_torch.ops.integrator import rollout

    x = rollout(engine.model, sc.x, u[:, None, :], engine.config.dt)[:, -1]
    return sc._replace(x=x, vb=engine.model.twist(u))


def build_engine(S: int, device):
    from ergodic_exploration_tpu_torch.engine import Engine

    cfg, x0, grids, gmm, domain = bench_case(S, device)
    engine = Engine(cfg, device=device)
    sc = engine.init_scenarios(x0)
    world = engine.prepare_world(grids)
    return engine, sc, world, gmm, domain


def events_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, k, p) -> float:
    """Kernel vs plain outputs; fails on a breach, returns max |U diff|."""
    import torch

    for field, tol in TOL.items():
        a, b = getattr(k, field), getattr(p, field)
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: {field} shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        err = (a - b).abs()
        bound = tol["atol"] + tol["rtol"] * b.abs()
        bad = (err > bound).nonzero().flatten().tolist()
        print(f"  {name} {field}: max |kernel - plain| {err.max().item():.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']}), {len(bad)} outside")
        if bad:
            fail(f"{name}: {field} outside tolerance at flat indices {bad[:10]}")
    mism = ((k.code != p.code) | (k.feasible != p.feasible) | (k.u_dwa != p.u_dwa).any(1))
    idx = mism.nonzero().flatten().tolist()
    for i in idx[:20]:
        print(f"  {name} mismatch at scenario {i}: code {k.code[i].item()} vs "
              f"{p.code[i].item()}, feasible {k.feasible[i].item()} vs "
              f"{p.feasible[i].item()}, u_dwa {k.u_dwa[i].tolist()} vs {p.u_dwa[i].tolist()}")
    print(f"  {name} code/feasible/u_dwa: {len(idx)} of {k.code.shape[0]} scenarios differ "
          f"(limit {CODE_MISMATCH_LIMIT}); DWA active in {(p.code >= 2).sum().item()}")
    if len(idx) > CODE_MISMATCH_LIMIT:
        fail(f"{name}: {len(idx)} scenarios differ in code / feasible / u_dwa")
    return (k.U_new - p.U_new).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk

    # ---- 1. environment
    print("== 1. environment", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    card = f"[{card_line}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from ergodic_exploration_tpu_torch.utils.cuda_build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton

        print("triton", triton.__version__)
    except ImportError:
        print("triton absent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"TF32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    built = sk.K1.build()
    print(f"K1 built in {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s) "
          f"-> {built.path.relative_to(ROOT)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. K1 against its plain version at the main path's shapes
    print(f"== 3. K1 vs plain, S={S_MAIN}, state after {WARM_TICKS} ticks", flush=True)
    engine, sc, world, gmm, domain = build_engine(S_MAIN, dev)
    for _ in range(WARM_TICKS):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    cfg = engine.config
    inp2, _, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
    inp0 = inp2._replace(refresh=None, phik=sk.refresh_plain(inp2.refresh, inp2.dlen))
    err = 0.0
    for name, inp in (("J=2", inp2), ("J=0", inp0)):
        k, p = sk.K1(cfg, inp), sk.fused_solve_safety_plain(cfg, inp)
        torch.cuda.synchronize()
        err = max(err, compare(name, k, p))
    k1_ms = events_ms(lambda: sk.K1(cfg, inp2), 20)
    plain_ms = events_ms(lambda: sk.fused_solve_safety_plain(cfg, inp2), 5)
    print(f"K1 (J=2) {k1_ms:.4f} ms/call, plain version {plain_ms:.4f} ms/call at "
          f"S={S_MAIN} {card}")

    # ---- 4. the main path
    print(f"== 4. main path: Engine.replan_refresh, S={S_MAIN}", flush=True)
    del engine, sc, world, inp0, inp2, k, p
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine, sc, world, gmm, domain = build_engine(S_MAIN, dev)
    torch.cuda.synchronize()
    print(f"init_scenarios + prepare_world {1e3 * (time.perf_counter() - t0):.1f} ms {card}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    torch.cuda.synchronize()
    sk.K1.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    diverged = torch.zeros(S_MAIN, dtype=torch.bool, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    dwa, metric = [], []
    for _ in range(TIMED_TICKS):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
        diverged |= diag.diverged
        finite &= torch.isfinite(u).all() & torch.isfinite(diag.ergodic_metric).all()
        dwa.append(diag.dwa_active.float().mean())
        metric.append(diag.ergodic_metric.mean())
    end.record()
    torch.cuda.synchronize()
    launches = sk.K1.launches
    ms = start.elapsed_time(end) / TIMED_TICKS
    if launches != TIMED_TICKS:
        fail(f"K1 launched {launches} times in {TIMED_TICKS} ticks")
    if u.shape != (S_MAIN, cfg.nu) or not bool(finite) or not torch.isfinite(sc.x).all():
        fail("main path produced non-finite or mis-shaped outputs")
    if diverged.any():
        fail(f"{int(diverged.sum())} scenarios diverged")
    print(f"K1 launches {launches} in {TIMED_TICKS} ticks; all finite; none diverged")
    print(f"tick (replan_refresh + pose advance): {ms:.4f} ms, "
          f"{S_MAIN * 1e3 / ms:.1f} solves/s {card}")
    print(f"peak device memory over the ticks (world, state and temporaries) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}")
    print(f"DWA-active share {torch.stack(dwa).mean().item():.4f}, mean ergodic metric "
          f"{torch.stack(metric).mean().item():.6f}")

    # the same ticks with the plain version in K1's place (comparison only)
    plain_tick = engine.replan_refresh.__func__
    sk_fn = sk.fused_solve_safety
    sk.fused_solve_safety = sk.fused_solve_safety_plain
    try:
        plain_tick_ms = events_ms(lambda: plain_tick(engine, sc, gmm, domain, world), 5)
    finally:
        sk.fused_solve_safety = sk_fn
    print(f"tick with the plain version in K1's place: {plain_tick_ms:.4f} ms vs "
          f"{ms:.4f} ms with K1 {card}")

    # S=1: the single-robot 10 Hz loop's latency (host clock, synchronized)
    del engine, sc, world
    engine, sc, world, gmm, domain = build_engine(1, dev)
    for _ in range(5):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    torch.cuda.synchronize()
    sk.K1.launches = 0
    lat = []
    for _ in range(LATENCY_TICKS):
        t0 = time.perf_counter()
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        sc = advance(engine, sc, u)
        if bool(diag.diverged.any()) or not bool(torch.isfinite(u).all()):
            fail("S=1 tick diverged or produced non-finite controls")
    if sk.K1.launches != LATENCY_TICKS:
        fail(f"K1 launched {sk.K1.launches} times in {LATENCY_TICKS} S=1 ticks")
    lat_launches = sk.K1.launches
    print(f"S=1 replan latency over {LATENCY_TICKS} ticks: p50 {np.percentile(lat, 50):.4f} ms, "
          f"p99 {np.percentile(lat, 99):.4f} ms (budget 100 ms) {card}")

    # ---- 5. the engine on the card against the engine on the CPU (whose
    # K1 is the plain version), one tick from the same state, S=64
    print("== 5. engine on the card vs engine on the CPU, S=64, one tick", flush=True)
    runs = {}
    for d in (dev, torch.device("cpu")):
        e, s_, w_, g_, dm = build_engine(64, d)
        _, u_, dg = e.replan_refresh(s_, g_, dm, w_)
        runs[d.type] = (u_.cpu(), dg.dwa_active.cpu())
    (u_d, a_d), (u_c, a_c) = runs[dev.type], runs["cpu"]
    same = a_d == a_c
    du = (u_d - u_c).abs()[same].max().item()
    print(f"  max |u_card - u_cpu| {du:.3e} (atol 5e-5) over {int(same.sum())} scenarios; "
          f"DWA choice differs in {int((~same).sum())} (limit {CODE_MISMATCH_LIMIT})")
    if du > 5e-5 or int((~same).sum()) > CODE_MISMATCH_LIMIT:
        fail("the engine on the card disagrees with the engine on the CPU")

    print(json.dumps({"kernels": [{
        "name": sk.K1.name, "route": "cuda",
        "source": "ergodic_exploration_tpu_torch/csrc/solve_kernel.cu",
        "replaces": "ergodic_exploration_tpu/ops/solve_kernel.py:602",
        "launches": launches, "max_abs_err": err, "ms": k1_ms, "plain_ms": plain_ms,
        "s1_launches": lat_launches}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
