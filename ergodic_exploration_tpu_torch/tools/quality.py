"""The config-4 closed-loop quality run on the port (twin of the JAX
package's ``tools/tpu_quality.py``).

One ``Engine.explore_mapping_fused`` run at ``default_config("omni")``,
untouched: S robots start at rejection-sampled poses in a building of two
rooms and a pillar that is hidden from them; each of ``n_refreshes``
refreshes reveals the map with the occlusion-aware ray-cast sensor,
recomputes the MI target (dense path) and the distance field from the
beliefs, and runs ``refresh_every`` ticks of the eager controller step. The
summary holds the two quality curves that throughput numbers do not show:
the fleet's coverage of the hidden map, and the ergodic metric against each
refresh's current target. At the record's configuration (S = 256, 500
refreshes of 10 ticks, sensor range 1.5 m) it also holds the gaps to
``docs/quality_config4.json`` and their verdict.

    python -m ergodic_exploration_tpu_torch.tools.quality [--S 256] [--refreshes 500]
        [--every 10] [--cpu] [--out build/quality_config4_torch.json] [--png PATH]

It runs on the CUDA device, or on the CPU with ``--cpu``. It writes under
``build/`` by default and refuses a path in ``docs/``, whose record it only
reads. The figure (belief and path of the best scenario, coverage and
ergodic metric against the tick) is drawn only when ``--png`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ergodic_exploration_tpu_torch.config import EngineConfig, default_config
from ergodic_exploration_tpu_torch.engine import Engine, ExploreOutput, Scenarios
from ergodic_exploration_tpu_torch.grid import GridMap
from ergodic_exploration_tpu_torch.ops import sensor
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
RECORD = ROOT / "docs" / "quality_config4.json"
DEFAULT_OUT = ROOT / "build" / "quality_config4_torch.json"
CELLS, RES = 100, 0.05  # a 5 m x 5 m building at 0.05 m a cell
SENSOR_RANGE = 1.5
CONFIG_KEYS = ("S", "n_refreshes", "refresh_every", "sensor_range_m")

# compare_to_record's limits. Refresh 1's coverage depends only on the
# spawns and the first ray-cast, which may differ in the last bit of an
# atan2 at a bin edge. Later points are fleet means of closed loops that
# diverge chaotically from the same spawns: with a per-scenario spread of
# about 0.07, the mean of 256 moves by about 0.005-0.007.
FIRST_TOL = 1e-3
COV_TOL = 0.03
P10_SLACK, MEDIAN_SLACK = 0.05, 0.02  # final per-scenario coverage, below the record


def truth_data() -> np.ndarray:
    """The hidden building, (100, 100) float32: outer walls, a long wall
    with a 1.3 m doorway on the right, an upper divider with a 1.6 m doorway
    on the left, and a pillar. The doorways are wider than twice the
    footprint radius plus ``d_safe``, so the barrier leaves them open."""
    data = np.zeros((CELLS, CELLS), np.float32)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 1.0
    data[45:48, 0:64] = 1.0
    data[45:48, 90:100] = 1.0
    data[70:72, 32:100] = 1.0
    data[20:28, 70:78] = 1.0
    return data


def build_truth(S: int, device=None) -> GridMap:
    """The building for S scenarios: a GridMap of (S, 100, 100), origin 0,
    resolution 0.05 m, on ``device`` (the CUDA device unless asked)."""
    dev = resolve_device(device)
    return GridMap(
        data=torch.from_numpy(truth_data()).to(dev).expand(S, CELLS, CELLS).contiguous(),
        origin=torch.zeros((S, 2), dtype=torch.float32, device=dev),
        resolution=torch.full((S,), RES, dtype=torch.float32, device=dev))


def spawn_poses(cfg: EngineConfig, truth: GridMap, S: int, seed: int = 0) -> np.ndarray:
    """(S, 3) float32 start poses, rejection-sampled over the free space of
    scenario 0's map with real clearance: the EDT at the pose's cell must
    exceed ``boundary_radius + d_safe`` (a spawn inside the safety margin
    fails validation with no feasible DWA twist and parks for good). Draw
    for draw the JAX tool's sampler, so one seed gives the same poses."""
    g0 = GridMap(truth.data[0], truth.origin[0], truth.resolution[0])
    edt = DistanceField.from_grid(g0).dist.cpu().numpy()
    need = cfg.boundary_radius + cfg.d_safe
    rng = np.random.default_rng(seed)
    xs = []
    while len(xs) < S:
        p = rng.uniform(0.3, 4.7, 2)
        ij = (int(p[1] / RES), int(p[0] / RES))
        if edt[ij] > need:
            xs.append([p[0], p[1], rng.uniform(-np.pi, np.pi)])
    return np.asarray(xs, np.float32)


def mapping_chunks(engine: Engine, sc: Scenarios, truth: GridMap, n_chunks: int,
                   refresh_every: int = 10,
                   sensor_range: float = SENSOR_RANGE) -> Iterator[tuple[GridMap, ExploreOutput]]:
    """The host-chunked mapping loop, one ``Engine.explore_mapping`` refresh
    (ray-cast reveal, MI target, world, ``refresh_every`` ticks) a chunk.
    Yields (belief, ExploreOutput) after each chunk, so a caller keeps every
    tick's diagnostics."""
    belief = None
    for _ in range(n_chunks):
        out, belief, _ = engine.explore_mapping(sc, truth, refresh_every, sensor_range,
                                                refresh_every, belief=belief)
        sc = out.scenarios
        yield belief, out


# tests/test_quality.py's multi-room run at pure defaults, and its floors
MULTIROOM_X0 = np.asarray([[1.7, 1.1, 0.0], [1.2, 3.0, 1.2], [4.2, 1.0, 2.5], [2.6, 2.9, -1.0]],
                          np.float32)
MULTIROOM_TICKS = 400
FLOOR_SPEED, FLOOR_COVERAGE, FLOOR_RISE = 0.04, 0.25, 0.02  # m/s; share known; second-half gain


def multiroom_floors(engine: Engine, refresh_every: int = 10) -> tuple[float, float, float]:
    """(mean speed, final coverage, second-half coverage rise) of the
    MULTIROOM_X0 robots exploring the building for MULTIROOM_TICKS ticks on
    ``engine``'s device, a refresh every ``refresh_every``. The default omni
    configuration explores when each exceeds its FLOOR_*."""
    truth = build_truth(len(MULTIROOM_X0), engine.device)
    covs, trajs = [], []
    for belief, out in mapping_chunks(engine, engine.init_scenarios(MULTIROOM_X0), truth,
                                      MULTIROOM_TICKS // refresh_every, refresh_every):
        covs.append(sensor.fraction_known(belief))
        trajs.append(out.trajectory)
    covs, traj = torch.stack(covs).tolist(), torch.cat(trajs).cpu().numpy()
    speed = np.linalg.norm(np.diff(traj[..., :2], axis=0), axis=-1) / engine.config.dt
    return float(speed.mean()), covs[-1], covs[-1] - covs[len(covs) // 2]


class QualityRun(NamedTuple):
    x0: np.ndarray  # (S, 3) spawns
    scenarios: Scenarios  # the state the run reached
    belief: GridMap  # (S, 100, 100) beliefs after the last reveal
    coverage: torch.Tensor  # (R,) fleet fraction known after each refresh's reveal
    trajectory: torch.Tensor  # (R, E, S, 3)
    metric: torch.Tensor  # (R, E, S) against each refresh's current target
    wall_s: float  # the loop alone, synchronised


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(S: int = 256, n_refreshes: int = 500, refresh_every: int = 10,
        sensor_range: float = SENSOR_RANGE, seed: int = 0, device=None) -> QualityRun:
    """The quality run: pure omni defaults (no cart v ~ 0 stall, so what is
    reached reflects the map, not the model), ``spawn_poses`` of ``seed``,
    then ``explore_mapping_fused`` on the hidden building."""
    dev = resolve_device(device)
    cfg = default_config("omni")
    engine = Engine(cfg, device=dev)
    truth = build_truth(S, dev)
    x0 = spawn_poses(cfg, truth, S, seed)
    sc = engine.init_scenarios(x0)
    _sync(dev)
    t0 = time.perf_counter()
    sc, belief, cov, traj, metric = engine.explore_mapping_fused(
        sc, truth, n_refreshes=n_refreshes, refresh_every=refresh_every,
        sensor_range=sensor_range)
    _sync(dev)
    return QualityRun(x0, sc, belief, cov, traj, metric, time.perf_counter() - t0)


def summarize(coverage: np.ndarray, belief: np.ndarray, metric: np.ndarray,
              sensor_range: float, wall_s: float) -> dict:
    """The JAX tool's summary, field for field, from numpy arrays: coverage
    (R,), final belief data (S, h, w), metric (R, E, S). ``wall_s`` is the
    loop's time (nothing is compiled here but the kernels, once)."""
    R, E, S = metric.shape
    cov_curve = np.asarray(coverage).reshape(R, -1).mean(axis=1)
    cov_s = (belief != -1.0).reshape(S, -1).mean(axis=1)
    em_mean = metric.mean(axis=2)
    em_curve = em_mean.reshape(-1)
    ticks = np.arange(1, R + 1) * E
    step = max(1, R // 8)
    return {
        "S": S,
        "n_refreshes": R,
        "refresh_every": E,
        "sensor_range_m": sensor_range,
        "final_coverage": float(cov_curve[-1]),
        "final_coverage_per_scenario": {
            "p10": float(np.percentile(cov_s, 10)),
            "median": float(np.median(cov_s)),
            "p90": float(np.percentile(cov_s, 90)),
            "best": float(cov_s.max()),
        },
        "coverage_at": {str(int(t)): float(c) for t, c in zip(ticks[::step], cov_curve[::step])},
        "ergodic_metric_first_tick": float(em_curve[0]),
        "ergodic_metric_last_tick": float(em_curve[-1]),
        "ergodic_metric_last_refresh_mean": float(em_mean[-1].mean()),
        "coverage_curve": [round(float(c), 4) for c in cov_curve],
        "em_curve_per_refresh": [round(float(m), 6) for m in em_mean.mean(axis=1)],
        "wall_s": round(wall_s, 1),
    }


def compare_to_record(summary: dict, record: dict) -> dict:
    """Gaps of ``summary`` to a ``record`` of the same configuration and the
    verdict: refresh 1's coverage within FIRST_TOL, each later
    ``coverage_at`` point within COV_TOL, the final per-scenario p10 and
    median no lower than the record's by more than P10_SLACK and
    MEDIAN_SLACK. Returns {"coverage_at": [[tick, port, record, gap], ...],
    "p10" / "median": [port, record, gap], "failures": [...], "ok": bool}."""
    if any(summary[k] != record[k] for k in CONFIG_KEYS):
        raise ValueError("the summary and the record differ in configuration: "
                         f"{[(k, summary[k], record[k]) for k in CONFIG_KEYS]}")
    out, failures = {"coverage_at": []}, []
    for i, (tick, ref) in enumerate(record["coverage_at"].items()):
        got = summary["coverage_at"][tick]
        tol = FIRST_TOL if i == 0 else COV_TOL
        out["coverage_at"].append([int(tick), got, ref, got - ref])
        if not abs(got - ref) <= tol:
            failures.append(f"coverage at tick {tick}: {got:.5f} against the record's "
                            f"{ref:.5f} (limit {tol})")
    for q, slack in (("p10", P10_SLACK), ("median", MEDIAN_SLACK)):
        got = summary["final_coverage_per_scenario"][q]
        ref = record["final_coverage_per_scenario"][q]
        out[q] = [got, ref, got - ref]
        if not got >= ref - slack:
            failures.append(f"final per-scenario {q}: {got:.5f} under the record's {ref:.5f} "
                            f"less {slack}")
    out["failures"] = failures
    out["ok"] = not failures
    return out


def save_figure(path: Path, r: QualityRun, summary: dict) -> None:
    """Three panels: the best scenario's final belief and path, the fleet's
    coverage against the tick, the fleet-mean ergodic metric against the
    tick."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    belief = r.belief.data.cpu().numpy()
    traj, metric = r.trajectory.cpu().numpy(), r.metric.cpu().numpy()
    R, E, S = metric.shape
    cov_s = (belief != -1.0).reshape(S, -1).mean(axis=1)
    best = int(np.argmax(cov_s))
    cov_curve = np.asarray(summary["coverage_curve"])
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    b = belief[best]
    axes[0].imshow(np.where(b < 0.0, 0.5, b), origin="lower", extent=[0, 5, 0, 5],
                   cmap="gray_r", vmin=0, vmax=1)
    path_xy = traj[:, :, best, :].reshape(-1, 3)
    axes[0].plot(path_xy[:, 0], path_xy[:, 1], "-", color="tab:orange", lw=0.8)
    axes[0].plot(path_xy[-1, 0], path_xy[-1, 1], "o", color="tab:orange", ms=5)
    axes[0].set_title(f"best scenario ({cov_s[best]:.0%}) belief after {R * E} ticks\n"
                      f"(grey = still unknown; fleet median {np.median(cov_s):.0%})")
    axes[0].set_aspect("equal")
    axes[1].plot(np.arange(1, R + 1) * E, cov_curve, "o-", ms=3)
    axes[1].set(xlabel="tick", ylabel="fraction of map known", ylim=(0, 1),
                title=f"coverage vs tick (mean over S={S})\nfinal {cov_curve[-1]:.1%}")
    axes[1].grid(alpha=0.3)
    axes[2].plot(np.arange(1, R * E + 1), metric.mean(axis=2).reshape(-1), lw=1.0)
    axes[2].set(xlabel="tick", ylabel="ergodic metric (vs current MI target)", yscale="log",
                title="ergodic metric vs tick\n(sawtooth = target refresh)")
    axes[2].grid(alpha=0.3)
    fig.tight_layout()
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The config-4 closed-loop quality run.")
    ap.add_argument("--S", type=int, default=256, help="scenarios")
    ap.add_argument("--refreshes", type=int, default=500, help="map refreshes")
    ap.add_argument("--every", type=int, default=10, help="ticks per refresh")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the summary's JSON file")
    ap.add_argument("--png", default=None, help="draw the figure to this file")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    png = Path(args.png).resolve() if args.png else None
    for p in (out, png):
        if p is not None and (ROOT / "docs") in p.parents:
            ap.error(f"{p} is in docs/, whose record is only read")

    dev = resolve_device("cpu" if args.cpu else None)
    r = run(args.S, args.refreshes, args.every, SENSOR_RANGE, device=dev)
    summary = summarize(r.coverage.cpu().numpy(), r.belief.data.cpu().numpy(),
                        r.metric.cpu().numpy(), SENSOR_RANGE, r.wall_s)
    summary["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    record = json.loads(RECORD.read_text())
    if all(summary[k] == record[k] for k in CONFIG_KEYS):
        summary["vs_record"] = compare_to_record(summary, record)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    if png is not None:
        save_figure(png, r, summary)
    print(json.dumps({k: v for k, v in summary.items() if not isinstance(v, list)}))
    return 0 if summary.get("vs_record", {"ok": True})["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
