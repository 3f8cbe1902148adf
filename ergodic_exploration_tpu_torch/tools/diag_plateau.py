"""Diagnosis of the config-4 exploration plateau on the port (twin of the
JAX package's ``tools/diag_plateau.py``).

Runs the quality run's building at small S as a host-chunked loop (ray-cast
reveal -> MI target -> world -> ``explore``) that keeps every tick's
diagnostics, then reports where the robots spend their time relative to the
doorways, how often DWA and validation fire, how often a solve diverged,
and how close each robot ever came to a doorway.

    python -m ergodic_exploration_tpu_torch.tools.diag_plateau [S] [n_ticks] [tag]
        [key=value ...] [--cpu]

``key=value`` pairs override ``default_config("omni")`` (an int, else a
float, else true / false, else a string). It writes
``build/diag_plateau<tag>.npz`` and prints the report as JSON. It runs on
the CUDA device, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ergodic_exploration_tpu_torch.tools.quality import (ROOT, SENSOR_RANGE, build_truth,
                                                         mapping_chunks, spawn_poses)

# the centres of the two doorways of quality.truth_data, (x, y) in m
DOORS = np.array([[(64 + 90) / 2 * 0.05, 46.5 * 0.05],  # the long wall's, on the right
                  [16 * 0.05, 71.0 * 0.05]])  # the upper divider's, on the left


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def room_of(p: np.ndarray) -> np.ndarray:
    """Room of poses (..., >= 2): 0 the lower room (y < 2.25), 1 the band
    above the long wall (y < 3.5), 2 the top rooms."""
    y = p[..., 1]
    return np.where(y < 2.25, 0, np.where(y < 3.5, 1, 2))


def diagnose(traj, dwa, code, div, em, belief, cfg) -> dict:
    """The report, from numpy arrays of one run: poses ``traj`` (T, S, 3),
    ``dwa`` active, collision ``code``, ``div`` (diverged) and ergodic
    metric ``em``, each (T, S), the final ``belief`` data (S, h, w), and
    the configuration (its ``dt``)."""
    T, S = traj.shape[:2]
    cov_s = (belief != -1.0).reshape(S, -1).mean(axis=1)
    rooms = room_of(traj)
    crossed = (rooms != rooms[0][None, :]).any(axis=0)  # ever left the start room
    speed = np.linalg.norm(np.diff(traj[..., :2], axis=0), axis=-1) / cfg.dt
    min_door = np.linalg.norm(traj[:, :, None, :2] - DOORS[None, None], axis=-1).min(axis=2)
    return {
        "S": S, "n_ticks": T,
        "final_coverage_mean": float(cov_s.mean()),
        "cov_per_scenario": [round(float(v), 3) for v in cov_s],
        "crossed_rooms_frac": float(crossed.mean()),
        "room_time_frac": [float((rooms == r).mean()) for r in (0, 1, 2)],
        "mean_speed": float(speed.mean()),
        "p90_speed": float(np.percentile(speed, 90)),
        "dwa_active_rate": float(dwa.mean()),
        "code_rate": {str(k): float((code == k).mean()) for k in (0, 1, 2)},
        "diverged_rate": float(div.mean()),
        "em_first": float(em[0].mean()), "em_last": float(em[-1].mean()),
        "min_door_dist_ever": [round(float(v), 3) for v in min_door.min(axis=0)],
    }


def main(S=16, n_ticks=1500, refresh_every=10, sensor_range=SENSOR_RANGE, seed=0, tag="",
         device=None, **overrides) -> dict:
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    overrides.setdefault("ergodic_weight", 200.0)
    cfg = default_config("omni").replace(**overrides)
    engine = Engine(cfg, device=dev)
    truth = build_truth(S, dev)
    x0 = spawn_poses(cfg, truth, S, seed)

    keep = {k: [] for k in ("traj", "dwa", "code", "div", "em")}
    n_chunks = n_ticks // refresh_every
    t0 = time.time()
    for c, (belief, out) in enumerate(mapping_chunks(engine, engine.init_scenarios(x0), truth,
                                                     n_chunks, refresh_every, sensor_range)):
        for k, leaf in (("traj", out.trajectory), ("dwa", out.diag.dwa_active),
                        ("code", out.diag.collision_code), ("div", out.diag.diverged),
                        ("em", out.diag.ergodic_metric)):
            keep[k].append(leaf.cpu().numpy())
        if (c + 1) % 25 == 0:
            log(f"chunk {c + 1}/{n_chunks} coverage {float(sensor.fraction_known(belief)):.3f} "
                f"({time.time() - t0:.0f}s)")
    arrays = {k: np.concatenate(v) for k, v in keep.items()}
    bdata = belief.data.cpu().numpy()
    report = diagnose(**arrays, belief=bdata, cfg=cfg)
    report["wall_s"] = round(time.time() - t0, 1)
    report["device"] = str(dev)
    report["overrides"] = {k: str(v) for k, v in overrides.items()}
    print(json.dumps(report, indent=1))

    path = ROOT / "build" / f"diag_plateau{tag}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, traj=arrays["traj"], dwa=arrays["dwa"], code=arrays["code"],
             em=arrays["em"], belief=bdata,
             cov_s=(bdata != -1.0).reshape(S, -1).mean(axis=1), x0=x0)
    log(f"saved {path}")
    return report


def parse_argv(argv: list) -> tuple[tuple, dict]:
    """(positional arguments, keyword arguments) of ``main`` from the
    command line: ``[S] [n_ticks] [tag] [key=value ...] [--cpu]``."""
    kw = {"device": "cpu"} if "--cpu" in argv else {}
    argv = [a for a in argv if a != "--cpu"]
    S = int(argv[0]) if len(argv) > 0 else 16
    T = int(argv[1]) if len(argv) > 1 else 1500
    kw["tag"] = argv[2] if len(argv) > 2 else ""
    for a in argv[3:]:
        k, v = a.split("=", 1)
        for cast in (int, float):
            try:
                kw[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            low = v.strip().lower()
            kw[k] = (low == "true") if low in ("true", "false") else v
    return (S, T), kw


if __name__ == "__main__":
    args, kwargs = parse_argv(sys.argv[1:])
    main(*args, **kwargs)
