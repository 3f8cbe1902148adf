"""Single-robot exploration demo on the PyTorch port: the reference's cart
launch without ROS (twin of ``examples/single_robot.py``).

A robot explores a walled 5 x 5 m world with the mutual-information target:
the "SLAM map" is revealed by a disc sensor around the robot every 10 ticks
(``ops.sensor.reveal``), the node replans every tick, and the run is
rendered to a PNG.

    python -m ergodic_exploration_tpu_torch.examples.single_robot \\
        [--model cart|omni] [--steps 400] [--cpu] [--out build/single_robot_torch.png]

It runs on the CUDA device, or on the CPU with ``--cpu``.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "single_robot_torch.png"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="cart", choices=["cart", "omni"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.node import ExplorationNode
    from ergodic_exploration_tpu_torch.ops.integrator import constant_twist_poses
    from ergodic_exploration_tpu_torch.ops.sensor import reveal
    from ergodic_exploration_tpu_torch.utils.device import resolve_device
    from ergodic_exploration_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device("cpu" if args.cpu else None)
    # ground truth: 5 x 5 m, a wall with a gap and a pillar
    truth_np = np.zeros((100, 100), dtype=np.float32)
    truth_np[48:52, 10:60] = 1.0
    truth_np[48:52, 75:95] = 1.0
    truth_np[20:28, 70:78] = 1.0
    truth = GridMap.create(truth_np, 0.0, 0.0, 0.05, device=dev)
    belief = truth._replace(data=torch.full_like(truth.data, -1.0))

    cfg = default_config(args.model).replace(ergodic_weight=50.0)
    node = ExplorationNode(cfg, target="mi", device=dev)
    pose = torch.tensor([1.0, 1.0, 0.3], device=dev)
    node.on_odom(pose)
    log = MetricsLogger()
    traj = [pose.cpu().numpy()]
    dt = torch.tensor([cfg.dt], device=dev)
    for t in range(args.steps):
        if t % 10 == 0:  # ~1 Hz map updates against the 10 Hz control loop
            belief = reveal(belief, truth, pose, 1.2)
            node.on_map(belief.data, 0.0, 0.0, 0.05)
        tw, diag = node.step()
        pose = constant_twist_poses(pose, torch.as_tensor(tw, device=dev), dt)[0]
        node.on_odom(pose, tw)
        traj.append(pose.cpu().numpy())
        if t % 50 == 0:
            rec = log.log(diag)
            known = float((belief.data >= 0).float().mean())
            print(f"t={t:4d} pose=({traj[-1][0]:.2f},{traj[-1][1]:.2f}) "
                  f"E={rec['ergodic_metric_mean']:.4f} map_known={known:.0%} "
                  f"dwa={rec['dwa_fallback_rate']:.0%}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ergodic_exploration_tpu_torch.viz import render_scenario

    fig, ax = plt.subplots(figsize=(6, 6))
    render_scenario(ax, node.domain, grid=belief, trajectory=np.stack(traj),
                    predicted=node.predicted_path(), title="MI exploration")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
