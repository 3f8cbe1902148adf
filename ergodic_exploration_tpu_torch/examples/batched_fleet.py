"""Batched-fleet demo on the PyTorch port: BASELINE config 5 at a demo scale
(twin of ``examples/batched_fleet.py``).

Runs S scenarios (per-scenario maps, poses, GMM targets) closed loop on the
device, prints throughput and metrics, and renders scenario 0:

    python -m ergodic_exploration_tpu_torch.examples.batched_fleet \\
        [--scenarios 256] [--ticks 150] [--cpu] [--out build/batched_fleet_torch.png]
    torchrun --nproc-per-node=N -m ergodic_exploration_tpu_torch.examples.batched_fleet --mesh

It runs on the CUDA device, or on the CPU with ``--cpu``. With ``--mesh``
(under ``torchrun``) each rank joins the process group and explores its
slice of the scenarios on the ``global_scenario_mesh()``; rank 0 prints and
writes the figure.
"""

import argparse
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "batched_fleet_torch.png"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over every rank (launch with torchrun)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.utils.metrics import summarize
    from ergodic_exploration_tpu_torch.viz import save_exploration_figure

    device = "cpu" if args.cpu else None
    mesh, rank = None, 0
    if args.mesh:
        import torch.distributed as dist

        from ergodic_exploration_tpu_torch.parallel import (
            global_scenario_mesh, initialize_multihost)

        initialize_multihost(device=device)
        mesh, rank = global_scenario_mesh(), dist.get_rank()
    S = args.scenarios
    rng = np.random.default_rng(0)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    engine = Engine(default_config("cart").replace(ergodic_weight=50.0), device=device, mesh=mesh)

    # per-scenario worlds: random wall segments (every rank makes the same
    # global batch; the constructors keep each rank's rows)
    data = np.zeros((S, 100, 100), dtype=np.float32)
    for i in range(S):
        r = 20 + int(60 * rng.random())
        c = int(50 * rng.random())
        data[i, r:r + 4, c:c + 40] = 1.0
    grids = GridMap(data, np.zeros((S, 2), np.float32), np.full((S,), 0.05, np.float32))
    gmm = GaussianMixture(
        means=rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32))
    x0 = np.concatenate([rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)

    sc = engine.init_scenarios(x0)
    phik = engine.phik_from_gmm(gmm, domain)
    world = engine.prepare_world(grids)

    t0 = time.perf_counter()
    out = engine.explore(sc, phik, world, args.ticks)
    diag = out.diag
    if mesh is not None:  # every rank's scenarios, (T, S) leaves
        from ergodic_exploration_tpu_torch.parallel import process_allgather

        diag = type(diag)(*(t.T for t in process_allgather(
            type(diag)(*(t.T.contiguous() for t in diag)), mesh)))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0

    if rank == 0:
        rec = summarize(diag, elapsed_s=dt)
        print(f"{S} scenarios x {args.ticks} ticks in {dt:.1f}s "
              f"= {rec['solves_per_s']:.0f} solves/s")
        print({k: round(v, 4) for k, v in rec.items() if isinstance(v, float)})
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_exploration_figure(
            str(out_path), domain, out, scenario=0,
            grid=GridMap(torch.from_numpy(data[0]), torch.zeros(2), torch.tensor(0.05)),
            gmm=GaussianMixture(*(torch.from_numpy(a[0]) for a in gmm)))
        print(f"wrote {out_path}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
