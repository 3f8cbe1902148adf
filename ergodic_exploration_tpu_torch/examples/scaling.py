"""Scaling harness of the PyTorch port: solves/s of the bench tick over a
sweep of batches, on one device or sharded over ranks (twin of
``examples/scaling.py``). Prints one JSON line per point:

    python -m ergodic_exploration_tpu_torch.examples.scaling --batches 512,1024,2048,4096
    torchrun --nproc-per-node=N -m ergodic_exploration_tpu_torch.examples.scaling --multihost

``--multihost`` joins the process group (``parallel.initialize_multihost``:
``env://`` under torchrun, or one copy per rank with the same
``--coordinator host:port``, ``--nproc`` and its own ``--pid``) and shards
each batch over the scenario mesh of every rank. On the card the tick is the
bench configuration (K1 with the refresh inside); on the CPU (``--cpu``) it
is the plain configuration, as the JAX script runs it off the TPU.

Efficiency is solves/s over the first point's: the scenario dim has no
communication, so anything below ~1.0 is launch and dispatch overhead.
"""

import argparse
import json
import os
import time

import numpy as np


def run_point(S, mesh, iters=20, device=None):
    """Solves/s of ``replan_refresh`` at a global batch of S scenarios."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.utils.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    rng = np.random.default_rng(0)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    engine = Engine(default_config("cart").replace(
        use_pallas=on_card, use_fused_solve=on_card, shared_history_draw=on_card,
        shared_maps=on_card), device=device, mesh=mesh)
    data = np.zeros((100, 100), dtype=np.float32)
    data[45:50, 20:80] = 1.0
    grids = GridMap(np.repeat(data[None], S, axis=0), np.zeros((S, 2), np.float32),
                    np.full((S,), 0.05, np.float32))
    gmm = GaussianMixture(
        means=rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32))
    x0 = np.concatenate([rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    sc = engine.init_scenarios(x0)
    world = engine.prepare_world(grids)
    gmm = engine.shard_scenarios(gmm)  # this rank's rows (unchanged without a mesh)

    def done():
        if on_card:
            torch.cuda.synchronize(engine.device)
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    sc, u, d = engine.replan_refresh(sc, gmm, domain, world)
    done()
    t0 = time.perf_counter()
    for _ in range(iters):
        sc, u, d = engine.replan_refresh(sc, gmm, domain, world)
    done()
    return S * iters / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="512,1024,2048,4096")
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    # explicit multi-process launch (without torchrun): one copy of this
    # script per rank with the same --coordinator / --nproc and its --pid
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    n_dev, hosts, rank, mesh = 1, 1, 0, None
    if args.multihost:
        import torch.distributed as dist

        from ergodic_exploration_tpu_torch.engine import make_scenario_mesh
        from ergodic_exploration_tpu_torch.parallel import initialize_multihost

        initialize_multihost(coordinator_address=args.coordinator, num_processes=args.nproc,
                             process_id=args.pid, device=device)
        n_dev, rank = dist.get_world_size(), dist.get_rank()
        hosts = n_dev // int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        mesh = make_scenario_mesh() if n_dev > 1 else None
    base = None
    for S in [int(s) for s in args.batches.split(",")]:
        sps = run_point(S, mesh, iters=args.iters, device=device)
        if base is None:
            base = sps
        if rank == 0:
            print(json.dumps({
                "batch": S,
                "devices": n_dev,
                "hosts": hosts,
                "solves_per_s": round(sps, 1),
                "efficiency_vs_first_point": round(sps / base, 3),
            }), flush=True)
    if args.multihost:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
