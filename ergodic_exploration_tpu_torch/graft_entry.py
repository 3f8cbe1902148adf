"""Entry points of the port: the batched replan and the multi-device dry run
(twin of the JAX package's ``__graft_entry__.py``).

``entry()`` returns the batched replan step on the flagship configuration
(cart, K = 10, H = 20: BASELINE config 1 batched) and its example inputs.
``dryrun_multichip(n)`` runs the FLAGSHIP problem sharded over an n-rank
scenario mesh: the bench configuration (K = 10, H = 20, the 10k-sample target
refresh inside K1, shared maps, the shared history draw) on a real obstacle
map (EDT, barrier, validation and DWA), one ``replan_refresh`` tick, a 2-tick
``explore`` and one config-4 ``replan_refresh_mi`` tick, with the shape,
finiteness, divergence and fallback-rate checks of the JAX dry run. With an
even n >= 2 it adds the 2-D leg the JAX dry run lacks: ``make_mesh(n // 2, 2)``
with the sample-sharded GMM and MI targets and one ``replan_refresh`` tick.

    python -m ergodic_exploration_tpu_torch.graft_entry [--devices N] [--cpu]
"""

from __future__ import annotations

import numpy as np

DRYRUN_TIMEOUT_S = 600  # the spawned ranks together


def _example(S: int):
    """Start poses and two-mode GMM targets of S scenarios, numpy, seed 0."""
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    gmm = GaussianMixture(
        means=np.tile(np.array([[1.5, 1.5], [3.5, 3.5]], np.float32)[None], (S, 1, 1)),
        covs=np.tile((0.4 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32))
    return x0, gmm


def entry(device=None):
    """(fn, example_args): the batched replan on the flagship configuration,
    ``fn(sc, phik, world) -> (u, ergodic metric)``, on the card (or on
    ``device``)."""
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain

    S = 8
    engine = Engine(default_config("cart"), device=device)  # K=10, H=20, safety + DWA on
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    x0, gmm = _example(S)
    sc = engine.init_scenarios(x0)
    phik = engine.phik_from_gmm(gmm, domain)
    world = engine.empty_world(domain, S)

    def fn(sc, phik, world):
        _, u, diag = engine._replan_fn(sc, phik, world)
        return u, diag.ergodic_metric

    return fn, (sc, phik, world)


def _grids(data: np.ndarray, S: int):
    from ergodic_exploration_tpu_torch.grid import GridMap

    return GridMap(np.repeat(data[None], S, axis=0), np.zeros((S, 2), np.float32),
                   np.full((S,), 0.05, np.float32))


def _check_tick(u, diag, S_local: int, nu: int, mesh, what: str) -> None:
    import torch

    from ergodic_exploration_tpu_torch.parallel import process_allgather

    if u.shape != (S_local, nu) or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"{what}: controls {tuple(u.shape)} not ({S_local}, {nu}) or "
                             "not finite")
    if bool(diag.diverged.any()):
        raise AssertionError(f"{what}: divergence guard tripped")
    if process_allgather(u, mesh).shape[0] != S_local * mesh.size(0):
        raise AssertionError(f"{what}: the gathered controls miss scenarios")


def _dryrun(n: int, devices: str) -> None:
    """The dry run on this rank of an n-rank process group."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine, make_mesh, make_scenario_mesh
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.parallel import process_allgather, process_scenario_slice

    mesh = make_scenario_mesh(n, devices=devices)
    S = 2 * n  # a small batch; the PROBLEM is full size (bench.py's case)
    cfg = default_config("cart").replace(use_fused_solve=True, shared_maps=True,
                                         shared_history_draw=True)
    if (cfg.num_basis, cfg.horizon, tuple(cfg.grid_samples)) != (10, 20, (100, 100)):
        raise AssertionError("the flagship configuration changed")
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    engine = Engine(cfg, mesh=mesh)
    x0, gmm = _example(S)
    lo, hi = process_scenario_slice(S, mesh)
    S_local = hi - lo
    if S_local * n != S:
        raise AssertionError(f"each rank must hold {S // n} rows, this one holds {S_local}")

    # the bench obstacle map (a wall and a pillar), shared by the scenarios
    data = np.zeros((100, 100), dtype=np.float32)
    data[45:50, 20:80] = 1.0
    data[70:78, 60:68] = 1.0
    grids = _grids(data, S)
    world = engine.prepare_world(grids)
    sc = engine.init_scenarios(x0)
    phik = engine.phik_from_gmm(gmm, domain, world)
    # the feeding path in which each rank makes only its own rows
    phik_fed = engine.shard_scenarios_from_local(phik.cpu().numpy())
    if phik_fed.shape != phik.shape or phik.shape[0] != S_local:
        raise AssertionError(f"fed target {tuple(phik_fed.shape)} vs {tuple(phik.shape)}")

    # the one-kernel tick (GMM refresh inside K1) on this rank's slice
    gmm_local = engine.shard_scenarios(gmm)
    sc_r, u_r, diag_r = engine.replan_refresh(sc, gmm_local, domain, world)
    _check_tick(u_r, diag_r, S_local, cfg.nu, mesh, "replan_refresh")

    # closed-loop explore on the mesh against the real EDT world
    out = engine.explore(sc_r, phik_fed, world, n_ticks=2)
    if out.trajectory.shape != (2, S_local, 3):
        raise AssertionError(f"trajectory {tuple(out.trajectory.shape)}")
    if not (bool(torch.isfinite(out.trajectory).all())
            and bool(torch.isfinite(out.controls).all())):
        raise AssertionError("explore produced non-finite poses or controls")
    if bool(out.diag.diverged.any()):
        raise AssertionError("divergence guard tripped")
    active = process_allgather(out.diag.dwa_active.T.contiguous(), mesh)  # (S, 2)
    dwa_rate = float(active.float().mean())
    if dwa_rate > 0.5:
        raise AssertionError(f"DWA fallback rate {dwa_rate:.2f} > 0.5")
    # a scenario that fell back from a start with real clearance must have
    # found a feasible DWA control (a start inside the pillar may not)
    d0 = world.dist.dist[0].cpu().numpy()
    cells = np.clip((x0[lo:hi, :2] / 0.05 - 0.5).round().astype(int), 0, 99)
    clear = torch.as_tensor(d0[cells[:, 1], cells[:, 0]] > cfg.boundary_radius + 0.1,
                            device=engine.device)
    if bool((out.diag.dwa_active & clear[None, :] & ~out.diag.dwa_feasible).any()):
        raise AssertionError("infeasible DWA fallback from a clear start")

    # one config-4 tick: the MI target from an evolving belief (dense path)
    belief = np.full((100, 100), -1.0, dtype=np.float32)
    belief[:, :55] = 0.0
    belief[45:50, 20:55] = 1.0
    bgrids = _grids(belief, S)
    bworld = engine.prepare_world(bgrids)
    _, u_mi, diag_mi = engine.replan_refresh_mi(out.scenarios, engine.shard_scenarios(bgrids),
                                                bworld, sensor_radius_cells=3, domain=domain)
    _check_tick(u_mi, diag_mi, S_local, cfg.nu, mesh, "replan_refresh_mi")

    if n < 2 or n % 2:
        return
    # the 2-D leg: scenarios over n / 2 ranks, the lattice over 2
    mesh2 = make_mesh(n // 2, 2, devices=devices)
    eng2 = Engine(cfg, mesh=mesh2)
    lo2, hi2 = process_scenario_slice(S, mesh2)
    world2 = eng2.prepare_world(grids)
    K = cfg.num_basis
    for what, ph in (("sample-sharded GMM target", eng2.phik_from_gmm(gmm, domain, world2)),
                     ("sample-sharded MI target", eng2.phik_from_grid(bgrids, 3))):
        if ph.shape != (hi2 - lo2, K, K) or not bool(torch.isfinite(ph).all()):
            raise AssertionError(f"{what}: {tuple(ph.shape)} or not finite")
    _, u2, diag2 = eng2.replan_refresh(eng2.init_scenarios(x0), eng2.shard_scenarios(gmm),
                                       domain, world2)
    _check_tick(u2, diag2, hi2 - lo2, cfg.nu, mesh2, "replan_refresh on the 2-D mesh")


def _rank_main(rank: int, n: int, store: str, device: str, backend: str) -> None:
    import torch.distributed as dist

    import os

    import torch

    from ergodic_exploration_tpu_torch.parallel import initialize_multihost

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_multihost(f"file://{store}", n, rank, device=device, backend=backend)
    try:
        _dryrun(n, device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The flagship problem sharded over an ``n_devices``-rank mesh, on the
    card (or on ``device``). Runs in place when a process group of
    ``n_devices`` ranks exists (every rank calls it); otherwise spawns the
    ranks itself, joined through a file store in a temporary directory: over
    NCCL when the host has ``n_devices`` cards, else over gloo with the ranks
    sharing the cards (or on the CPU with ``device="cpu"``). Raises when a
    rank fails."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from ergodic_exploration_tpu_torch.utils.device import resolve_device

    dev_type = resolve_device(device).type
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"need {n_devices} devices, have {dist.get_world_size()}")
        _dryrun(n_devices, dev_type)
        return
    on_card = dev_type == "cuda"
    backend = "nccl" if on_card and torch.cuda.device_count() >= n_devices else "gloo"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, os.path.join(tmp, "store"),
                                                      dev_type, backend))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DRYRUN_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"dry run over {n_devices} ranks ({backend}) failed: exit codes "
                           f"{codes}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, ex = entry(device)
    u, metric = fn(*ex)
    print("entry:", tuple(u.shape), tuple(metric.shape))
    dryrun_multichip(args.devices, device)
    print("dryrun_multichip: ok")


if __name__ == "__main__":
    main()
