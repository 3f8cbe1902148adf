"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py).

Each process runs this script with its rank; together they form a gloo
process group on the CPU, joined through a file store (no ports). Two runs:

- ``tier1`` (4 ranks): the scenario mesh (4,) with the one-kernel
  ``replan_refresh`` tick and ``explore``, a collective checkpoint and its
  reload, the (2, 2) mesh with the sample-sharded GMM and MI targets and
  ticks, ``process_scenario_slice`` and the ``make_mesh`` refusals;
- ``twin`` (2 ranks): the twin of tests/multihost_worker.py, in which each
  rank feeds only its own scenarios, explores 10 ticks, checkpoints and
  resumes.

Rank 0 writes what its scenario group gathered to ``<out>/<run>.npz``; every
rank writes its own records to ``<out>/<run>_rank<r>.npz``. The script
imports no JAX: the parent test computes the JAX side.

Usage: python torch_parallel_worker.py <run> <rank> <world> <out_dir>
"""

import os
import sys

# a bare subprocess: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

S = 8
TICKS_A = 3  # one-kernel ticks on the scenario mesh
TICKS_EXPLORE, TICKS_RESUME = 5, 3


def tier1_case():
    """The cases of the tier-1 run, numpy, made from seeds (the parent test
    builds the same ones for the JAX side)."""
    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.uniform(0.3, 1.7, (S, 2)), rng.uniform(-3, 3, (S, 1))],
                        axis=1).astype(np.float32)
    gmm = (rng.uniform(0.4, 1.6, (S, 2, 2)).astype(np.float32),
           np.tile((0.1 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
           np.ones((S, 2), np.float32))
    wall = np.zeros((S, 20, 20), np.float32)
    wall[:, 9:11, 4:16] = 1.0
    walls = np.zeros((S, 20, 20), np.float32)  # a wall at a per-scenario row
    for s in range(S):
        walls[s, 3 + 2 * s:5 + 2 * s, 4:16] = 1.0
    # free space only in the top-right quadrant, the last scenario fully
    # occupied; a GMM far from the free space with a tiny covariance: the
    # masked phi is 0 everywhere (test_engine.py's degenerate case)
    degen = np.ones((S, 20, 20), np.float32)
    degen[:-1, 12:, 12:] = 0.0
    gmm_far = (np.tile(np.array([[0.2, 0.2]], np.float32), (S, 1, 1)),
               np.tile((1e-4 * np.eye(2, dtype=np.float32))[None, None], (S, 1, 1, 1)),
               np.ones((S, 1), np.float32))
    beliefs = np.full((S, 40, 40), -1.0, np.float32)
    for s in range(S):  # a known region that grows with s, an obstacle in it
        beliefs[s, :, :12 + 2 * s] = 0.0
        beliefs[s, 10:14, 5:15] = 1.0
    beliefs[-1] = 1.0  # fully occupied: no information anywhere, the uniform fallback
    return dict(x0=x0, gmm=gmm, wall=wall, walls=walls, degen=degen, gmm_far=gmm_far,
                beliefs=beliefs)


def small_config(**kw):
    from ergodic_exploration_tpu_torch.config import default_config

    return default_config("cart").replace(num_basis=5, horizon=6, buffer_capacity=16,
                                          grid_samples=(16, 16), **kw)


FUSED = dict(use_fused_solve=True, shared_maps=True, shared_history_draw=True)


def _grids(data, res):
    from ergodic_exploration_tpu_torch.grid import GridMap

    n = data.shape[0]
    return GridMap(data, np.zeros((n, 2), np.float32), np.full((n,), res, np.float32))


def _gather_t(tree, mesh):
    """(T, S_local, ...) leaves gathered along the scenario axis (1)."""
    from ergodic_exploration_tpu_torch.parallel import map_tree, process_allgather

    moved = map_tree(lambda t: t.transpose(0, 1).contiguous(), tree)
    return map_tree(lambda t: t.transpose(0, 1), process_allgather(moved, mesh))


def _np(t):
    return t.detach().cpu().numpy()


def tier1(rank, world, out_dir):
    import torch
    import torch.distributed as dist

    from ergodic_exploration_tpu_torch.engine import Engine, make_mesh, make_scenario_mesh
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops.integrator import rollout
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.parallel import process_allgather, process_scenario_slice

    case = tier1_case()
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    gmm = GaussianMixture(*case["gmm"])
    mine, gathered = {}, {}

    # ---- scenario mesh (4,): the one-kernel tick, 3 ticks with the pose advanced
    mesh = make_scenario_mesh()
    eng = Engine(small_config(**FUSED), mesh=mesh)
    sc = eng.init_scenarios(case["x0"])
    world = eng.prepare_world(_grids(np.repeat(case["wall"][:1], S, 0), 0.1))
    gmm_l = eng.shard_scenarios(gmm)
    for t in range(TICKS_A):
        sc, u, dg = eng.replan_refresh(sc, gmm_l, dom, world)
        g = process_allgather((u, dg, sc.state.U), mesh)
        for name, v in (("u", g[0]), ("U", g[2]), *zip(dg._fields, g[1])):
            gathered[f"a{t}_{name}"] = _np(v)
        x = rollout(eng.model, sc.x, u[:, None, :], eng.config.dt)[:, -1]
        sc = sc._replace(x=x, vb=eng.model.twist(u))
    mine["a_rows"] = np.array([sc.x.shape[0]])
    try:  # a per-tick input left global is refused
        eng.replan_refresh(sc, GaussianMixture(*(torch.from_numpy(a) for a in gmm)), dom, world)
    except ValueError as e:
        mine["a_global_input"] = np.array(str(e))

    # ---- explore on (4,), a collective checkpoint, its reload, 3 more ticks
    eng = Engine(small_config(), mesh=mesh)
    world = eng.prepare_world(_grids(case["wall"], 0.1))
    phik = eng.phik_from_gmm(gmm, dom, world)
    out = eng.explore(eng.init_scenarios(case["x0"]), phik, world, TICKS_EXPLORE)
    gathered["explore_traj"] = _np(_gather_t(out.trajectory, mesh))
    ck = os.path.join(out_dir, "tier1_ck.npz")
    eng.save_checkpoint(ck, out.scenarios)
    back = eng.load_checkpoint(ck)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(out.scenarios)))
    mine["ck_reload_equal"] = np.array([same])
    resumed = eng.explore(back, phik, world, TICKS_RESUME)
    gathered["resume_traj"] = _np(_gather_t(resumed.trajectory, mesh))

    # ---- warmup and the mapping loop on (4,); the loop against this
    # process's unsharded engine
    mine["warmup_stages"] = np.array(sorted(Engine(small_config(**FUSED), mesh=mesh).warmup(
        S, dom, map_shape=(20, 20), gmm_components=2, n_ticks=(2,))))
    truth = _grids(case["walls"], 0.1)
    runs = []
    for e in (eng, Engine(small_config(), device="cpu")):
        sc_m, belief, cov, traj, _ = e.explore_mapping_fused(
            e.init_scenarios(case["x0"]), e.shard_scenarios(truth), n_refreshes=2,
            refresh_every=2)
        runs.append((traj, belief.data))
    lo, hi = process_scenario_slice(S)
    mine["mapping_traj_diff"] = np.array(
        [float((runs[0][0] - runs[1][0][:, :, lo:hi]).abs().max())])
    mine["mapping_belief_equal"] = np.array([torch.equal(runs[0][1], runs[1][1][lo:hi])])

    # ---- the (2, 2) mesh: sample-sharded targets and ticks
    mesh2 = make_mesh(2, 2)
    eng2 = Engine(small_config(), mesh=mesh2)
    gmm_far = GaussianMixture(*case["gmm_far"])
    w_walls = eng2.prepare_world(_grids(case["walls"], 0.1))
    w_degen = eng2.prepare_world(_grids(case["degen"], 0.1))
    for name, ph in (("unmasked", eng2.phik_from_gmm(gmm, dom)),
                     ("masked", eng2.phik_from_gmm(gmm, dom, w_walls)),
                     ("degenerate", eng2.phik_from_gmm(gmm_far, dom, w_degen)),
                     ("mi", eng2.phik_from_grid(_grids(case["beliefs"], 0.05), 2))):
        gathered[f"phik_{name}"] = _np(process_allgather(ph, mesh2))
    bgrids = _grids(case["beliefs"], 0.05)
    _, u, dg = eng2.replan_refresh_mi(eng2.init_scenarios(case["x0"]),
                                      eng2.shard_scenarios(bgrids), eng2.prepare_world(bgrids),
                                      sensor_radius_cells=2, domain=dom)
    gathered["mi_tick_u"], gathered["mi_tick_metric"] = (
        _np(v) for v in process_allgather((u, dg.ergodic_metric), mesh2))
    _, u, dg = eng2.replan_refresh(eng2.init_scenarios(case["x0"]), eng2.shard_scenarios(gmm),
                                   dom, w_walls)
    gathered["gmm_tick_u"], gathered["gmm_tick_metric"] = (
        _np(v) for v in process_allgather((u, dg.ergodic_metric), mesh2))

    # ---- process_scenario_slice and the refusals
    mine["slice_world"] = np.array(process_scenario_slice(S))
    mine["slice_mesh2"] = np.array(process_scenario_slice(S, mesh2))
    for name, call in (("slice_6", lambda: process_scenario_slice(6)),
                       ("mesh_small", lambda: make_mesh(2, 4)),
                       ("mesh_large", lambda: make_mesh(1, 2)),
                       ("scenario_mesh_large", lambda: make_scenario_mesh(2))):
        try:
            call()
            mine[name] = np.array("no error")
        except ValueError as e:
            mine[name] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"tier1_rank{rank}.npz"), **mine)
    if rank == 0:
        np.savez(os.path.join(out_dir, "tier1.npz"), **gathered)
    dist.barrier()


def _leaves(tree):
    from ergodic_exploration_tpu_torch.utils.checkpoint import _flatten

    return [leaf for _, leaf in _flatten(tree)]


def twin(rank, world, out_dir):
    """tests/multihost_worker.py on the port: each rank builds only its own
    scenarios' world and target (a local engine) and feeds them with
    ``shard_scenarios_from_local``."""
    import torch.distributed as dist

    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.parallel import global_scenario_mesh, process_scenario_slice

    cfg = small_config()
    mesh = global_scenario_mesh()
    engine = Engine(cfg, mesh=mesh)
    local = Engine(cfg, device="cpu")  # builds this rank's rows only
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    case = tier1_case()
    lo, hi = process_scenario_slice(S)
    sc = engine.init_scenarios(case["x0"])
    world = engine.shard_scenarios_from_local(local.prepare_world(
        _grids(case["wall"][lo:hi], 0.1)))
    phik = engine.shard_scenarios_from_local(local.phik_from_gmm(
        GaussianMixture(*(a[lo:hi] for a in case["gmm"])), dom, world))
    out = engine.explore(sc, phik, world, 10)
    traj = _np(_gather_t(out.trajectory, mesh))
    ck = os.path.join(out_dir, "twin_ck.npz")
    engine.save_checkpoint(ck, out.scenarios)
    sc2 = engine.load_checkpoint(ck)
    out_a = engine.explore(out.scenarios, phik, world, 5)
    out_b = engine.explore(sc2, phik, world, 5)
    a, b = (_np(_gather_t(o.trajectory, mesh)) for o in (out_a, out_b))
    np.testing.assert_allclose(a, b, atol=1e-6)
    if rank == 0:
        np.savez(os.path.join(out_dir, "twin.npz"), trajectory=traj, resumed=a)
    dist.barrier()


def main():
    run, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

    import torch
    import torch.distributed as dist

    from ergodic_exploration_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{os.path.join(out_dir, run + '_store')}", world, rank,
                         device="cpu")
    try:
        {"tier1": tier1, "twin": twin}[run](rank, world, out_dir)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main()
