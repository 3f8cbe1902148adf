"""The plain reference against the port's plain CPU path, entry by entry, at
a small S: on the CPU both run the same plain arithmetic, so every output
agrees bit for bit. (On the card the port runs its kernels; the benchmark's
check holds them to the reference there.)"""

import numpy as np
import pytest
import torch

from eebench import gen, program

S = 6


def _both(config: dict):
    port, ref = program.port(), program.reference()
    return port, ref, port.make_engine(config, "cpu"), ref.make_engine(config, "cpu")


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), (a - b).abs().max()
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _equal(x, y)


def _config(name, **engine):
    import json

    from eebench.harness import ROOT

    c = json.loads((ROOT / "eebench" / "configs" / f"{name}.json").read_text())
    return dict(c["engine"], **engine)


def _grids(prog, data):
    return prog.GridMap(torch.as_tensor(data), torch.zeros((data.shape[0], 2)),
                        torch.full((data.shape[0],), 0.05))


def test_replan_refresh_gmm():
    cfg = _config("cart_gmm", shared_maps=True, shared_history_draw=True)
    port, ref, pe, re_ = _both(cfg)
    data = np.broadcast_to(gen.wall_and_pillar(100), (S, 100, 100)).copy()
    x0 = gen.spawn(gen.rng(1, 1), S, gen.clearance(data[0], 0.05), 0.05, 0.4, 0.3, 4.7)
    mix = gen.mixtures(gen.rng(1, 2), S, 2, 0.3, 1.0, 4.0)
    outs = []
    for prog, eng in ((port, pe), (ref, re_)):
        world = eng.prepare_world(_grids(prog, data), domain=None)
        gmm = prog.GaussianMixture.create(*mix)
        dom = prog.Domain.create(0.0, 0.0, 5.0, 5.0)
        sc = eng.init_scenarios(x0)
        got = []
        for _ in range(3):
            sc, u, diag = eng.replan_refresh(sc, gmm, dom, world)
            got.append((sc.state, u, diag))
        outs.append(got)
    _equal(outs[0], outs[1])


def test_replan_refresh_mi():
    cfg = _config("omni_mi")
    port, ref, pe, re_ = _both(cfg)
    truth = gen.building()
    clear = gen.clearance(truth, 0.05)
    beliefs = gen.disc_beliefs(truth, gen.rng(2, 3), S, 3, 1.5, 0.05, clear, 0.4, "cpu")
    x0 = gen.spawn(gen.rng(2, 3), S, clear, 0.05, 0.4, 0.3, 4.7)
    outs = []
    for prog, eng in ((port, pe), (ref, re_)):
        grids = _grids(prog, beliefs)
        world = eng.prepare_world(grids)
        dom = prog.Domain.create(0.0, 0.0, 5.0, 5.0)
        sc = eng.init_scenarios(x0)
        got = []
        for _ in range(2):
            sc, u, diag = eng.replan_refresh_mi(sc, grids, world, 3, dom, use_mi_kernel=True)
            got.append((sc.state, u, diag))
        outs.append(got)
    _equal(outs[0], outs[1])


def test_explore_distinct_maps():
    cfg = _config("cart_gmm", shared_maps=False, shared_history_draw=False)
    port, ref, pe, re_ = _both(cfg)
    maps, rects = gen.distinct_rooms(gen.rng(3, 1), S, 100, 0.05)
    x0 = gen.spawn_clear_of(gen.rng(3, 2), rects, 0.25, 0.5, 4.5)
    mix = gen.mixtures(gen.rng(3, 3), S, 2, 0.3, 1.0, 4.0)
    outs = []
    for prog, eng in ((port, pe), (ref, re_)):
        world = eng.prepare_world(_grids(prog, maps))
        dom = prog.Domain.create(0.0, 0.0, 5.0, 5.0)
        phik = eng.phik_from_gmm(prog.GaussianMixture.create(*mix), dom, world.free_mask)
        out = eng.explore(eng.init_scenarios(x0), phik, world, 4)
        outs.append((phik, out.scenarios.state, out.trajectory, out.controls, out.diag))
    _equal(outs[0], outs[1])


@pytest.mark.parametrize("r", [0, 3])
def test_explore_mapping_fused(r):
    cfg = _config("omni_mi")
    port, ref, pe, re_ = _both(cfg)
    truth = np.broadcast_to(gen.building(), (S, 100, 100)).copy()
    x0 = gen.spawn(gen.rng(4, 10), S, gen.clearance(truth[0], 0.05), 0.05, 0.4, 0.3, 4.7)
    outs = []
    for prog, eng in ((port, pe), (ref, re_)):
        sc, belief, cov, traj, metric = eng.explore_mapping_fused(
            eng.init_scenarios(x0), _grids(prog, truth), n_refreshes=2, refresh_every=3,
            sensor_range=1.5, sensor_radius_cells=r)
        outs.append((sc.state, sc.x, belief.data, cov, traj, metric))
    _equal(outs[0], outs[1])
