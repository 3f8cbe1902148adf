"""The traffic is fixed by its seed: the same seed gives the same arrays,
another seed other arrays, and the poses keep their clearance."""

import numpy as np
import pytest
import torch

from eebench import gen

SEEDS = [0, 2**31 + 7, 12345678901234]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_arrays(seed):
    def draw(s):
        truth = gen.building()
        clear = gen.clearance(truth, 0.05)
        maps, rects = gen.distinct_rooms(gen.rng(s, 1), 16, 100, 0.05)
        return (gen.spawn(gen.rng(s, 1), 16, clear, 0.05, 0.4, 0.3, 4.7),
                gen.mixtures(gen.rng(s, 2), 16, 2, 0.3, 1.0, 4.0).means, maps,
                gen.spawn_clear_of(gen.rng(s, 2), rects, 0.25, 0.5, 4.5),
                gen.disc_beliefs(truth, gen.rng(s, 3), 16, 3, 1.5, 0.05, clear, 0.4,
                                 "cpu").numpy())

    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y)
        assert not np.array_equal(x, z)


def test_spawns_keep_their_clearance():
    truth = gen.building()
    clear = gen.clearance(truth, 0.05)
    x = gen.spawn(gen.rng(5, 1), 512, clear, 0.05, 0.4, 0.3, 4.7)
    ij = (x[:, :2] / 0.05).astype(int)
    assert (clear[ij[:, 1], ij[:, 0]] > 0.4).all()
    assert (x[:, 2] >= -np.pi).all() and (x[:, 2] <= np.pi).all()


def test_clearance_is_the_distance_to_the_nearest_obstacle():
    data = np.zeros((20, 20), np.float32)
    data[10, 10] = 1.0
    clear = gen.clearance(data, 0.05)
    assert clear[10, 10] == 0.0
    assert clear[10, 13] == pytest.approx(0.15)
    assert clear[14, 13] == pytest.approx(0.25)


def test_disc_beliefs_show_the_truth_inside_the_discs_only():
    truth = gen.building()
    b = gen.disc_beliefs(truth, gen.rng(9, 3), 8, 2, 1.0, 0.05, gen.clearance(truth, 0.05),
                         0.4, "cpu")
    known = b != -1.0
    assert known.any(dim=(1, 2)).all() and not known.all()
    assert torch.equal(b[known], torch.as_tensor(truth).expand(8, 100, 100)[known])


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_plant_moves_by_the_twist(model):
    cfg = {"dt": 0.1, "model": model, "cart": {"wheel_radius": 0.033, "wheel_base": 0.16},
           "omni": {"wheel_radius": 0.0505, "lx": 0.28, "ly": 0.2665}}
    plant = gen.Plant(cfg)
    x = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, np.pi / 2]], np.float32)
    u = np.full((2, 2 if model == "cart" else 4), 5.0, np.float32)
    nxt, tw = plant.step(x, u)
    v = tw[0, 0]
    assert v > 0 and abs(tw[0, 2]) < 1e-6
    assert nxt[0, 0] == pytest.approx(1.0 + 0.1 * v) and nxt[0, 1] == pytest.approx(2.0)
    assert nxt[1, 1] == pytest.approx(2.0 + 0.1 * v) and nxt[1, 0] == pytest.approx(1.0)
    again, _ = plant.step(x, u)
    assert np.array_equal(nxt, again)
