"""The port's engine on the CPU replays the five frozen BASELINE
configurations of tests/golden/ (``config1..5.npz``, written by the JAX
package through tests/golden/generate.py): the same cases are rebuilt here
from the same numpy seed, and controls and trajectories must agree within
the goldens' own budget, atol / rtol 1e-4 (tests/test_golden.py).
"""

import os

import numpy as np
import pytest
import torch

from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

torch.set_num_threads(2)
HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
S = 8


def _cases():
    """The generator's draws, in its order: the start poses, then one GMM
    for each of configs 1, 2, 3 and 5 (config 4 draws nothing)."""
    rng = np.random.default_rng(42)
    x0 = np.concatenate([rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)

    def gmm_of(n_modes):
        return GaussianMixture.create(
            means=rng.uniform(1.0, 4.0, (S, n_modes, 2)).astype(np.float32),
            covs=np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, n_modes, 1, 1)),
            weights=np.ones((S, n_modes), np.float32))

    return x0, {"config1": gmm_of(1), "config2": gmm_of(2), "config3": gmm_of(1),
                "config5": gmm_of(2)}


def _grids(data):
    return GridMap(torch.from_numpy(data), torch.zeros(S, 2), torch.full((S,), 0.05))


def _run(name):
    x0, gmms = _cases()
    dom = Domain.create(0.0, 0.0, 5.0, 5.0)
    eng = Engine(default_config("omni" if name == "config2" else "cart"), device="cpu")
    sc = eng.init_scenarios(x0)
    if name in ("config1", "config2"):  # static GMM target, no obstacles
        outs = [eng.explore(sc, eng.phik_from_gmm(gmms[name], dom), eng.empty_world(dom, S), 12)]
    elif name == "config4":  # MI target recomputed from an evolving occupancy grid
        data = np.full((S, 100, 100), -1.0, dtype=np.float32)
        data[:, :40, :] = 0.0
        a = eng.explore(sc, eng.phik_from_grid(_grids(data)), eng.prepare_world(_grids(data)), 6)
        data2 = data.copy()
        data2[:, 40:70, :] = 0.0  # more of the map becomes known
        outs = [a, eng.explore(a.scenarios, eng.phik_from_grid(_grids(data2)),
                               eng.prepare_world(_grids(data2)), 6)]
    else:
        data = np.zeros((S, 100, 100), dtype=np.float32)
        if name == "config3":  # one obstacle map for all
            data[:, 45:50, 20:80] = 1.0
            data[:, 70:78, 60:68] = 1.0
        else:  # config5: a different wall per scenario
            for i in range(S):
                data[i, 20 + 7 * i:24 + 7 * i, 10:90] = 1.0
        world = eng.prepare_world(_grids(data))
        outs = [eng.explore(sc, eng.phik_from_gmm(gmms[name], dom, world), world, 12)]
    return {"controls": torch.cat([o.controls for o in outs]).numpy(),
            "trajectory": torch.cat([o.trajectory for o in outs]).numpy()}


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5"])
def test_port_replays_golden(name):
    want = np.load(os.path.join(HERE, f"{name}.npz"))
    got = _run(name)
    assert sorted(want.files) == ["controls", "trajectory"]
    for key in want.files:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name}:{key} differs from the golden")
