"""The single-robot node: the port's ExplorationNode against the JAX
package's on the CPU, on one fixed odometry stream.

Budgets are those of tests/test_solve_kernel.py:69-72 (twists atol 5e-5,
metric rtol 1e-5, collision codes and DWA flags equal); phi_k of the MI
target at tests/test_torch_target_mi.py's 2e-5. The sizes are
tests/test_node.py's ``_cfg`` (K = 6, H = 8, a ring of 32, a 20 x 20
lattice) on a 40 x 40 map of 0.05 m with a wall the robot starts beside, so
the stream sees obstacle warnings and DWA takeovers; ``r_diag`` 0.1 (not
0.001) keeps the first ticks' wheel controls inside their +-6 rad/s limits,
so the budget is held on values the saturation does not fix.
"""

import jax
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.node import ExplorationNode as JNode
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.controller import StepDiagnostics
from ergodic_exploration_tpu_torch.node import ExplorationNode
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
SMALL = dict(num_basis=6, horizon=8, buffer_capacity=32, grid_samples=(20, 20),
             r_diag=(0.1, 0.1))
MEANS = np.array([[1.5, 1.5]], np.float32)
COVS = 0.1 * np.eye(2, dtype=np.float32)[None]
POSES = [[0.5, 0.5, 0.3], [0.55, 0.52, 0.35], [0.6, 0.55, 0.4], [0.66, 0.6, 0.42],
         [0.7, 0.66, 0.45], [0.74, 0.7, 0.5], [0.78, 0.75, 0.55], [0.8, 0.8, 0.6]]
CARRY_AT = 5  # ticks the JAX node runs before its state is carried over
TW_ATOL, METRIC_RTOL, PHIK_ATOL = 5e-5, 1e-5, 2e-5


def _map():
    data = np.zeros((40, 40), np.int8)
    data[18:22, 10:30] = 100
    return data


def _mi_map(extra_wall=False):
    """Partially known int8 map: a known-free strip, obstacles, the rest -1."""
    raw = np.full((40, 40), -1, np.int8)
    raw[:12, :] = 0
    raw[5:8, 20:26] = 100
    raw[12:14, 4:10] = 30  # known, neither free nor occupied
    if extra_wall:
        raw[12:30, 30:40] = 0
        raw[20:22, 30:38] = 100
    return raw


def _node(**kw):
    opts = {k: kw.pop(k) for k in ("use_native", "pipeline", "target") if k in kw}
    opts.setdefault("target", GaussianMixture.create(MEANS, COVS))
    return ExplorationNode(default_config("cart").replace(**SMALL, **kw), device="cpu", **opts)


def _drive(node, poses=POSES):
    node.on_map(_map(), resolution=0.05)
    out = []
    for p in poses:
        node.on_odom(p)
        out.append(node.step())
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX node's eager path over the stream: twists, diagnostics as
    numpy, its state after CARRY_AT ticks and its final predicted path."""
    node = JNode(j_default_config("cart").replace(**SMALL),
                 target=jtarget.GaussianMixture.create(MEANS, COVS), use_native=False)
    node.on_map(_map(), resolution=0.05)
    tws, diags, carried = [], [], None
    for t, p in enumerate(POSES):
        if t == CARRY_AT:
            carried = jax.tree.map(np.asarray, node.state)
        node.on_odom(p)
        tw, d = node.step()
        tws.append(np.asarray(tw))
        diags.append(jax.tree.map(np.asarray, d))
    return dict(tw=np.stack(tws), diags=diags, carried=carried, path=node.predicted_path())


def _check_against_jax(ref, got):
    tw = np.stack([g[0] for g in got])
    np.testing.assert_allclose(tw, ref["tw"], rtol=0, atol=TW_ATOL)
    # some twists are not saturated (0.198 m/s and 2.475 rad/s are the limits)
    assert (np.abs(ref["tw"][:, 0]) < 0.19).sum() >= 3
    np.testing.assert_allclose([float(g[1].ergodic_metric) for g in got],
                               [float(d.ergodic_metric) for d in ref["diags"]],
                               rtol=METRIC_RTOL)
    for g, d in zip(got, ref["diags"]):
        assert int(g[1].collision_code) == int(d.collision_code)
        assert bool(g[1].dwa_active) == bool(d.dwa_active)
        assert bool(g[1].dwa_feasible) == bool(d.dwa_feasible)
    # the stream exercises the safety stage, not only the ergodic update
    codes = {int(d.collision_code) for d in ref["diags"]}
    assert {0, 1, 2} <= codes, codes


@pytest.mark.parametrize("use_native", [False, True], ids=["torch_edt", "native_edt"])
def test_node_eager_matches_jax_node(jax_run, use_native):
    node = _node(use_native=use_native)
    assert node.use_native == use_native
    _check_against_jax(jax_run, _drive(node))


def test_node_fused_matches_jax_vmapped_node(jax_run, monkeypatch):
    """use_fused_solve=True (K1's plain version on the CPU) against the JAX
    node's vmapped path at the same budget (the JAX package's own
    fused-vs-vmapped budget is 5e-4, tests/test_node.py)."""
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk

    calls = []
    plain = sk.fused_solve_safety_plain
    monkeypatch.setattr(sk, "fused_solve_safety_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    _check_against_jax(jax_run, _drive(_node(use_fused_solve=True)))
    assert len(calls) == len(POSES)  # every tick went through K1's plain version


def test_node_state_carried_from_jax_gives_the_same_next_tick(jax_run):
    """The JAX node's state after CARRY_AT ticks, carried over through
    utils/interop.state_from_numpy into a fresh port node, gives the JAX
    node's next tick."""
    node = _node()
    node.on_map(_map(), resolution=0.05)
    node.on_odom(POSES[0])
    node.step()  # builds the world and the target
    node.state = interop.state_from_numpy(jax_run["carried"], device="cpu")
    assert node.state.U.shape == (1, SMALL["horizon"], 2)
    node.on_odom(POSES[CARRY_AT])
    tw, diag = node.step()
    np.testing.assert_allclose(tw, jax_run["tw"][CARRY_AT], rtol=0, atol=TW_ATOL)
    assert int(diag.collision_code) == int(jax_run["diags"][CARRY_AT].collision_code)


def test_node_predicted_path_matches_jax(jax_run):
    node = _node()
    _drive(node)
    path = node.predicted_path()
    assert path.shape == (SMALL["horizon"] + 1, 3)
    np.testing.assert_allclose(path, jax_run["path"], rtol=0, atol=TW_ATOL)


def test_node_pipelined_twists_are_unpipelined_shifted_by_one():
    ref = _drive(_node())
    pipe_node = _node(pipeline=True)
    got = _drive(pipe_node)
    np.testing.assert_array_equal(got[0][0], 0.0)  # one-tick startup latency
    assert got[0][1] is None
    tail = pipe_node.flush()
    assert tail is not None and pipe_node.flush() is None
    got = got[1:] + [tail]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), np.stack([r[0] for r in ref]))
    for (_, d), (_, r) in zip(got, ref):
        assert isinstance(d, StepDiagnostics)
        assert all(isinstance(leaf, np.generic) for leaf in d)
        assert d == r


def test_node_mi_target_matches_jax_and_follows_map_updates():
    jnode = JNode(j_default_config("cart").replace(**SMALL), target="mi", use_native=False)
    jnode.on_map(_mi_map(), 0.0, 0.0, 0.05)
    jnode._refresh()
    ref = np.asarray(jnode._phik)
    for use_native in (False, True):
        node = _node(target="mi", use_native=use_native)
        node.on_map(_mi_map(), 0.0, 0.0, 0.05)
        node._refresh()
        np.testing.assert_allclose(node._phik[0].numpy(), ref, rtol=0, atol=PHIK_ATOL)
        before = node._phik.clone()
        node.on_map(_mi_map(extra_wall=True), 0.0, 0.0, 0.05)
        node.on_odom([0.5, 0.3, 0.0])
        tw, _ = node.step()  # the update is applied at the next tick
        assert np.isfinite(tw).all()
        assert not torch.allclose(before, node._phik)


def test_node_mi_loop_before_and_after_a_map():
    """A node built before any map (an empty 2 x 2 world, uniform target)
    ticks, then takes a map and its domain from it; run() drives a plant."""
    from ergodic_exploration_tpu_torch.grid import Domain

    node = ExplorationNode(default_config("cart").replace(**SMALL),
                           domain=Domain.create(0.0, 0.0, 2.0, 2.0), target="mi", device="cpu")
    node.on_odom([1.0, 0.4, 0.3])
    tw, _ = node.step()
    assert node._world.dist.dist.shape == (1, 2, 2) and np.isfinite(tw).all()

    node = ExplorationNode(default_config("cart").replace(**SMALL), target="mi", device="cpu")
    with pytest.raises(RuntimeError, match="no domain"):
        node.step()
    node.on_map(_mi_map(), 0.0, 0.0, 0.05)
    np.testing.assert_allclose(node.domain.lengths.numpy(), [2.0, 2.0])
    node.on_odom([1.0, 0.4, 0.3])

    def plant(tw):
        from ergodic_exploration_tpu_torch.ops.integrator import constant_twist_poses

        X = constant_twist_poses(node._pose, torch.as_tensor(tw), torch.tensor([0.1]))
        return X[0], tw

    node.run(rate_hz=1000.0, n_steps=6, plant=plant)
    assert node.ticks == 6 and torch.isfinite(node._pose).all()


def test_node_defaults():
    """The default device is the CUDA device or an error; the initial key is
    jax.random.PRNGKey(0)."""
    cfg = default_config("cart").replace(**SMALL)
    if torch.cuda.is_available():
        assert ExplorationNode(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExplorationNode(cfg)
    node = ExplorationNode(cfg, device="cpu")
    np.testing.assert_array_equal(node.state.rng.numpy(),
                                  np.asarray(jax.random.PRNGKey(0))[None].astype(np.int64))
    assert node.state.U.shape == (1, SMALL["horizon"], 2)
