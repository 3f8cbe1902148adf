"""Config 4 end to end on the CPU, the port against the JAX package on the
same numpy inputs: ``Engine.phik_from_grid`` (dense and separable branches),
``replan_refresh_mi`` (dense, and through K3: its plain version here, the
Pallas kernel in interpret mode there), ``explore_mapping`` (disc and
ray-cast), ``explore_mapping_fused``, and ``warmup``'s MI stages.

Budgets: phi_k rtol 2e-4 / atol 2e-5 (tests/test_mi_kernel.py); one tick's
controls atol 5e-5 with equal collision codes (tests/test_solve_kernel.py);
the closed loops as tests/test_torch_explore.py holds ``explore`` (controls
and trajectory atol 5e-5, metric rtol 1e-5 / atol 1e-7) over the first two
refreshes (10 ticks), codes and flags equal, beliefs cell for cell, coverage
atol 1e-6. The third refresh's ticks start from states that differ by
rounding (3e-8 through tick 9) and pass close to the wall, where the
barrier's 1/d^2 terms amplify that for a few ticks (measured: one unsaturated
control off by 3.6e-4 at tick 12, one pose coordinate by 5.7e-5, back to
8.7e-6 at tick 13): there controls of up to 6 rad/s are held to atol 1e-3,
poses to 1e-4 and the metric to rtol 1e-4, as ``chip_smoke.py`` holds the
later ticks of ``explore`` on the card against the CPU.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import mi_kernel as mk
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
PHIK_TOL = dict(rtol=2e-4, atol=2e-5)
LATE = dict(u=1e-3, x=1e-4, metric=1e-4)  # ticks of the third refresh (module docstring)


def _mi_case(S=8, h=40, w=40):
    """tests/test_mi_kernel.py's beliefs and full-tick case, as numpy."""
    rng = np.random.default_rng(7)
    data = np.full((S, h, w), -1.0, dtype=np.float32)
    data[:, :, : w // 2] = 0.0
    data[:, 10:14, 5:15] = 1.0
    for s in range(S):
        r0 = rng.integers(0, h - 6)
        data[s, r0:r0 + 6, w // 2:w // 2 + 8] = rng.uniform(0.0, 1.0, (6, 8)).astype(np.float32)
    data[S - 1] = 1.0
    rng = np.random.default_rng(3)
    x0 = np.concatenate([rng.uniform(0.3, 1.7, (S, 2)), rng.uniform(-3, 3, (S, 1))],
                        axis=1).astype(np.float32)
    wdata = np.zeros((S, h, w), np.float32)
    wdata[:, 10:14, 5:15] = 1.0
    return data, x0, wdata


def _jgrids(data, res=0.05):
    S = data.shape[0]
    return JGridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                    jnp.full((S,), res, jnp.float32))


def _tgrids(data, res=0.05):
    """The same grids for the port, through the interop function."""
    S = data.shape[0]
    return interop.grids_from_numpy(
        (data, np.zeros((S, 2), np.float32), np.full((S,), res, np.float32)), device="cpu")


@pytest.mark.parametrize("r", [0, 3])
def test_phik_from_grid_both_branches_match_jax(r):
    data, _, _ = _mi_case()
    opts = dict(num_basis=6, grid_samples=(23, 23))
    je = JEngine(j_default_config("cart").replace(**opts))
    te = Engine(default_config("cart").replace(**opts), device="cpu")
    jd, td = JDomain.create(0.0, 0.0, 2.0, 2.0), Domain.create(0.0, 0.0, 2.0, 2.0)
    for kw_j, kw_t in ((dict(domain=jd), dict(domain=td)), ({}, {})):  # dense, separable
        ref = np.asarray(je.phik_from_grid(_jgrids(data), r, **kw_j))
        got = te.phik_from_grid(_tgrids(data), r, **kw_t).numpy()
        assert got.shape == (8, 6, 6)
        np.testing.assert_allclose(got, ref, **PHIK_TOL)


def test_interop_grids_and_the_shared_geometry_guard():
    data, _, _ = _mi_case()
    g = _tgrids(data)
    assert g.data.dtype == torch.float32 and g.origin.shape == (8, 2) and g.shape == (40, 40)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interop.grids_from_numpy((data, np.zeros((8, 2)), np.full((8,), 0.05)))
    te = Engine(default_config("cart").replace(num_basis=6, grid_samples=(23, 23)), device="cpu")
    bad = g._replace(resolution=g.resolution.clone())
    bad.resolution[5] = 0.04
    with pytest.raises(ValueError, match="scenario indices \\[5\\]"):
        te.phik_from_grid(bad, domain=Domain.create(0.0, 0.0, 2.0, 2.0))
    assert te.phik_from_grid(bad).shape == (8, 6, 6)  # per-scenario geometry: separable
    no_scenario_dim = SimpleNamespace(mesh_dim_names=("sample",), device_type="cpu")
    with pytest.raises(ValueError, match="mesh must have a 'scenario' axis"):
        Engine(default_config("cart"), device="cpu", mesh=no_scenario_dim)


@pytest.fixture(scope="module")
def jax_mi_tick():
    """The JAX tick with the dense refresh and with its Pallas MI kernel
    (interpret mode off the TPU), radius 3, from the same state."""
    data, x0, wdata = _mi_case()
    cfg = j_default_config("cart").replace(
        num_basis=6, grid_samples=(23, 23), buffer_capacity=64, use_fused_solve=False,
        shared_maps=True, shared_history_draw=True)
    eng = JEngine(cfg)
    world = eng.prepare_world(_jgrids(wdata))
    dom = JDomain.create(0.0, 0.0, 2.0, 2.0)
    out = {}
    for kernel in (False, True):
        _, u, d = eng.replan_refresh_mi(eng.init_scenarios(x0), _jgrids(data), world,
                                        sensor_radius_cells=3, domain=dom, use_mi_kernel=kernel)
        out[kernel] = (np.asarray(u), jax.tree.map(np.asarray, d))
    return out


@pytest.mark.parametrize("use_mi_kernel", [False, True], ids=["dense", "k3"])
@pytest.mark.parametrize("fused", [True, False], ids=["k1", "eager"])
def test_replan_refresh_mi_matches_jax(jax_mi_tick, use_mi_kernel, fused):
    data, x0, wdata = _mi_case()
    cfg = default_config("cart").replace(
        num_basis=6, grid_samples=(23, 23), buffer_capacity=64, use_fused_solve=fused,
        shared_maps=True, shared_history_draw=True)
    eng = Engine(cfg, device="cpu")
    world = eng.prepare_world(_tgrids(wdata))
    mk.K3.reset_launches()
    sk.K1.reset_launches()
    sc, u, d = eng.replan_refresh_mi(eng.init_scenarios(x0), _tgrids(data), world,
                                     sensor_radius_cells=3,
                                     domain=Domain.create(0.0, 0.0, 2.0, 2.0),
                                     use_mi_kernel=use_mi_kernel)
    assert sum(mk.K3.launches.values()) == 0 and sum(sk.K1.launches.values()) == 0
    u_ref, d_ref = jax_mi_tick[use_mi_kernel]
    np.testing.assert_allclose(u.numpy(), u_ref, atol=5e-5)
    np.testing.assert_array_equal(d.collision_code.numpy(), d_ref.collision_code)
    np.testing.assert_array_equal(d.dwa_active.numpy(), d_ref.dwa_active)
    np.testing.assert_allclose(d.ergodic_metric.numpy(), d_ref.ergodic_metric, rtol=1e-4,
                               atol=1e-7)  # phi_k itself carries rtol 2e-4 between the paths
    assert torch.equal(sc.x, torch.from_numpy(x0))  # the tick does not move the robots
    if use_mi_kernel:  # the operands were built once for this geometry
        assert len(eng._mi_operands) == 1
        eng.replan_refresh_mi(sc, _tgrids(data), world, sensor_radius_cells=3,
                              domain=Domain.create(0.0, 0.0, 2.0, 2.0), use_mi_kernel=True)
        assert len(eng._mi_operands) == 2  # new tensors name a new geometry


def test_replan_refresh_mi_without_a_shared_domain_is_separable():
    data, x0, wdata = _mi_case()
    opts = dict(num_basis=6, grid_samples=(23, 23), buffer_capacity=64)
    je = JEngine(j_default_config("cart").replace(use_fused_solve=False, **opts))
    _, u_ref, d_ref = je.replan_refresh_mi(je.init_scenarios(x0), _jgrids(data),
                                           je.prepare_world(_jgrids(wdata)), 2)
    te = Engine(default_config("cart").replace(use_fused_solve=True, **opts), device="cpu")
    _, u, d = te.replan_refresh_mi(te.init_scenarios(x0), _tgrids(data),
                                   te.prepare_world(_tgrids(wdata)), 2, use_mi_kernel=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), atol=5e-5)
    np.testing.assert_array_equal(d.collision_code.numpy(), np.asarray(d_ref.collision_code))


# --- the mapping loops, on tests/test_sensor.py::test_explore_mapping_fused_matches_host_loop

MAP_OPTS = dict(num_basis=6, horizon=8, buffer_capacity=32, grid_samples=(20, 20))


def _mapping_case():
    S = 2
    data = np.zeros((S, 30, 30), np.float32)
    data[:, 13:16, 5:22] = 1.0
    x0 = np.array([[0.4, 0.4, 0.5], [1.1, 1.1, -2.0]], np.float32)
    return data, x0


@pytest.fixture(scope="module")
def jax_mapping():
    data, x0 = _mapping_case()
    eng = JEngine(j_default_config("cart").replace(use_fused_solve=False, **MAP_OPTS))
    truth = _jgrids(data)
    out = {}
    for model in ("raycast", "disc"):
        o, b, cov = eng.explore_mapping(eng.init_scenarios(x0), truth, n_ticks=15,
                                        refresh_every=5, sensor_range=0.5, sensor_model=model)
        out[model] = (jax.tree.map(np.asarray, o), np.asarray(b.data), np.asarray(cov))
    sc, b, cov, traj, em = eng.explore_mapping_fused(
        eng.init_scenarios(x0), truth, n_refreshes=3, refresh_every=5, sensor_range=0.5)
    out["fused"] = (jax.tree.map(np.asarray, sc), np.asarray(b.data), np.asarray(cov),
                    np.asarray(traj), np.asarray(em))
    return out


@pytest.mark.parametrize("fused_solve", [True, False], ids=["k1", "eager"])
@pytest.mark.parametrize("model", ["raycast", "disc"])
def test_explore_mapping_matches_jax(jax_mapping, model, fused_solve):
    data, x0 = _mapping_case()
    eng = Engine(default_config("cart").replace(use_fused_solve=fused_solve, **MAP_OPTS),
                 device="cpu")
    out, belief, cov = eng.explore_mapping(eng.init_scenarios(x0), _tgrids(data), n_ticks=15,
                                           refresh_every=5, sensor_range=0.5,
                                           sensor_model=model)
    ref, b_ref, cov_ref = jax_mapping[model]
    got = interop.to_numpy(out)
    np.testing.assert_array_equal(belief.data.numpy(), b_ref)
    np.testing.assert_allclose(cov.numpy(), cov_ref, atol=1e-6)
    assert cov.shape == (3,) and cov[0] < cov[-1]
    # the output is the third refresh's chunk
    np.testing.assert_allclose(got.controls, ref.controls, atol=LATE["u"])
    np.testing.assert_allclose(got.trajectory, ref.trajectory, atol=LATE["x"])
    np.testing.assert_allclose(got.ergodic_metric, ref.diag.ergodic_metric, rtol=LATE["metric"],
                               atol=1e-7)
    np.testing.assert_array_equal(got.diag.collision_code, ref.diag.collision_code)
    np.testing.assert_array_equal(got.diag.dwa_active, ref.diag.dwa_active)
    with pytest.raises(ValueError, match="unknown sensor_model"):
        eng.explore_mapping(eng.init_scenarios(x0), _tgrids(data), 5, sensor_model="lidar")


def test_explore_mapping_fused_matches_jax_and_the_host_loop(jax_mapping):
    data, x0 = _mapping_case()
    eng = Engine(default_config("cart").replace(use_fused_solve=True, **MAP_OPTS), device="cpu")
    sc, belief, cov, traj, em = eng.explore_mapping_fused(
        eng.init_scenarios(x0), _tgrids(data), n_refreshes=3, refresh_every=5, sensor_range=0.5)
    sc_ref, b_ref, cov_ref, traj_ref, em_ref = jax_mapping["fused"]
    assert traj.shape == (3, 5, 2, 3) and em.shape == (3, 5, 2) and cov.shape == (3,)
    np.testing.assert_array_equal(belief.data.numpy(), b_ref)
    np.testing.assert_allclose(cov.numpy(), cov_ref, atol=1e-6)
    np.testing.assert_allclose(traj[:2].numpy(), traj_ref[:2], atol=5e-5)
    np.testing.assert_allclose(em[:2].numpy(), em_ref[:2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(traj[2].numpy(), traj_ref[2], atol=LATE["x"])
    np.testing.assert_allclose(em[2].numpy(), em_ref[2], rtol=LATE["metric"], atol=1e-7)
    np.testing.assert_allclose(sc.x.numpy(), sc_ref.x, atol=LATE["x"])
    np.testing.assert_array_equal(sc.state.hist_count.numpy(), sc_ref.state.hist_count)
    np.testing.assert_array_equal(sc.state.rng.numpy(), sc_ref.state.rng.astype(np.int64))
    # inside the port: the fused loop (dense refresh) == the host loop (separable refresh)
    out_h, belief_h, cov_h = eng.explore_mapping(
        eng.init_scenarios(x0), _tgrids(data), n_ticks=15, refresh_every=5, sensor_range=0.5,
        sensor_model="raycast")
    assert torch.equal(belief.data, belief_h.data)
    np.testing.assert_allclose(cov.numpy(), cov_h.numpy(), atol=1e-6)
    np.testing.assert_allclose(traj[-1, -1].numpy(), out_h.trajectory[-1].numpy(), rtol=2e-4,
                               atol=2e-5)


def test_raycast_mapping_keeps_the_hidden_side_unknown():
    """With the ray-cast sensor, robots on the left of a full-height wall do
    not reveal the right side (tests/test_sensor.py's end-to-end case)."""
    data = np.zeros((2, 40, 40), np.float32)
    data[:, :, 19:21] = 1.0
    x0 = np.array([[0.5, 0.5, 0.5], [0.5, 1.5, -0.5]], np.float32)
    eng = Engine(default_config("cart").replace(use_fused_solve=True, **MAP_OPTS), device="cpu")
    out, belief, cov = eng.explore_mapping(eng.init_scenarios(x0), _tgrids(data), n_ticks=20,
                                           sensor_range=0.6, refresh_every=10)
    assert (belief.data[:, :, 25:] == -1.0).all(), "saw through the wall"
    assert cov[-1] > 0.0 and torch.isfinite(out.trajectory).all()


def test_warmup_reports_the_mi_stages():
    eng = Engine(default_config("cart").replace(num_basis=5, buffer_capacity=32, horizon=6,
                                                grid_samples=(20, 20)), device="cpu")
    dom = Domain.create(0.0, 0.0, 1.0, 1.0)
    t = eng.warmup(4, dom, map_shape=(20, 20), n_ticks=(2,))
    assert list(t) == ["init_scenarios", "prepare_world", "phik_from_grid", "replan_refresh_mi",
                       "phik_from_gmm", "replan", "replan_refresh", "explore_2"]
    assert all(v >= 0.0 for v in t.values())
    assert "phik_from_grid" not in eng.warmup(4, dom)  # no map, no MI stage
