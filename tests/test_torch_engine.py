"""The slice end to end: the port's Engine.replan_refresh (fused tick, K1's
plain version on the CPU) against the JAX Engine's vmapped path, over 4
ticks with a pose advance; and state carried from the JAX engine into the
port mid-run through utils/interop.py.

Tolerances are those of tests/test_solve_kernel.py:69-80: controls atol
5e-5, metric rtol 1e-5 / atol 1e-7, codes and DWA flags exact, buffer
states atol 1e-6, ck_sum rtol 1e-5 / atol 5e-6, random keys exact.
``orbit_window=2`` makes the orbit guard fire within the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu.ops.integrator import rollout as j_rollout
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.integrator import rollout
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S = 8
OPTS = dict(num_basis=6, buffer_capacity=64, grid_samples=(30, 30), shared_maps=True,
            shared_history_draw=True, orbit_window=2)


class _Jax:
    def __init__(self, x0, data, gmm_np):
        self.cfg = j_default_config("cart").replace(use_fused_solve=False, use_pallas=False,
                                                    **OPTS)
        self.eng = JEngine(self.cfg)
        self.world = self.eng.prepare_world(JGridMap(
            jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)), jnp.zeros((S, 2)),
            jnp.full((S,), 0.05)))
        self.gmm = jtarget.GaussianMixture.create(*gmm_np)
        self.domain = JDomain.create(0.0, 0.0, 3.0, 3.0)
        self.sc = self.eng.init_scenarios(x0)
        m, dt = self.eng.controller.model, self.cfg.dt
        self.advance = jax.jit(lambda sc, u: sc._replace(
            x=jax.vmap(lambda x, uu: j_rollout(m, x, uu[None, :], dt)[-1])(sc.x, u),
            vb=m.twist(u)))

    def tick(self):
        self.sc, u, dg = self.eng.replan_refresh(self.sc, self.gmm, self.domain, self.world)
        out = jax.tree.map(np.asarray, (self.sc, u, dg))
        self.sc = self.advance(self.sc, u)
        return out


class _Torch:
    def __init__(self, x0, data, gmm_np, sc=None):
        self.cfg = default_config("cart").replace(use_fused_solve=True, **OPTS)
        self.eng = Engine(self.cfg, device="cpu")
        self.world = self.eng.prepare_world(GridMap(
            torch.from_numpy(data).expand(S, 60, 60), torch.zeros(S, 2), torch.full((S,), 0.05)))
        self.gmm = GaussianMixture.create(*gmm_np)
        self.domain = Domain.create(0.0, 0.0, 3.0, 3.0)
        self.sc = self.eng.init_scenarios(x0) if sc is None else sc

    def tick(self):
        self.sc, u, dg = self.eng.replan_refresh(self.sc, self.gmm, self.domain, self.world)
        out = interop.to_numpy((self.sc, u, dg))
        x = rollout(self.eng.model, self.sc.x, u[:, None, :], self.cfg.dt)[:, -1]
        self.sc = self.sc._replace(x=x, vb=self.eng.model.twist(u))
        return out


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.4, 2.6, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    gmm = (rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32),
           np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
           np.ones((S, 2), np.float32))
    return x0, data, gmm


def _assert_tick_close(got, ref):
    (sc, u, dg), (sc_r, u_r, dg_r) = got, ref
    np.testing.assert_allclose(u, u_r, atol=5e-5)
    np.testing.assert_allclose(sc.state.U, sc_r.state.U, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
    np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
    np.testing.assert_array_equal(dg.orbit_reset, dg_r.orbit_reset)
    np.testing.assert_array_equal(dg.diverged, dg_r.diverged)
    np.testing.assert_allclose(sc.state.buffer.states, sc_r.state.buffer.states, atol=1e-6)
    np.testing.assert_array_equal(sc.state.buffer.count, sc_r.state.buffer.count)
    np.testing.assert_allclose(sc.state.ck_sum, sc_r.state.ck_sum, rtol=1e-5, atol=5e-6)
    np.testing.assert_array_equal(sc.state.rng, sc_r.state.rng.astype(np.int64))


@pytest.fixture(scope="module")
def runs():
    """4 JAX ticks, 4 port ticks from the same start, and 2 port ticks from
    the JAX state after its tick 2 (carried over through interop)."""
    x0, data, gmm = _inputs()
    j, t = _Jax(x0, data, gmm), _Torch(x0, data, gmm)
    sk.K1.reset_launches()
    ref, got, carried = [], [], []
    for i in range(4):
        ref.append(j.tick())
        got.append(t.tick())
        if i == 1:
            c = _Torch(x0, data, gmm, sc=interop.scenarios_from_numpy(
                jax.tree.map(np.asarray, j.sc), device="cpu"))
    for _ in range(2):
        carried.append(c.tick())
    return ref, got, carried


@pytest.mark.parametrize("tick", range(4))
def test_slice_matches_jax_engine(runs, tick):
    ref, got, _ = runs
    _assert_tick_close(got[tick], ref[tick])
    assert sum(sk.K1.launches.values()) == 0  # CPU tensors: K1's plain version, no launch


def test_orbit_guard_fires(runs):
    ref, got, _ = runs
    assert any(g[2].orbit_reset.any() for g in got)


@pytest.mark.parametrize("tick", range(2))
def test_state_carried_over_from_jax(runs, tick):
    ref, _, carried = runs
    _assert_tick_close(carried[tick], ref[2 + tick])


@pytest.mark.parametrize("safety", [True, False])
def test_eager_controller_path_matches_fused(safety):
    """use_fused_solve=False (the batched eager controller step) gives the
    same tick as the fused path on the CPU, with and without the safety
    stage (K1's fused_solve variant)."""
    x0, data, gmm = _inputs()
    ticks = []
    for fused in (True, False):
        t = _Torch(x0, data, gmm)
        t.eng = Engine(t.cfg.replace(use_fused_solve=fused, enable_safety=safety),
                       device="cpu")
        ticks.append(t.tick())
    _assert_tick_close(*ticks)
    assert ticks[0][2].dwa_active.any() == safety


def test_shared_map_contract_is_checked():
    x0, data, gmm = _inputs()
    t = _Torch(x0, data, gmm)
    bad = t.world.dist.dist.clone()
    bad[3, 0, 0] += 1.0
    with pytest.raises(ValueError, match="scenario indices \\[3\\]"):
        t.eng.replan_refresh(t.sc, t.gmm, t.domain,
                             t.world._replace(dist=t.world.dist._replace(dist=bad)))


@pytest.mark.parametrize("variant", ["shared", "shared_masked", "per_scenario"])
def test_phik_from_gmm_matches_jax(variant):
    """Engine.phik_from_gmm (K2's plain version on the CPU): the dense
    contraction on a shared domain, with the shared-map mask fold, and the
    per-scenario-domain path. GMMs cross over with utils/interop.py."""
    x0, data, gmm = _inputs()
    jcfg = j_default_config("cart").replace(use_pallas=False, **OPTS)
    cfg = default_config("cart").replace(**OPTS)
    je, te = JEngine(jcfg), Engine(cfg, device="cpu")
    jg = jtarget.GaussianMixture.create(*gmm)
    tg = interop.gmm_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                   jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    tw = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    if variant == "per_scenario":
        jd, td = jw.domain, tw.domain
    else:
        jd, td = JDomain.create(0.0, 0.0, 3.0, 3.0), Domain.create(0.0, 0.0, 3.0, 3.0)
    jm, tm = (jw.free_mask, tw.free_mask) if variant == "shared_masked" else (None, None)
    ref = np.asarray(je.phik_from_gmm(jg, jd, jm))
    np.testing.assert_allclose(te.phik_from_gmm(tg, td, tm).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_k2_route_raises_on_cuda_devices():
    """The K2 kernel object takes CUDA tensors only: handed anything else it
    raises and never returns the plain result; the dispatching wrapper takes
    the plain version for CPU tensors alone."""
    from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk

    x0, data, gmm = _inputs()
    g = GaussianMixture.create(*gmm)
    pts, D = torch.zeros(900, 2), torch.zeros(900, 36)
    gk.K2.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gk.K2(*g, pts, D)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gk.phik_from_gmm(*(t.to("meta") for t in g), pts.to("meta"), D.to("meta"))
    assert gk.phik_from_gmm(*g, pts, D).shape == (S, 36)
    assert sum(gk.K2.launches.values()) == 0 and gk.K2.built is None


def test_engine_default_device_is_cuda_or_an_error():
    """Engine(cfg) is the CUDA device; without one it raises and builds no
    CPU engine. The *_from_numpy functions of utils/interop.py likewise."""
    if torch.cuda.is_available():
        assert Engine(default_config("cart")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(default_config("cart"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.gmm_from_numpy(_inputs()[2])
    assert Engine(default_config("cart"), device="cpu").device.type == "cpu"
