"""The port's engine at num_basis 20 and horizon 80, past the K <= 16,
H <= 64 that K1 and K2 once took, against the JAX Engine's vmapped path on
the CPU (K1's and K2's plain versions here; the kernels themselves are held
against these at such shapes in tests/test_torch_cuda_host.py and on the
card by phase 21 of chip_smoke.py).

Budgets are ROADMAP's port rules (tests/test_solve_kernel.py:69-80):
controls atol 5e-5, metric rtol 1e-5 / atol 1e-7, codes and DWA flags
exact, ck_sum rtol 1e-5 / atol 5e-6; phi_k as tests/test_torch_engine.py
holds it (rtol 1e-5, atol 1e-6).
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
S, TICKS = 4, 2
OPTS = dict(num_basis=20, horizon=80, buffer_capacity=64, grid_samples=(20, 20))
SHARED = dict(shared_maps=True, shared_history_draw=True)
OWN = dict(shared_maps=False, shared_history_draw=False, buffer_batch=24)


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.4, 2.6, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    gmm = (rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32),
           np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
           np.ones((S, 2), np.float32))
    return x0, data, gmm


def _jax_ticks(opts, refresh):
    """TICKS ticks of the JAX engine's vmapped path with a pose advance:
    replan_refresh (refresh) or phik_from_gmm once, then replan."""
    x0, data, gmm_np = _inputs()
    cfg = j_default_config("cart").replace(use_fused_solve=False, use_pallas=False, **OPTS,
                                           **opts)
    eng = JEngine(cfg)
    world = eng.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                       jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    gmm = jtarget.GaussianMixture.create(*gmm_np)
    dom = JDomain.create(0.0, 0.0, 3.0, 3.0)
    sc = eng.init_scenarios(x0)
    phik = None if refresh else eng.phik_from_gmm(gmm, dom, world.free_mask)
    m = eng.controller.model
    advance = jax.jit(lambda sc, u: sc._replace(
        x=jax.vmap(lambda x, uu: j_rollout(m, x, uu[None, :], cfg.dt)[-1])(sc.x, u),
        vb=m.twist(u)))
    out = []
    for _ in range(TICKS):
        if refresh:
            sc, u, dg = eng.replan_refresh(sc, gmm, dom, world)
        else:
            sc, u, dg = eng.replan(sc, phik, world)
        out.append(jax.tree.map(np.asarray, (sc, u, dg)))
        sc = advance(sc, u)
    return out, None if phik is None else np.asarray(phik)


def _torch_ticks(opts, refresh):
    """The same ticks through the port's fused path (K1's plain version)."""
    x0, data, gmm_np = _inputs()
    cfg = default_config("cart").replace(use_fused_solve=True, **OPTS, **opts)
    eng = Engine(cfg, device="cpu")
    world = eng.prepare_world(GridMap(torch.from_numpy(data).expand(S, 60, 60),
                                      torch.zeros(S, 2), torch.full((S,), 0.05)))
    gmm = GaussianMixture.create(*gmm_np)
    dom = Domain.create(0.0, 0.0, 3.0, 3.0)
    sc = eng.init_scenarios(x0)
    phik = None if refresh else eng.phik_from_gmm(gmm, dom, world)
    out = []
    for _ in range(TICKS):
        if refresh:
            sc, u, dg = eng.replan_refresh(sc, gmm, dom, world)
        else:
            sc, u, dg = eng.replan(sc, phik, world)
        out.append(interop.to_numpy((sc, u, dg)))
        sc = sc._replace(x=rollout(eng.model, sc.x, u[:, None, :], cfg.dt)[:, -1],
                         vb=eng.model.twist(u))
    return out, None if phik is None else phik.numpy()


@pytest.mark.parametrize("case", ["shared_map_refresh", "own_maps_drawn_history"])
def test_engine_at_K20_H80_matches_jax_engine(case):
    """replan_refresh on a shared map (the refresh inside K1) and replan on
    per-scenario maps with per-scenario history draws (K1's nb > 0 variant,
    after phik_from_gmm through K2 with a per-scenario mask), tick by tick."""
    opts, refresh = (SHARED, True) if case == "shared_map_refresh" else (OWN, False)
    sk.K1.reset_launches()
    (ref, phik_ref), (got, phik) = _jax_ticks(opts, refresh), _torch_ticks(opts, refresh)
    if phik is not None:
        assert phik.shape == (S, 20, 20)
        np.testing.assert_allclose(phik, phik_ref, rtol=1e-5, atol=1e-6)
    for (sc, u, dg), (sc_r, u_r, dg_r) in zip(got, ref):
        assert u.shape == (S, 2) and sc.state.U.shape == (S, 80, 2)
        np.testing.assert_allclose(u, u_r, atol=5e-5)
        np.testing.assert_allclose(sc.state.U, sc_r.state.U, atol=5e-5)
        np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
        np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
        np.testing.assert_array_equal(dg.diverged, dg_r.diverged)
        np.testing.assert_allclose(sc.state.ck_sum, sc_r.state.ck_sum, rtol=1e-5, atol=5e-6)
    assert sum(sk.K1.launches.values()) == 0  # CPU tensors: the plain version, no launch
