"""The eager controller step (``ErgodicController.step``, the tick of the
default configuration) on the chain of the fused tick: ``glue_pre`` with the
patch starts, K1 without its safety stage (``fused_solve``), validation +
DWA on the patch's central crop (``fused_safety_map``), ``glue_post``.

On CPU tensors each stage is its plain version, so the step must equal, bit
for bit (``torch.equal``), the step composed here from the package's plain
functions: ``extract_patch`` around the pose, the history sums of the drawn positions (``drawn_history_sums``)
or of the ring / the accumulated sum (``history_sums``), ``descent``, the
``ck_sum`` append, ``safety_on_crop`` on ``center_crop`` of the patch, and
``finish_tick``. Cart and omni; per-scenario draws, the full ring and the
accumulate mode; safety on and off; one shared map (with the shared-draw
flag set, which the step ignores) and per-scenario maps; poses on the map's
edges and corners. One case is held against the JAX package's
``jax.vmap(ErgodicController.step)``: U atol 5e-5, the metric rtol 1e-5,
codes and DWA flags equal.
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
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.controller import (
    descent, drawn_history_sums, finish_tick, history_sums, safety_on_crop)
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops.integrator import rollout
from ergodic_exploration_tpu_torch.ops.patch import extract_patch
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.ops.tick_glue import glue_pre, history_mode
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S, H_MAP, W_MAP, TICKS = 10, 40, 50, 3
RES = 0.05


def _maps(shared: bool, seed: int) -> np.ndarray:
    """(S, 40, 50) maps with a wall each (one map for every row if shared)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((S, H_MAP, W_MAP), np.float32)
    for s in range(S):
        r, c = rng.integers(6, 30), rng.integers(4, 26)
        data[s, r:r + 3, c:c + 20] = 1.0
    if shared:
        data[:] = data[0]
    return data


def _poses(seed: int) -> np.ndarray:
    """Corners and edges of the 2.5 x 2 m map (its patches clamp there), a
    pose on its wall's row and interior ones."""
    rng = np.random.default_rng(seed)
    lx, ly = W_MAP * RES, H_MAP * RES
    xy = [(0.0, 0.0), (lx, ly), (0.001, ly - 0.001), (lx - 0.02, 0.01), (lx / 2, 0.0),
          (0.0, ly / 2), (lx, ly / 3)]
    while len(xy) < S:
        xy.append(tuple(rng.uniform(0.2, [lx - 0.2, ly - 0.2])))
    th = rng.uniform(-np.pi, np.pi, (S, 1))
    return np.concatenate([np.asarray(xy), th], axis=1).astype(np.float32)


HISTORY = {"drawn": dict(buffer_batch=8), "full_ring": dict(buffer_batch=None),
           "accumulate": dict(history="accumulate")}


def _case(model, history, safety, shared, seed=3):
    """A configuration, the engine on the CPU, its world, targets and first
    scenarios."""
    cfg = default_config(model).replace(
        num_basis=5, horizon=12, buffer_capacity=32, enable_safety=safety, shared_maps=shared,
        shared_history_draw=shared, orbit_window=2, **HISTORY[history])
    eng = Engine(cfg, device="cpu")
    world = eng.prepare_world(GridMap(torch.from_numpy(_maps(shared, seed)), torch.zeros(S, 2),
                                      torch.full((S,), RES)))
    rng = np.random.default_rng(seed)
    gmm = GaussianMixture.create(
        rng.uniform(0.3, 2.0, (S, 2, 2)).astype(np.float32),
        np.tile((0.15 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)))
    phik = eng.phik_from_gmm(gmm, Domain.create(0.0, 0.0, W_MAP * RES, H_MAP * RES))
    return cfg, eng, world, phik, eng.init_scenarios(_poses(seed))


def _composed_step(ctrl, state, x, vb, phik, world):
    """The step composed of plain functions: the patch extracted around the
    pose, the descent of plain torch, the ``ck_sum`` append, validation +
    DWA on the patch's central crop."""
    cfg, model, K = ctrl.config, ctrl.model, ctrl.config.num_basis
    domain = world.domain
    lam = basis.lambda_weights(K, device=x.device)
    hk = basis.hk_norm(K, domain.lengths)
    patch = extract_patch(world.dist, x[:, :2], cfg.patch_cells)
    x = x.contiguous()
    mode = history_mode(cfg, fused=False)
    pre = glue_pre(cfg, mode, state.rng, state.buffer, state.U, x, domain, None,
                   state.hist_count, state.ck_sum)
    if mode in ("full", "accumulate"):
        hist_sum, n_hist = history_sums(cfg, state, domain, hk)
    else:
        hist_sum, n_hist = drawn_history_sums(pre.hist, pre.nh, K, domain, hk), pre.nh
    U_new, metric, bcost = descent(cfg, model, x, pre.U, hist_sum, n_hist, phik, domain, patch,
                                   lam, hk)
    safety = None
    if cfg.enable_safety:
        code, u_dwa, feas = safety_on_crop(cfg, model, x, vb.contiguous(),
                                           U_new[:, 0].contiguous(), domain,
                                           patch.center_crop(cfg.safety_patch_cells))
        safety = (code, u_dwa, feas.to(torch.int32))
    Cnx, Cny = basis.cos_tables(x[:, None, :2], K, domain)
    ck_sum = state.ck_sum + basis.coefficients_cos(Cnx, Cny, torch.ones_like(x[:, :1]), hk)
    return finish_tick(cfg, state, x, U_new, safety, ck_sum, metric, bcost, pre.orbiting)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _leaves(v)]


@pytest.mark.parametrize("shared", [True, False], ids=["shared_map", "own_maps"])
@pytest.mark.parametrize("safety", [True, False], ids=["safety", "nosafety"])
@pytest.mark.parametrize("history", list(HISTORY))
@pytest.mark.parametrize("model", ["cart", "omni"])
def test_step_equals_composed_step_bit_for_bit(model, history, safety, shared):
    """TICKS chained ticks: each equal, leaf for leaf, to the composed step
    from the same state (the new state, u and every diagnostic)."""
    cfg, eng, world, phik, sc = _case(model, history, safety, shared)
    ctrl = eng.controller
    state, x, vb = sc.state, sc.x, sc.vb
    dwa = 0
    for _ in range(TICKS):
        got = ctrl.step(state, x, vb, phik, world)
        ref = _composed_step(ctrl, state, x, vb, phik, world)
        for a, b in zip(_leaves(got), _leaves(ref), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state, u, diag = got
        dwa += int(diag.dwa_active.sum())
        x = rollout(ctrl.model, x, u[:, None, :], cfg.dt)[:, -1]
        vb = ctrl.model.twist(u)
    assert torch.isfinite(state.U).all() and state.hist_count.eq(TICKS).all()
    if not safety:
        assert dwa == 0


def test_step_drives_the_fused_route(monkeypatch):
    """The step goes through ``fused_solve`` and ``fused_safety_map`` (the
    dispatchers of K1 and of k1_safety reading the crop from the map), once
    each a tick, the latter with the patch starts, the map and the descent's
    controls; its plain version gathers the crop at the patch start plus
    (P - Pc) // 2."""
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk

    cfg, eng, world, phik, sc = _case("omni", "drawn", True, False)
    seen = []
    solve, safety, on_crop = sk.fused_solve, sk.fused_safety_map, sk.fused_safety_plain

    def spy_solve(c, inp):
        seen.append(("solve", inp.pstart.clone(), inp.dist))
        return solve(c, inp)

    def spy_safety(c, x, vb, U_new, dist, pstart, *rest):
        seen.append(("safety", pstart.clone(), dist, tuple(U_new.shape)))
        return safety(c, x, vb, U_new, dist, pstart, *rest)

    def spy_crop(c, x, vb, u0, crop, cstart, *rest):
        seen.append(("crop", cstart.clone(), tuple(crop.shape)))
        return on_crop(c, x, vb, u0, crop, cstart, *rest)

    monkeypatch.setattr(sk, "fused_solve", spy_solve)
    monkeypatch.setattr(sk, "fused_safety_map", spy_safety)
    monkeypatch.setattr(sk, "fused_safety_plain", spy_crop)
    eng.controller.step(sc.state, sc.x, sc.vb, phik, world)
    (k1, ps, d1), (k, ps2, d2, ushape), (c, cs, shape) = seen
    P = min(cfg.patch_cells, H_MAP, W_MAP)
    Pc = min(cfg.safety_patch_cells, P)
    assert (k1, k, c, shape) == ("solve", "safety", "crop", (S, Pc, Pc))
    assert torch.equal(ps2, ps) and d2 is d1 and ushape == (S, cfg.horizon, cfg.nu)
    assert torch.equal(cs, ps + (P - Pc) // 2) and cs.dtype == torch.int32


def test_step_matches_jax_vmapped_step():
    """One tick from a state the JAX engine reached in 3 ticks (cart,
    per-scenario maps and draws, safety on) against ``jax.vmap`` of the JAX
    package's ``ErgodicController.step``."""
    opts = dict(num_basis=5, horizon=12, buffer_capacity=32, buffer_batch=8)
    data = _maps(False, 5)
    x0 = _poses(5)
    rng = np.random.default_rng(5)
    gmm = (rng.uniform(0.3, 2.0, (S, 2, 2)).astype(np.float32),
           np.tile((0.15 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
           np.ones((S, 2), np.float32))
    jcfg = j_default_config("cart").replace(use_fused_solve=False, use_pallas=False, **opts)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.asarray(data), jnp.zeros((S, 2)), jnp.full((S,), RES)))
    jphik = je.phik_from_gmm(jtarget.GaussianMixture.create(*gmm),
                             JDomain.create(0.0, 0.0, W_MAP * RES, H_MAP * RES))
    jsc = je.explore(je.init_scenarios(x0), jphik, jw, 3).scenarios
    ref_state, ref_u, ref_diag = jax.tree.map(np.asarray, jax.vmap(je.controller.step)(
        jsc.state, jsc.x, jsc.vb, jphik, jw))

    eng = Engine(default_config("cart").replace(**opts), device="cpu")
    sc = interop.scenarios_from_numpy(jax.tree.map(np.asarray, jsc), device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    state, u, diag = eng.controller.step(sc.state, sc.x, sc.vb,
                                         torch.from_numpy(np.array(jphik)), world)
    np.testing.assert_allclose(state.U.numpy(), ref_state.U, rtol=0.0, atol=5e-5)
    np.testing.assert_allclose(u.numpy(), ref_u, rtol=0.0, atol=5e-5)
    np.testing.assert_allclose(diag.ergodic_metric.numpy(), ref_diag.ergodic_metric, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(diag.collision_code.numpy(), ref_diag.collision_code)
    np.testing.assert_array_equal(diag.dwa_active.numpy(), ref_diag.dwa_active)
    np.testing.assert_array_equal(diag.dwa_feasible.numpy(), ref_diag.dwa_feasible)
