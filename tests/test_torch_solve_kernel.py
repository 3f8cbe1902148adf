"""K1's module: the port's replan_batched_fused (plain version of the kernel,
on CPU tensors) against the JAX replan_batched_fused running its Pallas
kernel in interpret mode, one tick with the in-kernel GMM refresh (cart).

Tolerances are those of tests/test_solve_kernel.py: controls atol 5e-5,
metric rtol 1e-5 / atol 1e-7, ck_sum rtol 1e-5 / atol 5e-6 (the JAX kernel
builds cos(k theta) by Chebyshev recurrence, the port directly), codes and
DWA flags exact.
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
from ergodic_exploration_tpu.ops.solve_kernel import replan_batched_fused as j_replan_fused
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S = 8
OPTS = dict(num_basis=6, buffer_capacity=64, grid_samples=(30, 30), shared_maps=True,
            shared_history_draw=True)


def _case(seed=3):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(0.4, 2.6, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))],
                        axis=1).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    means = rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    return x0, data, means, covs, np.ones((S, 2), np.float32)


@pytest.fixture(scope="module")
def one_tick():
    """Both packages' fused tick from the same warm state (3 ticks of history)."""
    x0, data, means, covs, w = _case()
    jcfg = j_default_config("cart").replace(use_fused_solve=True, use_pallas=False, **OPTS)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                   jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    jg = jtarget.GaussianMixture.create(means, covs, w)
    jd = JDomain.create(0.0, 0.0, 3.0, 3.0)
    jsc = je.init_scenarios(x0)
    warm = JEngine(jcfg.replace(use_fused_solve=False))
    phik = warm.phik_from_gmm(jg, jd, jw)
    for _ in range(3):  # warm history through the vmapped controller
        jsc, _, _ = warm.replan(jsc, phik, jw)
    sc_np = jax.tree.map(np.asarray, jsc)
    model = je.controller.model
    st, u, dg = j_replan_fused(jcfg, model, jsc.state, jsc.x, jsc.vb, None, jw,
                               gmm=jg, domain=jd)
    ref = jax.tree.map(np.asarray, (st, u, dg))

    cfg = default_config("cart").replace(use_fused_solve=True, **OPTS)
    eng = Engine(cfg, device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    sc = interop.scenarios_from_numpy(sc_np, device="cpu")
    sk.K1.reset_launches()
    out = sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb, None, world,
                                  gmm=GaussianMixture.create(means, covs, w),
                                  domain=Domain.create(0.0, 0.0, 3.0, 3.0))
    return ref, interop.to_numpy(out), sum(sk.K1.launches.values())


def test_fused_tick_matches_jax_kernel(one_tick):
    (st_r, u_r, dg_r), (st, u, dg), _ = one_tick
    np.testing.assert_allclose(u, u_r, atol=5e-5)
    np.testing.assert_allclose(st.U, st_r.U, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dg.barrier_cost, dg_r.barrier_cost, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
    np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
    np.testing.assert_array_equal(dg.orbit_reset, dg_r.orbit_reset)
    np.testing.assert_allclose(st.ck_sum, st_r.ck_sum, rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(st.buffer.states, st_r.buffer.states, atol=1e-6)
    np.testing.assert_array_equal(st.rng, st_r.rng.astype(np.int64))


@pytest.mark.parametrize("shared_maps", [True, False], ids=["shared_map", "per_scenario_maps"])
def test_per_scenario_history_draws_reach_k1_as_positions(shared_maps):
    """Ring history with a sampled batch and per-scenario draws: the tick
    hands K1 the (S, nb, 2) drawn positions, not their sums, as the JAX tick
    hands them to its kernel (its ``nb > 0`` variant, here in interpret mode);
    one tick from a warm state agrees within the budgets above."""
    x0, data, means, covs, w = _case()
    opts = dict(OPTS, shared_maps=shared_maps, shared_history_draw=False, buffer_batch=24)
    jcfg = j_default_config("cart").replace(use_fused_solve=True, use_pallas=False, **opts)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
                                   jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    warm = JEngine(jcfg.replace(use_fused_solve=False))
    phik = warm.phik_from_gmm(jtarget.GaussianMixture.create(means, covs, w),
                              JDomain.create(0.0, 0.0, 3.0, 3.0), jw)
    jsc = je.init_scenarios(x0)
    for _ in range(3):
        jsc, _, _ = warm.replan(jsc, phik, jw)
    st_r, u_r, dg_r = jax.tree.map(np.asarray, j_replan_fused(
        jcfg, je.controller.model, jsc.state, jsc.x, jsc.vb, phik, jw))

    cfg = default_config("cart").replace(use_fused_solve=True, **opts)
    eng = Engine(cfg, device="cpu")
    world = interop.world_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    sc = interop.scenarios_from_numpy(jax.tree.map(np.asarray, jsc), device="cpu")
    tphik = torch.from_numpy(np.array(phik))
    inp, _, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, tphik, world)
    assert inp.hist.shape == (S, 24, 2) and inp.dist.dim() == (2 if shared_maps else 3)
    assert (inp.nh == 24.0).all()
    st, u, dg = interop.to_numpy(sk.replan_batched_fused(cfg, eng.model, sc.state, sc.x, sc.vb,
                                                         tphik, world))
    np.testing.assert_allclose(u, u_r, atol=5e-5)
    np.testing.assert_allclose(st.U, st_r.U, atol=5e-5)
    np.testing.assert_allclose(dg.ergodic_metric, dg_r.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dg.collision_code, dg_r.collision_code)
    np.testing.assert_array_equal(dg.dwa_active, dg_r.dwa_active)
    np.testing.assert_array_equal(st.rng, st_r.rng.astype(np.int64))
    # the shared draw and the full ring still reach K1 as (S, K^2) sums
    for other in (dict(shared_history_draw=True), dict(buffer_batch=None)):
        c2 = cfg.replace(**other)
        assert sk.fused_tick_inputs(c2, sc.state, sc.x, sc.vb, tphik, world)[0].hist.shape == (
            S, cfg.num_basis ** 2)


def test_launch_counter_stays_zero_on_cpu(one_tick):
    """CPU tensors go to the plain version: the kernel is never launched."""
    assert one_tick[2] == 0
    assert sum(sk.K1.launches.values()) == 0 and sk.K1.built is None


def test_kernel_params_mirror_the_c_struct():
    """The ctypes parameter block carries the float32 constants as the
    plain version rounds them."""
    cfg = default_config("omni")
    sp = sk.params_from_config(cfg, 40, (100, 100), 2, True)
    sps = sk.safety_params_from_config(cfg, 16)
    p = sk._c_params(sp, sps, S=7, Npad=10240)
    assert (p.S, p.K, p.nu, p.P, p.Pc, p.J, p.masked, p.model) == (7, 10, 4, 40, 16, 2, 1, 1)
    assert p.patch_hi == np.float32(40 - 1.001) and p.crop_hi == np.float32(16 - 1.001)
    assert p.tw_b == np.float32(0.25 * cfg.omni.wheel_radius / (cfg.omni.lx + cfg.omni.ly))
    assert list(p.r_inv) == [np.float32(1.0) / np.float32(0.001)] * 4
    assert (p.safety, p.nb) == (1, 0) and sk._c_params(sp, sps, 7, 0, False, 24).nb == 24
    assert [f[0] for f in sk._Buffers._fields_] == list(sk._BUFFERS)


def test_unported_variants_raise():
    """Tensors that lie neither on the CPU nor on a CUDA device raise in
    every variant's wrapper, and the kernel object itself refuses anything
    but CUDA tensors: nothing carries on with the plain version unasked."""
    cfg = default_config("cart")
    meta = torch.zeros(1, device="meta")
    inp = sk.K1Inputs(*([meta] * len(sk.K1Inputs._fields)))
    for fn in (sk.fused_solve_safety, sk.fused_solve):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(cfg, inp)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.fused_safety(cfg, *([meta] * 9))
    cpu = sk.K1Inputs(*([torch.zeros(1)] * len(sk.K1Inputs._fields)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.K1(cfg, cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.K1.safety(cfg, *([torch.zeros(1)] * 9))


def test_refresh_lattice_is_padded_to_the_chunk():
    cfg = default_config("cart").replace(grid_samples=(30, 30), num_basis=6)
    dom = Domain.create(0.0, 0.0, 3.0, 3.0)
    g = GaussianMixture.create(np.full((2, 1, 2), 1.5, np.float32),
                               np.tile(np.eye(2, dtype=np.float32)[None, None], (2, 1, 1, 1)))
    mask = torch.ones(2, 900)
    mask[:, :100] = 0.0
    r = sk.refresh_operands(cfg, g, dom, mask)
    assert r.pts.shape == (960, 2) and r.D.shape == (960, 36) and r.masked
    assert (r.D[900:] == 0).all() and (r.pts[900:] == sk.PAD_POINT).all()
    assert (r.D[:100] == 0).all()
    phik = sk.refresh_plain(r, torch.full((2, 2), 3.0)).view(2, 6, 6)
    assert torch.isfinite(phik).all()
