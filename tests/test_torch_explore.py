"""The quick-start loop end to end on the CPU: ``Engine.explore`` of the port
against the JAX engine's vmapped closed loop (``use_fused_solve=False``), 3
ticks on DISTINCT per-scenario maps, cart and omni, safety on and off.

The port runs it twice: with ``use_fused_solve=True`` (K1's per-scenario-map
variant, and ``fused_solve`` when safety is off; their plain versions on CPU
tensors) and with ``use_fused_solve=False`` (the eager controller step whose
safety stage is ``fused_safety``). Budgets of tests/test_solve_kernel.py:
controls and trajectory atol 5e-5, metric rtol 1e-5 / atol 1e-7, collision
codes and DWA flags equal. Also here: ``fused_safety``'s plain version against
the JAX Pallas kernel ``fused_safety`` in interpret mode, and ``empty_world``.

A 20 x 20 lattice on 60 x 60 maps of 0.05 m puts every lattice point on a
cell centre, so no free-mask lookup sits on a rounding tie.
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
from ergodic_exploration_tpu.ops import solve_kernel as jsk
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.engine import Engine, ExploreOutput
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
from ergodic_exploration_tpu_torch.ops.patch import extract_patch
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils import interop

torch.set_num_threads(2)
S, T = 8, 3
OPTS = dict(num_basis=6, buffer_capacity=64, grid_samples=(20, 20))


def _case(seed=11):
    """Distinct maps (a wall at a per-scenario place), start poses clear of
    them, two-component GMMs."""
    rng = np.random.default_rng(seed)
    data = np.zeros((S, 60, 60), np.float32)
    x0 = np.zeros((S, 3), np.float32)
    for s in range(S):
        r, c = rng.integers(12, 44), rng.integers(6, 30)
        data[s, r:r + 4, c:c + 24] = 1.0
        while True:
            p = rng.uniform(0.4, 2.6, 2)
            wall_y, wall_x = (r + 2) * 0.05, (c + 12) * 0.05
            if abs(p[1] - wall_y) > 0.3 or abs(p[0] - wall_x) > 0.9:
                break
        # every other scenario faces its wall from close by: 0.28 m from the
        # wall's middle predicts a crash (DWA takes over), 0.32 m only warns
        if s % 2 == 0:
            x0[s] = [wall_x, wall_y - (0.28 if s % 4 == 0 else 0.32), np.pi / 2]
        else:
            x0[s] = [p[0], p[1], rng.uniform(-np.pi, np.pi)]
    gmm = (rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32),
           np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
           np.ones((S, 2), np.float32))
    return x0, data, gmm


@pytest.fixture(scope="module", params=[("cart", True), ("cart", False), ("omni", True),
                                        ("omni", False)],
                ids=lambda p: f"{p[0]}-{'safety' if p[1] else 'nosafety'}")
def jax_run(request):
    model, safety = request.param
    x0, data, gmm = _case()
    jcfg = j_default_config(model).replace(use_fused_solve=False, use_pallas=False,
                                           enable_safety=safety, **OPTS)
    je = JEngine(jcfg)
    jw = je.prepare_world(JGridMap(jnp.asarray(data), jnp.zeros((S, 2)), jnp.full((S,), 0.05)))
    phik = je.phik_from_gmm(jtarget.GaussianMixture.create(*gmm),
                            JDomain.create(0.0, 0.0, 3.0, 3.0), jw)
    out = je.explore(je.init_scenarios(x0), phik, jw, T)
    return model, safety, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("fused", [True, False], ids=["k1", "eager"])
def test_explore_matches_jax_engine(jax_run, fused):
    model, safety, ref = jax_run
    x0, data, gmm = _case()
    cfg = default_config(model).replace(use_fused_solve=fused, enable_safety=safety, **OPTS)
    eng = Engine(cfg, device="cpu")
    world = eng.prepare_world(GridMap(torch.from_numpy(data), torch.zeros(S, 2),
                                      torch.full((S,), 0.05)))
    phik = eng.phik_from_gmm(GaussianMixture.create(*gmm), Domain.create(0.0, 0.0, 3.0, 3.0),
                             world)
    sk.K1.reset_launches()
    out = eng.explore(eng.init_scenarios(x0), phik, world, T)
    assert isinstance(out, ExploreOutput)
    assert sum(sk.K1.launches.values()) == 0  # CPU tensors: plain versions only
    got = interop.to_numpy(out)
    assert got.trajectory.shape == (T, S, 3) and got.controls.shape == (T, S, cfg.nu)
    for leaf, rleaf in zip(got.diag, ref.diag):
        assert leaf.shape == (T, S) and leaf.dtype == rleaf.dtype
    np.testing.assert_allclose(got.controls, ref.controls, atol=5e-5)
    np.testing.assert_allclose(got.trajectory, ref.trajectory, atol=5e-5)
    np.testing.assert_allclose(got.ergodic_metric, ref.diag.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.diag.barrier_cost, ref.diag.barrier_cost, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got.diag.collision_code, ref.diag.collision_code)
    np.testing.assert_array_equal(got.diag.dwa_active, ref.diag.dwa_active)
    np.testing.assert_array_equal(got.diag.diverged, ref.diag.diverged)
    np.testing.assert_allclose(got.scenarios.state.U, ref.scenarios.state.U, atol=5e-5)
    np.testing.assert_allclose(got.scenarios.x, ref.scenarios.x, atol=5e-5)
    np.testing.assert_array_equal(got.scenarios.state.rng,
                                  ref.scenarios.state.rng.astype(np.int64))
    if safety and model == "cart":  # the case exercises every code and the fallback
        assert set(np.unique(got.diag.collision_code)) == {0, 1, 2} and got.diag.dwa_active.any()


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_fused_safety_plain_matches_pallas_interpret(model):
    """The standalone safety stage on a crop given as data: codes, feasible
    flags and DWA controls equal the JAX Pallas kernel's in interpret mode."""
    x0, data, _ = _case()
    rng = np.random.default_rng(2)
    cfg = default_config(model).replace(**OPTS)
    eng = Engine(cfg, device="cpu")
    world = eng.prepare_world(GridMap(torch.from_numpy(data), torch.zeros(S, 2),
                                      torch.full((S,), 0.05)))
    x = torch.from_numpy(x0)
    fwd = eng.model.from_twist(torch.tensor([[0.6, 0.0, 0.0]]).expand(S, 3))
    u0 = (fwd + torch.from_numpy(rng.normal(0, 1.0, (S, cfg.nu)).astype(np.float32))).contiguous()
    vb = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, 3)).astype(np.float32))
    crop = extract_patch(world.dist, x[:, :2], cfg.patch_cells).center_crop(
        cfg.safety_patch_cells)
    args = (x, vb, u0, crop.dist.contiguous(), crop.start.to(torch.int32), crop.origin,
            crop.resolution, world.domain.origin, world.domain.lengths)
    code, u_dwa, feas = sk.fused_safety(cfg, *args)
    assert code.dtype == torch.int32 and feas.dtype == torch.int32

    jcfg = j_default_config(model).replace(**OPTS)
    sps = jsk.safety_params_from_config(jcfg, cfg.safety_patch_cells)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jcode, jud, jfeas = jsk.fused_safety(
        sps, j(x).T, j(vb).T, j(u0).T, jnp.transpose(j(crop.dist), (1, 2, 0)),
        j(crop.start.to(torch.float32)).T, j(crop.origin).T, j(crop.resolution)[None, :],
        j(world.domain.origin).T, j(world.domain.lengths).T, interpret=True)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode)[0])
    np.testing.assert_array_equal(feas.numpy(), np.asarray(jfeas)[0])
    np.testing.assert_allclose(u_dwa.numpy(), np.asarray(jud).T, atol=1e-6)
    assert (code.numpy() >= 2).any() and (code.numpy() < 2).any()


def test_empty_world_matches_jax():
    dom_j, dom_t = JDomain.create(0.0, 0.0, 2.0, 2.0), Domain.create(0.0, 0.0, 2.0, 2.0)
    ref = jax.tree.map(np.asarray, JEngine(j_default_config("cart")).empty_world(dom_j, 5))
    got = interop.to_numpy(Engine(default_config("cart"), device="cpu").empty_world(dom_t, 5))
    assert got.free_mask is None and ref.free_mask is None
    for a, b in zip(list(got.domain) + list(got.dist), list(ref.domain) + list(ref.dist)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shared", [False, True], ids=["per_scenario_maps", "shared_map"])
def test_fused_solve_on_empty_world_matches_eager(shared):
    """BASELINE config 1's tick (empty world, one Gaussian, safety off): the
    port's fused_solve variants against the JAX engine's eager (vmapped)
    controller step, starts at the boundary included (FAR plateau: finite
    barrier, zero map gradient)."""
    x0 = np.array([[0.08, 0.1, 2.5], [1.9, 1.92, -0.5], [1.0, 0.05, 3.0], [0.1, 1.9, 0.1],
                   [0.5, 0.5, 1.0], [1.5, 1.5, -2.0], [1.0, 1.0, 0.0], [0.2, 1.0, -1.0]],
                  np.float32)
    means = np.tile(np.array([[1.0, 1.0]], np.float32)[None], (S, 1, 1))
    covs = np.tile((0.15 * np.eye(2, dtype=np.float32))[None, None], (S, 1, 1, 1))
    opts = dict(num_basis=5, buffer_capacity=32, enable_safety=False)

    je = JEngine(j_default_config("cart").replace(use_fused_solve=False, use_pallas=False,
                                                  **opts))
    jdom = JDomain.create(0.0, 0.0, 2.0, 2.0)
    jphik = je.phik_from_gmm(jtarget.GaussianMixture.create(means, covs), jdom)
    ref = jax.tree.map(np.asarray, je.explore(je.init_scenarios(x0), jphik,
                                              je.empty_world(jdom, S), 2))

    eng = Engine(default_config("cart").replace(use_fused_solve=True, shared_maps=shared,
                                                **opts), device="cpu")
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    world = eng.empty_world(dom, S)
    phik = eng.phik_from_gmm(GaussianMixture.create(means, covs), dom)
    got = interop.to_numpy(eng.explore(eng.init_scenarios(x0), phik, world, 2))
    np.testing.assert_allclose(got.controls, ref.controls, atol=5e-5)
    np.testing.assert_allclose(got.trajectory, ref.trajectory, atol=5e-5)
    np.testing.assert_allclose(got.ergodic_metric, ref.diag.ergodic_metric, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.diag.barrier_cost, ref.diag.barrier_cost, rtol=1e-5,
                               atol=1e-7)
    assert np.isfinite(got.diag.barrier_cost).all()
    assert not got.diag.dwa_active.any() and (got.diag.collision_code == 0).all()
