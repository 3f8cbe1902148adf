"""Scale-out of the port on the CPU: 4 gloo ranks against the JAX package's
meshes over its 8 virtual CPU devices.

One module fixture spawns the ranks of tests/torch_parallel_worker.py once
(a file store under tmp_path, no ports); every result comes back as ``.npz``
and each test computes its JAX side here, on the same numpy cases. Budgets:
controls and warm starts 5e-5, metric rtol 1e-5, codes and DWA flags equal
(tests/test_solve_kernel.py); the sample-sharded GMM target 2.2e-6
(ops/pallas_kernels.py:12); the MI target rtol 2e-4 / atol 2e-5
(tests/test_mi_kernel.py:53) and the MI tick as tests/test_engine.py:597
holds it; trajectories 1e-5 (tests/test_multihost.py:90-93). The JAX side
is its vmapped path (``use_fused_solve=False``, ``use_pallas=False``), which
its own tests pin to the Pallas kernels.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.engine import make_mesh as j_make_mesh
from ergodic_exploration_tpu.engine import make_scenario_mesh as j_make_scenario_mesh
from ergodic_exploration_tpu.grid import Domain as JDomain
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu.ops import target as jtarget
from ergodic_exploration_tpu.ops.integrator import rollout as j_rollout
from torch_parallel_worker import S, TICKS_A, TICKS_EXPLORE, TICKS_RESUME, tier1_case

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
RANKS = 4
DOM = JDomain.create(0.0, 0.0, 2.0, 2.0)
GMM_TOL = dict(rtol=0.0, atol=2.2e-6)
MI_TOL = dict(rtol=2e-4, atol=2e-5)


def spawn_ranks(run: str, n: int, out, timeout: int):
    """Run ``n`` ranks of the worker's ``run`` to their end; fail with their
    output if one fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, run, str(r), str(n), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{run}: ranks timed out:\n" + "\n".join(outs))
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{run}: rank {r} failed:\n{o}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank 0's gathered results, each rank's own records, the output dir)."""
    out = tmp_path_factory.mktemp("torch_parallel")
    spawn_ranks("tier1", RANKS, out, timeout=240)
    mine = [dict(np.load(out / f"tier1_rank{r}.npz")) for r in range(RANKS)]
    return dict(np.load(out / "tier1.npz")), mine, out


def _jcfg(**kw):
    return j_default_config("cart").replace(num_basis=5, horizon=6, buffer_capacity=16,
                                            grid_samples=(16, 16), use_fused_solve=False,
                                            use_pallas=False, **kw)


def _jgrids(data, res):
    n = data.shape[0]
    return JGridMap(jnp.asarray(data), jnp.zeros((n, 2), jnp.float32),
                    jnp.full((n,), res, jnp.float32))


def _advance(eng):
    m, dt = eng.controller.model, eng.config.dt
    return jax.jit(lambda sc, u: sc._replace(
        x=jax.vmap(lambda x, uu: j_rollout(m, x, uu[None, :], dt)[-1])(sc.x, u),
        vb=m.twist(u)))


@pytest.fixture(scope="module")
def jax_one_kernel():
    """The JAX ticks of the scenario-mesh leg: on make_scenario_mesh(4) and
    unsharded."""
    case = tier1_case()
    cfg = _jcfg(shared_maps=True, shared_history_draw=True)
    runs = {}
    for name, mesh in (("mesh (4,)", j_make_scenario_mesh(RANKS)), ("unsharded", None)):
        eng = JEngine(cfg, mesh=mesh)
        world = eng.prepare_world(_jgrids(np.repeat(case["wall"][:1], S, 0), 0.1))
        gmm = eng.shard_scenarios(jtarget.GaussianMixture.create(*case["gmm"]))
        sc, adv, ticks = eng.init_scenarios(case["x0"]), _advance(eng), []
        for _ in range(TICKS_A):
            sc, u, dg = eng.replan_refresh(sc, gmm, DOM, world)
            ticks.append(jax.tree.map(np.asarray, (u, dg, sc.state.U)))
            sc = adv(sc, u)
        runs[name] = ticks
    return runs


@pytest.mark.parametrize("tick", range(TICKS_A))
@pytest.mark.parametrize("jax_run", ["mesh (4,)", "unsharded"])
def test_scenario_mesh_one_kernel_tick_matches_jax(ranks, jax_one_kernel, jax_run, tick):
    got, mine, _ = ranks
    u, dg, U = jax_one_kernel[jax_run][tick]
    g = {k[len(f"a{tick}_"):]: v for k, v in got.items() if k.startswith(f"a{tick}_")}
    np.testing.assert_allclose(g["u"], u, atol=5e-5)
    np.testing.assert_allclose(g["U"], U, atol=5e-5)
    np.testing.assert_allclose(g["ergodic_metric"], dg.ergodic_metric, rtol=1e-5, atol=1e-7)
    for flag in ("collision_code", "dwa_active", "dwa_feasible", "orbit_reset", "diverged"):
        np.testing.assert_array_equal(g[flag], getattr(dg, flag), err_msg=flag)
    assert [int(m["a_rows"][0]) for m in mine] == [S // RANKS] * RANKS
    assert all("engine.shard_scenarios" in str(m["a_global_input"]) for m in mine)


def _jax_explore_case():
    case = tier1_case()
    eng = JEngine(_jcfg())
    world = eng.prepare_world(_jgrids(case["wall"], 0.1))
    phik = eng.phik_from_gmm(jtarget.GaussianMixture.create(*case["gmm"]), DOM, world)
    return eng, world, phik, case


def test_explore_on_the_scenario_mesh_matches_jax(ranks):
    got, _, _ = ranks
    eng, world, phik, case = _jax_explore_case()
    out = eng.explore(eng.init_scenarios(case["x0"]), phik, world, TICKS_EXPLORE)
    np.testing.assert_allclose(got["explore_traj"], np.asarray(out.trajectory), atol=1e-5,
                               rtol=1e-5)


def test_collective_checkpoint_cross_loads_into_jax(ranks):
    got, mine, out = ranks
    assert all(bool(m["ck_reload_equal"][0]) for m in mine)  # each rank's rows, bit for bit
    eng, world, phik, _ = _jax_explore_case()
    sc = eng.load_checkpoint(str(out / "tier1_ck.npz"))
    np.testing.assert_array_equal(np.asarray(sc.x), got["explore_traj"][-1])
    resumed = eng.explore(sc, phik, world, TICKS_RESUME)
    np.testing.assert_allclose(got["resume_traj"], np.asarray(resumed.trajectory), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_2x2():
    return JEngine(_jcfg(), mesh=j_make_mesh(2, 2))


@pytest.mark.parametrize("variant", ["unmasked", "masked", "degenerate"])
def test_sample_sharded_gmm_target_matches_jax(ranks, jax_2x2, variant):
    got, _, _ = ranks
    case = tier1_case()
    eng = jax_2x2
    if variant == "unmasked":
        ref = eng.phik_from_gmm(jtarget.GaussianMixture.create(*case["gmm"]), DOM)
    elif variant == "masked":
        ref = eng.phik_from_gmm(jtarget.GaussianMixture.create(*case["gmm"]), DOM,
                                eng.prepare_world(_jgrids(case["walls"], 0.1)))
    else:
        ref = eng.phik_from_gmm(jtarget.GaussianMixture.create(*case["gmm_far"]), DOM,
                                eng.prepare_world(_jgrids(case["degen"], 0.1)))
        # the fallback is a real distribution where the mask is not empty
        assert abs(float(np.asarray(ref)[0, 0, 0])) > 0.1
    np.testing.assert_allclose(got[f"phik_{variant}"], np.asarray(ref), **GMM_TOL)


def test_sample_sharded_gmm_tick_matches_jax(ranks, jax_2x2):
    got, _, _ = ranks
    case = tier1_case()
    eng = jax_2x2
    world = eng.prepare_world(_jgrids(case["walls"], 0.1))
    _, u, dg = eng.replan_refresh(eng.init_scenarios(case["x0"]),
                                  jtarget.GaussianMixture.create(*case["gmm"]), DOM, world)
    np.testing.assert_allclose(got["gmm_tick_u"], np.asarray(u), atol=5e-5)
    np.testing.assert_allclose(got["gmm_tick_metric"], np.asarray(dg.ergodic_metric),
                               rtol=1e-5, atol=1e-7)


def test_sample_sharded_mi_target_and_tick_match_jax(ranks, jax_2x2):
    got, _, _ = ranks
    case = tier1_case()
    eng = jax_2x2
    grids = _jgrids(case["beliefs"], 0.05)
    np.testing.assert_allclose(got["phik_mi"], np.asarray(eng.phik_from_grid(grids, 2)),
                               **MI_TOL)
    _, u, dg = eng.replan_refresh_mi(eng.init_scenarios(case["x0"]), grids,
                                     eng.prepare_world(grids), sensor_radius_cells=2,
                                     domain=DOM)
    np.testing.assert_allclose(got["mi_tick_u"], np.asarray(u), **MI_TOL)
    np.testing.assert_allclose(got["mi_tick_metric"], np.asarray(dg.ergodic_metric), rtol=1e-4)


def test_process_scenario_slice_on_every_rank(ranks):
    _, mine, _ = ranks
    per = S // RANKS
    for r, m in enumerate(mine):
        assert tuple(m["slice_world"]) == (r * per, (r + 1) * per)
        # (2, 2): rank r holds scenario coordinate r // 2, half the batch
        assert tuple(m["slice_mesh2"]) == ((r // 2) * S // 2, (r // 2 + 1) * S // 2)
        assert str(m["slice_6"]) == "scenario count 6 not divisible by 4 hosts"


def test_make_mesh_refuses_a_world_of_another_size(ranks):
    _, mine, _ = ranks
    for m in mine:
        assert str(m["mesh_small"]) == "need 8 devices, have 4"
        for name in ("mesh_large", "scenario_mesh_large"):
            assert str(m[name]).startswith("need 2 devices, have 4: a rank outside the mesh")


def test_warmup_and_the_mapping_loop_on_the_scenario_mesh(ranks):
    """``warmup`` (global S) and ``explore_mapping_fused`` (the truth laid out
    with ``shard_scenarios``) on each rank's slice, the loop against the
    unsharded engine of the same rank's process: beliefs equal, poses within
    1e-5."""
    _, mine, _ = ranks
    for m in mine:
        assert {"init_scenarios", "prepare_world", "phik_from_grid", "replan_refresh_mi",
                "phik_from_gmm", "replan", "replan_refresh", "explore_2"} <= set(
                    m["warmup_stages"].tolist())
        assert bool(m["mapping_belief_equal"][0])
        assert float(m["mapping_traj_diff"][0]) <= 1e-5


def test_process_scenario_slice_without_a_process_group():
    from ergodic_exploration_tpu_torch.parallel import process_scenario_slice

    assert process_scenario_slice(8) == (0, 8)


@pytest.mark.slow
def test_two_rank_explore_checkpoint_resume_matches_single(tmp_path):
    """The twin of tests/test_multihost.py: 2 ranks, each feeding only its
    own scenarios, explore 10 ticks, a collective checkpoint and a resume,
    against the JAX engine in this process."""
    spawn_ranks("twin", 2, tmp_path, timeout=420)
    got = np.load(tmp_path / "twin.npz")
    eng, world, phik, case = _jax_explore_case()
    out = eng.explore(eng.init_scenarios(case["x0"]), phik, world, 10)
    np.testing.assert_allclose(got["trajectory"], np.asarray(out.trajectory), atol=1e-5,
                               rtol=1e-5)


def test_mesh_engine_refusals_without_a_process_group():
    """What an engine on a mesh refuses before any collective: a CUDA mesh
    where there is no card, local leaves of two scenario counts, and a
    per-tick input that is not this rank's rows. A stand-in mesh of one rank
    (no process group: the rank holds every row) is enough for these."""
    from types import SimpleNamespace

    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain

    card_mesh = SimpleNamespace(mesh_dim_names=("scenario",), device_type="cuda")
    if torch.cuda.is_available():
        assert Engine(default_config("cart"), mesh=card_mesh).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(default_config("cart"), mesh=card_mesh)
    cpu_mesh = SimpleNamespace(mesh_dim_names=("scenario",), device_type="cpu")
    with pytest.raises(ValueError, match="is not the mesh's"):
        Engine(default_config("cart"), device="cuda", mesh=cpu_mesh)
    eng = Engine(default_config("cart").replace(num_basis=4, grid_samples=(8, 8)), mesh=cpu_mesh)
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError, match="disagree on the scenario count"):
        eng.shard_scenarios_from_local((np.zeros((2, 3)), np.zeros((3, 3))))
    sc = eng.init_scenarios(np.zeros((4, 3), np.float32))
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    world = eng.empty_world(dom, 4)
    with pytest.raises(ValueError, match="phik leads with 2 scenarios where this rank holds 4"):
        eng.replan(sc, torch.zeros(2, 4, 4), world)
