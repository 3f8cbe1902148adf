"""The application surface of the port: the configuration repairs, the
warm-up's persistent cache, the grid additions the node calls, the package
root, profiling, viz and the single-robot example (in process, as
tests/test_examples.py runs the JAX one)."""

import os
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.grid import GridMap as JGridMap
from ergodic_exploration_tpu_torch import config as tconfig
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.utils import cuda_build, profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- config


def test_validate_refuses_a_precision_other_than_fp32():
    assert j_default_config("cart").replace(precision="bf16").validate()  # the JAX package takes it
    with pytest.raises(ValueError, match="float32"):
        default_config("cart").replace(precision="bf16").validate()
    with pytest.raises(ValueError, match="precision"):
        tconfig.load_yaml_config({"precision": "bf16"})
    assert default_config("cart").precision == "fp32"


def test_loader_names_the_keys_it_drops():
    with pytest.warns(UserWarning, match="num_basiss") as rec:
        cfg = tconfig.load_yaml_config({"num_basiss": 4, "dwa": {"horizon": 3},
                                        "frequency": 10, "map_frame_id": "map"})
    assert len(rec) == 1  # one warning a call, naming every dropped key
    msg = str(rec[0].message)
    assert "'dwa'" in msg and "frequency" not in msg and "map_frame_id" not in msg
    assert cfg.num_basis == default_config("cart").num_basis


@pytest.mark.parametrize("name", ["cart.yaml", "omni.yaml"])
def test_repo_configs_load_without_a_warning(name):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tconfig.load_yaml_config(ROOT / "config" / name)
        tconfig.load_yaml_config({"frequency": 10, "cmd_vel_topic": "/cmd_vel"})


# ---------------------------------------------------------------- warmup


def test_warmup_takes_a_persistent_cache(tmp_path):
    """Engine.warmup accepts the JAX signature's persistent_cache and returns
    the JAX stage names; on the CPU the library directory stays as it was."""
    from ergodic_exploration_tpu_torch.engine import Engine

    cfg = default_config("cart").replace(num_basis=6, horizon=8, buffer_capacity=32,
                                         grid_samples=(20, 20))
    before = cuda_build.BUILD_DIR
    t = Engine(cfg, device="cpu").warmup(4, Domain.create(0.0, 0.0, 2.0, 2.0),
                                         map_shape=(20, 20), gmm_components=1, n_ticks=(3,),
                                         persistent_cache=str(tmp_path / "libs"))
    for stage in ("init_scenarios", "prepare_world", "phik_from_grid", "phik_from_gmm",
                  "replan", "replan_refresh", "explore_3"):
        assert stage in t and t[stage] >= 0.0
    assert cuda_build.BUILD_DIR == before and not (tmp_path / "libs").exists()


def test_build_dir_is_settable(tmp_path):
    try:
        assert cuda_build.set_build_dir(tmp_path) == tmp_path.resolve()
        assert cuda_build.BUILD_DIR == tmp_path.resolve()
    finally:
        assert cuda_build.set_build_dir() == cuda_build.DEFAULT_BUILD_DIR
    assert cuda_build.DEFAULT_BUILD_DIR == ROOT / "build" / "kernels"


# ---------------------------------------------------------------- grid


def test_grid_additions_match_jax():
    rng = np.random.default_rng(7)
    raw = rng.integers(-1, 101, (12, 15)).astype(np.int8)
    g, jg = GridMap.from_ros(raw, 0.3, -0.2, 0.05), JGridMap.from_ros(raw, 0.3, -0.2, 0.05)
    np.testing.assert_array_equal(g.data.numpy(), np.asarray(jg.data))
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(g.known().numpy(), np.asarray(jg.known()))
    for thr in (0.2, 0.5):
        np.testing.assert_array_equal(g.free(thr).numpy(), np.asarray(jg.free(thr)))
    idx = rng.integers(0, 12, (9, 2))
    np.testing.assert_array_equal(g.grid_to_world(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jg.grid_to_world(jnp.asarray(idx))))


# ---------------------------------------------------------------- package


def test_package_root_exports_the_application():
    import ergodic_exploration_tpu_torch as pkg

    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.node import ExplorationNode

    assert pkg.ExplorationNode is ExplorationNode and pkg.Engine is Engine
    assert pkg.Domain is Domain and pkg.GridMap is GridMap
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None
    from ergodic_exploration_tpu_torch.engine import make_mesh, make_scenario_mesh

    assert pkg.make_mesh is make_mesh and pkg.make_scenario_mesh is make_scenario_mesh
    with pytest.raises(AttributeError):
        pkg.not_an_export  # noqa: B018


# ---------------------------------------------------------------- profiling


def test_profiling_times_a_chain_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)

    def step(x, m):
        return (torch.tanh(x @ m),)

    x0 = torch.randn(64, 64)
    assert profiling.force_completion((x0, None)) == pytest.approx(float(x0.sum()))
    t = profiling.time_chained(step, (x0, a), iters=5)
    assert 0.0 < t < 1.0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        step(x0, a)
    assert prof is not None and (tmp_path / "tr" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------- viz and the example


def test_save_exploration_figure_from_tensors(tmp_path):
    from types import SimpleNamespace

    from ergodic_exploration_tpu_torch import viz
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    T, S = 6, 2
    out = SimpleNamespace(trajectory=torch.rand(T, S, 3) * 2,
                          diag=SimpleNamespace(ergodic_metric=torch.rand(T, S)))
    grid = GridMap.create(np.eye(40, dtype=np.float32), 0.0, 0.0, 0.05)
    path = viz.save_exploration_figure(
        str(tmp_path / "f.png"), Domain.create(0.0, 0.0, 2.0, 2.0), out, scenario=1,
        grid=grid, phi=torch.rand(100), phi_shape=(10, 10),
        gmm=GaussianMixture.create([[1.0, 1.0]], [[0.1, 0.1]]))
    assert os.path.getsize(path) > 0


def test_single_robot_example_smoke(tmp_path, capsys, monkeypatch):
    import runpy
    import sys

    png = tmp_path / "sr.png"
    name = "ergodic_exploration_tpu_torch.examples.single_robot"
    monkeypatch.setattr(sys, "argv", [name, "--steps", "12", "--cpu", "--out", str(png)])
    runpy.run_module(name, run_name="__main__")
    out = capsys.readouterr().out
    assert "pose=" in out and "wrote" in out
    assert png.stat().st_size > 0
    from ergodic_exploration_tpu_torch.examples import single_robot

    assert single_robot.DEFAULT_OUT == ROOT / "build" / "single_robot_torch.png"
