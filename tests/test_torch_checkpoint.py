"""Checkpoint, metrics and warmup of the port against the JAX package.

A checkpoint written by either package loads in the other (same .npz
format v2, same path keys); key, shape and version mismatches fail loudly;
``summarize`` gives the JAX package's numbers on the same diagnostics;
``warmup`` on the CPU returns its stages.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.config import default_config as j_default_config
from ergodic_exploration_tpu.controller import StepDiagnostics as JStepDiagnostics
from ergodic_exploration_tpu.engine import Engine as JEngine
from ergodic_exploration_tpu.utils import metrics as jmetrics
from ergodic_exploration_tpu_torch.config import default_config
from ergodic_exploration_tpu_torch.controller import StepDiagnostics
from ergodic_exploration_tpu_torch.engine import Engine, Scenarios
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.utils import checkpoint, interop, metrics

torch.set_num_threads(2)
S = 4
OPTS = dict(num_basis=5, buffer_capacity=16, grid_samples=(20, 20))


def _state_numpy(seed=1):
    """A JAX Scenarios with every leaf filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    je = JEngine(j_default_config("cart").replace(**OPTS))
    sc = je.init_scenarios(rng.uniform(0.2, 1.8, (S, 3)).astype(np.float32),
                           rng=jax.random.PRNGKey(7))
    sc = jax.tree.map(np.asarray, sc)

    def fill(a):
        if a.dtype == np.float32:
            return rng.normal(size=a.shape).astype(np.float32)
        if a.dtype == np.int32:
            return rng.integers(0, 16, a.shape).astype(np.int32)
        return a  # the uint32 key words stay as JAX made them

    return je, jax.tree.map(fill, sc)


def _assert_same(got: Scenarios, want: Scenarios):
    a, b = interop.to_numpy(got), interop.to_numpy(want)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    je, sc_np = _state_numpy()
    path = str(tmp_path / "jax.npz")
    je.save_checkpoint(path, sc_np)
    eng = Engine(default_config("cart").replace(**OPTS), device="cpu")
    got = eng.load_checkpoint(path)
    assert got.state.rng.dtype == torch.int64 and got.state.buffer.cursor.dtype == torch.int32
    _assert_same(got, interop.scenarios_from_numpy(sc_np, device="cpu"))


def test_port_checkpoint_loads_in_jax(tmp_path):
    je, sc_np = _state_numpy()
    eng = Engine(default_config("cart").replace(**OPTS), device="cpu")
    path = str(tmp_path / "port.npz")
    eng.save_checkpoint(path, interop.scenarios_from_numpy(sc_np, device="cpu"))
    back = jax.tree.map(np.asarray, je.load_checkpoint(path))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(sc_np)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
    assert meta["version"] == 2 and meta["keys"] == [
        ".state.U", ".state.buffer.states", ".state.buffer.cursor", ".state.buffer.count",
        ".state.ck_sum", ".state.hist_count", ".state.rng", ".x", ".vb"]
    assert meta["dtypes"][6] == "uint32"
    _assert_same(eng.load_checkpoint(path), interop.scenarios_from_numpy(sc_np, device="cpu"))


@pytest.mark.parametrize("fault", ["keys", "shape", "version", "no_meta"])
def test_checkpoint_mismatches_fail_loudly(tmp_path, fault):
    eng = Engine(default_config("cart").replace(**OPTS), device="cpu")
    sc = eng.init_scenarios(np.zeros((S, 3), np.float32))
    path = str(tmp_path / "c.npz")
    eng.save_checkpoint(path, sc)
    with np.load(path) as data:
        entries = {k: data[k] for k in data.files}
    meta = json.loads(str(entries.pop("__meta__")))
    like, match = sc, None
    if fault == "keys":  # a renamed field must not load into a same-shape leaf
        meta["keys"][7], meta["keys"][8] = meta["keys"][8], meta["keys"][7]
        match = "leaf keys do not match"
    elif fault == "shape":
        like = eng.init_scenarios(np.zeros((S + 1, 3), np.float32))
        match = "has shape"
    elif fault == "version":
        meta["version"] = 3
        match = "newer than supported"
    if fault == "no_meta":  # the unversioned, order-matched format is not read
        np.savez(path, **entries)
        match = "no __meta__ record"
    else:
        np.savez(path, __meta__=np.array(json.dumps(meta)), **entries)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_pytree(path, like)


def test_checkpoint_tree_paths():
    """Sequences, dicts and None follow jax.tree_util.keystr."""
    tree = {"b": [np.zeros(2), None], "a": (np.ones(1), StepDiagnostics(*[np.zeros(1)] * 7))}
    ref = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [k for k, _ in checkpoint._flatten(tree)] == ref


def _diag(seed=0, shape=(6, S)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32), rng.uniform(0, 9, shape).astype(np.float32),
            rng.integers(0, 3, shape).astype(np.int32), rng.uniform(size=shape) > 0.5,
            rng.uniform(size=shape) > 0.3, rng.uniform(size=shape) > 0.9,
            rng.uniform(size=shape) > 0.8)


@pytest.mark.parametrize("shape", [(S,), (6, S)], ids=["replan", "explore"])
def test_summarize_matches_jax(shape):
    leaves = _diag(shape=shape)
    ref = jmetrics.summarize(JStepDiagnostics(*leaves), elapsed_s=0.5)
    got = metrics.summarize(StepDiagnostics(*(torch.from_numpy(a) for a in leaves)),
                            elapsed_s=0.5)
    assert got == ref


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = metrics.MetricsLogger(str(path))
    rec = log.log(StepDiagnostics(*(torch.from_numpy(a) for a in _diag())), tick=3)
    assert rec["tick"] == 3 and rec["solves"] == 6 * S and log.history == [rec]
    assert json.loads(path.read_text().splitlines()[0]) == rec


@pytest.mark.parametrize("fused,map_shape", [(True, (20, 20)), (False, None)],
                         ids=["fused_with_maps", "eager_empty_world"])
def test_warmup_returns_its_stages(fused, map_shape):
    cfg = default_config("cart").replace(use_fused_solve=fused, shared_maps=fused, **OPTS)
    t = Engine(cfg, device="cpu").warmup(S, Domain.create(0.0, 0.0, 2.0, 2.0),
                                         map_shape=map_shape, gmm_components=2, n_ticks=(2,))
    want = ["init_scenarios", "phik_from_gmm", "replan", "replan_refresh", "explore_2"]
    if map_shape is not None:  # a map brings the world and the two MI stages
        want[1:1] = ["prepare_world", "phik_from_grid", "replan_refresh_mi"]
    assert list(t) == want  # no kernel build on the CPU
    assert all(isinstance(v, float) and v >= 0.0 for v in t.values())
