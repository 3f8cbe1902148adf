"""The port's loader of the native host runtime (native/runtime.cc): its
EDT against the port's ``DistanceField.from_grid`` (atol 1e-5, as
tests/test_node.py holds the JAX loader against the JAX EDT), the batch
against single maps bit for bit, ingest and entropy, and where the library
is built."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ergodic_exploration_tpu_torch import native
from ergodic_exploration_tpu_torch.grid import GridMap
from ergodic_exploration_tpu_torch.ops import target
from ergodic_exploration_tpu_torch.ops.distance import FAR, DistanceField

ROOT = Path(__file__).resolve().parents[1]


def test_native_edt_matches_the_ports_edt():
    rng = np.random.default_rng(3)
    occ = (rng.random((40, 50)) < 0.03).astype(np.float32)
    ref = DistanceField.from_grid(GridMap.create(occ, 0, 0, 0.1), 0.65)
    d, gr = native.edt2d(occ, 0.65, 0.1)
    np.testing.assert_allclose(d, ref.dist.numpy(), atol=1e-5)
    np.testing.assert_allclose(gr, ref.grad.numpy(), atol=1e-5)
    # an empty map is FAR everywhere with a zero gradient, as the port's
    d0, g0 = native.edt2d(np.zeros((8, 9), np.float32), 0.65, 0.05)
    assert native.FAR == FAR and (d0 == FAR).all() and (g0 == 0).all()


def test_native_batch_ingest_and_entropy():
    rng = np.random.default_rng(0)
    occ = (rng.random((5, 30, 30)) < 0.05).astype(np.float32)
    d, g = native.edt2d_batch(occ, 0.65, 0.05, n_threads=3)
    for i in range(5):
        d1, g1 = native.edt2d(occ[i], 0.65, 0.05)
        np.testing.assert_array_equal(d[i], d1)
        np.testing.assert_array_equal(g[i], g1)
    raw = np.array([[-1, 0], [100, 37]], dtype=np.int8)
    got = native.ros_ingest(raw)
    np.testing.assert_array_equal(got, GridMap.from_ros(raw, 0, 0, 0.05).data.numpy())
    np.testing.assert_allclose(got, [[-1.0, 0.0], [1.0, 0.37]])
    data = np.where(rng.random((20, 20)) < 0.3, -1.0, rng.random((20, 20))).astype(np.float32)
    np.testing.assert_allclose(native.entropy_map(data),
                               target.entropy(GridMap.create(data).prob()).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="one"):
        native.edt2d(occ, 0.65, 0.05)


def test_native_library_is_built_under_build_and_not_in_native():
    lib = ROOT / "native" / "libeetruntime.so"
    before = lib.stat().st_mtime_ns if lib.exists() else None
    native.ros_ingest(np.zeros(3, np.int8))  # loads (and if need be builds) the library
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert path.name.startswith("libeetruntime-")
    if before is not None:
        assert lib.stat().st_mtime_ns == before


def test_native_available_only_with_gxx_and_compile_errors_raise(monkeypatch, tmp_path):
    assert native.available()  # g++ exists wherever these tests run the native path
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build(native.library_path())
    assert not any((tmp_path / "out").glob("*.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()


def test_node_without_gxx_takes_the_torch_edt(monkeypatch):
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.node import ExplorationNode

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    node = ExplorationNode(default_config("cart").replace(num_basis=4, grid_samples=(8, 8)),
                           device="cpu")
    assert not node.use_native
    node.on_map(np.zeros((10, 10), np.int8), resolution=0.1)
    node._refresh()
    assert torch.equal(node._world.dist.dist[0], torch.full((10, 10), FAR))
