"""The port and its smoke script import no JAX and nothing of the JAX
package (an AST scan: ``sys.modules`` cannot show it where jax is
pre-imported)."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "ergodic_exploration_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                      PKG.parent / "chip_profile.py",
                                      PKG.parent / "chip_kernel_ab.py",
                                      PKG.parent / "tests" / "torch_parallel_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "ergodic_exploration_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_package_has_the_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in FILES if PKG in p.parents}
    for m in ("config.py", "grid.py", "controller.py", "engine.py", "ops/solve_kernel.py",
              "utils/interop.py", "utils/prng.py", "utils/validation.py", "ops/gmm_kernel.py",
              "utils/checkpoint.py", "utils/metrics.py", "utils/device.py", "ops/mi_kernel.py",
              "ops/sensor.py", "ops/target.py", "ops/basis.py", "utils/cuda_build.py",
              "node.py", "native.py", "viz.py", "utils/profiling.py",
              "examples/single_robot.py", "parallel/__init__.py", "graft_entry.py",
              "examples/batched_fleet.py", "examples/scaling.py", "tools/quality.py",
              "tools/diag_plateau.py", "bench.py", "utils/graphs.py", "ops/tick_glue.py",
              "ops/reveal_kernel.py", "ops/edt_kernel.py", "ops/mi_dense_kernel.py"):
        assert m in names
    for src in ("solve_kernel.cu", "gmm_kernel.cu", "gmm_refresh.cuh", "mi_kernel.cu",
                "tick_glue.cu", "reveal_kernel.cu", "edt_kernel.cu", "mi_dense_kernel.cu"):
        assert (PKG / "csrc" / src).exists()
    from ergodic_exploration_tpu_torch.utils.cuda_build import CSRC, LIBRARIES

    # every CUDA source is registered with the build, and nothing else is
    assert sorted(LIBRARIES.values()) == sorted(p.name for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(PKG if PKG in p.parents else PKG.parent).as_posix())
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
