"""PyTorch + CUDA port of the ergodic-exploration MPC engine.

A second package beside the JAX reference ``ergodic_exploration_tpu``: the
same module names, the same configuration, and the batched replan tick run
eagerly in PyTorch around hand-written CUDA kernels for an NVIDIA H100
(``csrc/``). It imports no JAX. Modules:

- config, grid, models, utils.numerics         — configuration, world, kinematics
- ops.integrator, ops.basis, ops.target         — RK4, Fourier basis, GMM targets
- ops.distance, ops.patch, ops.barrier,
  ops.collision, ops.dwa, ops.buffer            — world queries, safety, history
- controller                                    — the batched eager tick
- ops.solve_kernel + csrc/solve_kernel.cu       — K1, the one-kernel tick
- engine                                        — the batched API, one device or a mesh
- parallel                                      — scale-out over torch.distributed
- node, native                                  — the single-robot loop, the C++ host runtime
- viz, utils.profiling                          — figures, timing and traces
- utils.prng, utils.validation, utils.interop   — JAX-exact RNG, guards, state I/O

``Engine``, ``ErgodicController``, ``ExplorationNode``, ``GaussianMixture``,
``make_scenario_mesh`` and ``make_mesh`` are imported from the package root on
first use: the config and grid stay cheap to import.
"""

from ergodic_exploration_tpu_torch.config import (
    CartParams,
    DwaConfig,
    EngineConfig,
    OmniParams,
    default_config,
    load_yaml_config,
)
from ergodic_exploration_tpu_torch.grid import Domain, GridMap

__version__ = "0.1.0"

_LAZY = {
    "ErgodicController": "ergodic_exploration_tpu_torch.controller",
    "Engine": "ergodic_exploration_tpu_torch.engine",
    "ExplorationNode": "ergodic_exploration_tpu_torch.node",
    "GaussianMixture": "ergodic_exploration_tpu_torch.ops.target",
    "make_scenario_mesh": "ergodic_exploration_tpu_torch.engine",
    "make_mesh": "ergodic_exploration_tpu_torch.engine",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)


__all__ = ["CartParams", "DwaConfig", "EngineConfig", "OmniParams", "default_config",
           "load_yaml_config", "Domain", "GridMap", "ErgodicController", "Engine",
           "ExplorationNode", "GaussianMixture", "make_scenario_mesh", "make_mesh"]
