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
- engine                                        — the batched single-device API
- utils.prng, utils.validation, utils.interop   — JAX-exact RNG, guards, state I/O
"""

from ergodic_exploration_tpu_torch.config import (
    CartParams,
    DwaConfig,
    EngineConfig,
    OmniParams,
    default_config,
    load_yaml_config,
)

__version__ = "0.1.0"

__all__ = ["CartParams", "DwaConfig", "EngineConfig", "OmniParams", "default_config",
           "load_yaml_config"]
