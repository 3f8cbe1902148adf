"""Frozen from ``ergodic_exploration_tpu_torch/utils/numerics.py`` at commit e20fa1114c5b:
angle wrapping.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] as ``pi - mod(pi - theta, 2 pi)``.

    ``torch.remainder`` is the floor-mod (result takes the divisor's sign),
    the same operation as ``jnp.mod``, so the wrap is bit-identical to the
    JAX reference for float32 inputs.
    """
    return PI - torch.remainder(PI - theta, 2.0 * PI)


def wrap_state_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap the heading component (index 2) of states (..., 3)."""
    return torch.cat([x[..., :2], normalize_angle(x[..., 2:3])], dim=-1)
