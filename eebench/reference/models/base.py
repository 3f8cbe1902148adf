"""Frozen from ``ergodic_exploration_tpu_torch/models/base.py`` at commit e20fa1114c5b:
the kinematic models' common part.
"""

from __future__ import annotations

from typing import Protocol

import torch


class KinematicModel(Protocol):
    """Structural interface every model implements."""

    nu: int

    def f(self, x, u):  # (..., 3), (..., nu) -> (..., 3)
        """Continuous-time kinematics xdot = f(x, u)."""

    def A(self, x, u):  # -> (..., 3, 3)
        """State Jacobian df/dx."""

    def B(self, x, u):  # -> (..., 3, nu)
        """Control Jacobian df/du."""

    def twist(self, u):  # (..., nu) -> (..., 3)
        """Control -> body twist (vx, vy, omega)."""

    def from_twist(self, v):  # (..., 3) -> (..., nu)
        """Body twist -> control."""


def make_model(config) -> "KinematicModel":
    """Instantiate the configured model from an :class:`EngineConfig`."""
    from eebench.reference.models.cart import Cart
    from eebench.reference.models.omni import Omni

    if config.model == "cart":
        return Cart(config.cart.wheel_radius, config.cart.wheel_base)
    if config.model == "omni":
        return Omni(config.omni.wheel_radius, config.omni.lx, config.omni.ly)
    raise ValueError(f"unknown model {config.model!r}")


def rotate_body_to_world(theta, vx, vy):
    """Rotate a body-frame planar velocity into the world frame."""
    c, s = torch.cos(theta), torch.sin(theta)
    return vx * c - vy * s, vx * s + vy * c


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as an IEEE division on every device (CUDA turns a
    division by a host scalar into a multiplication by its reciprocal,
    which may differ in the last bit; the safety stage's cell choices must
    round alike in the kernel, its plain version and the JAX reference)."""
    return a / a.new_full((), b)
