"""Frozen from ``ergodic_exploration_tpu_torch/models/cart.py`` at commit e20fa1114c5b:
the differential-drive model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from eebench.reference.models.base import true_div


@dataclass(frozen=True)
class Cart:
    wheel_radius: float = 0.033
    wheel_base: float = 0.16

    nu: int = 2

    def _vw(self, u):
        r, b = self.wheel_radius, self.wheel_base
        v = 0.5 * r * (u[..., 0] + u[..., 1])
        w = (r / b) * (u[..., 1] - u[..., 0])
        return v, w

    def f(self, x, u):
        v, w = self._vw(u)
        th = x[..., 2]
        return torch.stack([v * torch.cos(th), v * torch.sin(th), w], dim=-1)

    def A(self, x, u):
        """df/dx: only the theta column is nonzero."""
        v, _ = self._vw(u)
        th = x[..., 2]
        z = torch.zeros_like(v)
        row0 = torch.stack([z, z, -v * torch.sin(th)], dim=-1)
        row1 = torch.stack([z, z, v * torch.cos(th)], dim=-1)
        row2 = torch.stack([z, z, z], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def B(self, x, u=None):
        """df/du: the wheel map rotated into the world frame by theta."""
        r, b = self.wheel_radius, self.wheel_base
        th = x[..., 2]
        c, s = torch.cos(th), torch.sin(th)
        hr = 0.5 * r
        rb = r / b
        one = torch.ones_like(th)
        row0 = torch.stack([hr * c, hr * c], dim=-1)
        row1 = torch.stack([hr * s, hr * s], dim=-1)
        row2 = torch.stack([-rb * one, rb * one], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def twist(self, u):
        """Wheel velocities -> body twist (vx, 0, omega)."""
        v, w = self._vw(u)
        return torch.stack([v, torch.zeros_like(v), w], dim=-1)

    def from_twist(self, tw):
        """Body twist -> wheel velocities; vy is unrealizable and ignored."""
        r, b = self.wheel_radius, self.wheel_base
        vx, w = tw[..., 0], tw[..., 2]
        ul = true_div(vx - 0.5 * b * w, r)
        ur = true_div(vx + 0.5 * b * w, r)
        return torch.stack([ul, ur], dim=-1)
