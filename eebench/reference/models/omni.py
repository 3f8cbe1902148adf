"""Frozen from ``ergodic_exploration_tpu_torch/models/omni.py`` at commit e20fa1114c5b:
the mecanum model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from eebench.reference.models.base import rotate_body_to_world, true_div
from eebench.reference.utils.device import constant

# mixing-matrix sign rows for (vx, vy, omega)
_SX = (1.0, 1.0, 1.0, 1.0)
_SY = (-1.0, 1.0, 1.0, -1.0)
_SW = (-1.0, 1.0, -1.0, 1.0)


def _signed_sum(u, signs):
    """sum_i u_i * s_i, accumulated in wheel order."""
    acc = u[..., 0] * signs[0]
    for i in range(1, 4):
        acc = acc + u[..., i] * signs[i]
    return acc


@dataclass(frozen=True)
class Omni:
    wheel_radius: float = 0.0505
    lx: float = 0.28
    ly: float = 0.2665

    nu: int = 4

    def twist(self, u):
        """Wheel velocities -> body twist (vx, vy, omega)."""
        r = self.wheel_radius
        L = self.lx + self.ly
        vx = 0.25 * r * _signed_sum(u, _SX)
        vy = 0.25 * r * _signed_sum(u, _SY)
        w = (0.25 * r / L) * _signed_sum(u, _SW)
        return torch.stack([vx, vy, w], dim=-1)

    def from_twist(self, tw):
        """Body twist -> wheel velocities (exact inverse kinematics)."""
        r = self.wheel_radius
        L = self.lx + self.ly
        vx, vy, w = tw[..., 0], tw[..., 1], tw[..., 2]
        u1 = true_div(vx - vy - L * w, r)
        u2 = true_div(vx + vy + L * w, r)
        u3 = true_div(vx + vy - L * w, r)
        u4 = true_div(vx - vy + L * w, r)
        return torch.stack([u1, u2, u3, u4], dim=-1)

    def f(self, x, u):
        tw = self.twist(u)
        wx, wy = rotate_body_to_world(x[..., 2], tw[..., 0], tw[..., 1])
        return torch.stack([wx, wy, tw[..., 2]], dim=-1)

    def A(self, x, u):
        """df/dx: only the theta column is nonzero."""
        tw = self.twist(u)
        th = x[..., 2]
        c, s = torch.cos(th), torch.sin(th)
        vx, vy = tw[..., 0], tw[..., 1]
        z = torch.zeros_like(th)
        row0 = torch.stack([z, z, -vx * s - vy * c], dim=-1)
        row1 = torch.stack([z, z, vx * c - vy * s], dim=-1)
        row2 = torch.stack([z, z, z], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def B(self, x, u=None):
        """df/du: per-wheel body contribution rotated by theta; (..., 3, 4)."""
        r = self.wheel_radius
        L = self.lx + self.ly
        th = x[..., 2]
        c, s = torch.cos(th), torch.sin(th)

        def make():  # the scaled sign rows, once per (model, dtype, device)
            kw = dict(dtype=th.dtype, device=th.device)
            return (0.25 * r * torch.tensor(_SX, **kw), 0.25 * r * torch.tensor(_SY, **kw),
                    (0.25 * r / L) * torch.tensor(_SW, **kw))

        sx, sy, sw = constant(("omni_B", r, L, th.dtype), th.device, make)
        row0 = c[..., None] * sx - s[..., None] * sy
        row1 = s[..., None] * sx + c[..., None] * sy
        row2 = sw.expand(row0.shape)
        return torch.stack([row0, row1, row2], dim=-2)
