"""Frozen from ``ergodic_exploration_tpu_torch/ops/collision.py`` at commit e20fa1114c5b:
validation of a control against the distance field.
"""

from __future__ import annotations

import torch

# collision codes (reference enum parity)
NONE = 0
OBSTACLE = 1  # within d_safe of an obstacle (warning band)
CRASH = 2  # footprint overlaps an obstacle or leaves the domain


def check_pose(p, domain, field, boundary_radius: float, d_safe: float):
    """Collision code (int32) for positions (S, Q, 2) -> (S, Q); ``field``
    is a PatchField or a whole DistanceField."""
    d = field.query_dist(p) - boundary_radius
    crash = (~domain.contains(p)) | (d <= 0.0)
    warn = d < d_safe
    code = torch.where(warn, OBSTACLE, NONE)
    return torch.where(crash, CRASH, code).to(torch.int32)


def check_trajectory(P, domain, field, boundary_radius: float, d_safe: float):
    """Worst code along trajectories of positions (S, C, T, 2) -> (S, C)."""
    S, C, T, _ = P.shape
    codes = check_pose(P.reshape(S, C * T, 2), domain, field, boundary_radius, d_safe)
    return codes.reshape(S, C, T).amax(dim=-1)


def validate_control(model, x, u, domain, field, cfg):
    """Hold u (S, nu) for val_horizon steps of val_dt from x (S, 3); the
    worst code (S,) along the exact constant-twist arc."""
    from eebench.reference.ops.integrator import constant_twist_poses

    ts = cfg.val_dt * torch.arange(1, cfg.val_horizon + 1, dtype=torch.float32,
                                   device=x.device)
    X = constant_twist_poses(x, model.twist(u), ts)  # (S, T, 3)
    return check_trajectory(X[:, None, :, :2], domain, field, cfg.boundary_radius,
                            cfg.d_safe)[:, 0]
