"""Frozen from ``ergodic_exploration_tpu_torch/ops/barrier.py`` at commit e20fa1114c5b:
the boundary and obstacle barrier.
"""

from __future__ import annotations

import torch

from eebench.reference.grid import rows


def boundary_barrier(p, domain, eps: float, weight: float):
    """Value (S, Q) and gradient (S, Q, 2) at points (S, Q, 2)."""
    lo = rows(domain.origin) + eps
    hi = rows(domain.origin + domain.lengths) - eps
    over = torch.clamp(p - hi, min=0.0)
    under = torch.clamp(lo - p, min=0.0)
    val = weight * (over ** 2 + under ** 2).sum(dim=-1)
    grad = 2.0 * weight * (over - under)
    return val, grad


def obstacle_barrier(clearance, clearance_grad, boundary_radius: float, d_safe: float,
                     weight: float, d_min: float = 0.03):
    """Value (...,) and gradient (..., 2) of the obstacle-proximity barrier."""
    d = torch.clamp(clearance - boundary_radius, min=d_min)
    active = d < d_safe
    zero = torch.zeros_like(d)
    diff = torch.where(active, 1.0 / d - 1.0 / d_safe, zero)
    val = weight * diff ** 2
    dval_dd = torch.where(active, -2.0 * weight * diff / (d * d), zero)
    return val, dval_dd[..., None] * clearance_grad


def barrier(p, domain, field, cfg):
    """Combined barrier value (S, Q) and gradient (S, Q, 2) at points p;
    ``field`` is a PatchField or a whole DistanceField (one map a scenario,
    or one shared map)."""
    bv, bg = boundary_barrier(p, domain, cfg.barrier_eps, cfg.barrier_boundary_weight)
    clearance, cgrad = field.query(p)
    ov, og = obstacle_barrier(clearance, cgrad, cfg.boundary_radius, cfg.d_safe,
                              cfg.barrier_obstacle_weight)
    return bv + ov, bg + og
