"""Frozen from ``ergodic_exploration_tpu_torch/ops/dwa.py`` at commit e20fa1114c5b:
the dynamic-window fallback.
"""

from __future__ import annotations

import torch

from eebench.reference.ops.collision import CRASH, check_trajectory

INFEASIBLE_COST = 1.0e9


def _axis_samples(center, acc, dt, vmax, n: int):
    """(S, n) samples spanning [center - acc dt, center + acc dt] clipped to
    [-vmax, vmax]; n == 1 collapses to {0}."""
    if n == 1:
        return torch.zeros_like(center)[:, None]
    lo = torch.clamp(center - acc * dt, -vmax, vmax)
    hi = torch.clamp(center + acc * dt, -vmax, vmax)
    frac = torch.arange(n, dtype=torch.float32, device=center.device) / center.new_full((), n - 1)
    return lo[:, None] + (hi - lo)[:, None] * frac


def candidate_twists(vb, dwa_cfg):
    """(S, n_vx * n_vy * n_omega, 3) candidate body twists around vb (S, 3)."""
    nvx, nvy, nw = dwa_cfg.samples
    ax, ay, aw = dwa_cfg.acc_lim
    mx, my, mw = dwa_cfg.vel_lim
    vxs = _axis_samples(vb[:, 0], ax, dwa_cfg.dt, mx, nvx)
    vys = _axis_samples(vb[:, 1], ay, dwa_cfg.dt, my, nvy)
    ws = _axis_samples(vb[:, 2], aw, dwa_cfg.dt, mw, nw)
    S = vb.shape[0]
    g = torch.stack([
        vxs[:, :, None, None].expand(S, nvx, nvy, nw),
        vys[:, None, :, None].expand(S, nvx, nvy, nw),
        ws[:, None, None, :].expand(S, nvx, nvy, nw),
    ], dim=-1)
    return g.reshape(S, -1, 3)


def dwa_control(model, x, vb, u_ref, domain, field, cfg):
    """Best collision-free control near ``u_ref`` (S, nu).

    Returns (u (S, nu), feasible (S,) bool); infeasible scenarios get the
    zero control (stop).
    """
    from eebench.reference.ops.integrator import constant_twist_poses

    dwa = cfg.dwa
    tws = candidate_twists(vb, dwa)  # (S, C, 3)
    us = model.from_twist(tws)  # (S, C, nu)
    tws_real = model.twist(us)  # what would actually be executed
    ts = dwa.dt * torch.arange(1, dwa.horizon + 1, dtype=torch.float32, device=x.device)
    X = constant_twist_poses(x[:, None, :], tws_real, ts)  # (S, C, T, 3)
    codes = check_trajectory(X[..., :2], domain, field, cfg.boundary_radius, cfg.d_safe)
    if dwa.cost_space == "control":
        cost = ((us - u_ref[:, None, :]) ** 2).sum(dim=-1)
    else:  # "twist"
        tw_ref = model.twist(u_ref)
        cost = ((tws_real - tw_ref[:, None, :]) ** 2).sum(dim=-1)
    cost = torch.where(codes >= CRASH, torch.full_like(cost, INFEASIBLE_COST), cost)
    best = torch.argmin(cost, dim=-1)  # first index reaching the minimum
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    feasible = best_cost < INFEASIBLE_COST
    u_best = torch.gather(us, 1, best[:, None, None].expand(-1, 1, us.shape[-1]))[:, 0]
    return torch.where(feasible[:, None], u_best, torch.zeros_like(u_best)), feasible
