"""Frozen from ``ergodic_exploration_tpu_torch/ops/integrator.py`` at commit e20fa1114c5b:
the RK4 rollout and the co-state sweep.
"""

from __future__ import annotations

import torch

from eebench.reference.utils.numerics import normalize_angle, wrap_state_angle


def rk4_step(f, x, u, dt):
    """One classical RK4 step of xdot = f(x, u) with u held constant."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rollout(model, x0, U, dt):
    """Forward-simulate control sequences: x0 (..., 3), U (..., H, nu) ->
    (..., H+1, 3) states [x_0 .. x_H] with wrapped headings."""
    xs = [x0]
    x = x0
    for t in range(U.shape[-2]):
        x = wrap_state_angle(rk4_step(model.f, x, U[..., t, :], dt))
        xs.append(x)
    return torch.stack(xs, dim=-2)


def costate_rk4_step(rho, A, g, dt):
    """Integrate rho_dot = -g - A^T rho backward over one step of length dt."""

    def fdot(r):  # g + A^T r, summed in row order so every device rounds alike
        return g + ((A[..., 0, :] * r[..., 0:1] + A[..., 1, :] * r[..., 1:2])
                    + A[..., 2, :] * r[..., 2:3])

    k1 = fdot(rho)
    k2 = fdot(rho + 0.5 * dt * k1)
    k3 = fdot(rho + 0.5 * dt * k2)
    k4 = fdot(rho + dt * k3)
    return rho + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def costate_solve(As, gs, dt):
    """Backward co-state sweep: As (..., H, 3, 3), gs (..., H, 3) ->
    rhos (..., H, 3) = [rho_0 .. rho_{H-1}] with rho_H = 0 implicit."""
    H = As.shape[-3]
    rho = torch.zeros_like(gs[..., 0, :])
    out = [None] * H
    for t in range(H - 1, -1, -1):
        rho = costate_rk4_step(rho, As[..., t, :, :], gs[..., t, :], dt)
        out[t] = rho
    return torch.stack(out, dim=-2)


def constant_twist_poses(x0, tw, ts):
    """Exact poses under a constant BODY twist — the closed-form arc.

    x0 (..., 3), tw (..., 3), ts (T,) -> (..., T, 3). Small |w| uses the
    series limits a = t (1 - (wt)^2/6), b = w t^2 / 2.
    """
    vx, vy, w = tw[..., 0:1], tw[..., 1:2], tw[..., 2:3]
    th0 = x0[..., 2:3]
    wt = w * ts
    s, c = torch.sin(wt), torch.cos(wt)
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, ts * (1.0 - wt * wt / 6.0), s / w_safe)
    b = torch.where(small, w * ts * ts * 0.5, (1.0 - c) / w_safe)
    dx_b = vx * a - vy * b
    dy_b = vx * b + vy * a
    c0, s0 = torch.cos(th0), torch.sin(th0)
    px = x0[..., 0:1] + c0 * dx_b - s0 * dy_b
    py = x0[..., 1:2] + s0 * dx_b + c0 * dy_b
    th = normalize_angle(th0 + wt)
    return torch.stack([px, py, th], dim=-1)
