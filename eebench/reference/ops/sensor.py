"""Frozen from ``ergodic_exploration_tpu_torch/ops/sensor.py`` at commit e20fa1114c5b:
the ray-cast reveal and the coverage (plain versions).
"""

from __future__ import annotations

import math

import torch

from eebench.reference.grid import UNKNOWN, GridMap


def reveal(belief: GridMap, truth: GridMap, pose, sensor_range: float) -> GridMap:
    """Reveal ground truth within ``sensor_range`` of ``pose`` (disc model,
    sees through walls). Already-known cells keep their value."""
    h, w = belief.shape
    dev = belief.data.device
    res = belief.resolution[..., None]
    cx = belief.origin[..., 0:1] + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * res
    cy = belief.origin[..., 1:2] + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * res
    d2 = ((cx - pose[..., 0:1]) ** 2)[..., None, :] + ((cy - pose[..., 1:2]) ** 2)[..., :, None]
    seen = d2 <= sensor_range * sensor_range
    return belief._replace(data=torch.where(seen, truth.data, belief.data))


def bin_centers(n_bins: int, device) -> torch.Tensor:
    """(n_bins,) float32 angle-bin centres in [-pi, pi), by the expression
    both the plain version and the kernel's wrapper evaluate on the maps'
    device (a division by a Python number may round otherwise on another
    device)."""
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=device)
    return ((torch.arange(n_bins, dtype=torch.float32, device=device) + 0.5) / n_bins) \
        * two_pi - math.pi


def _raycast_chunk(belief, truth, origin, res, pose, sensor_range, P, n_bins, thr):
    """:func:`reveal_raycast_plain` for a chunk of B maps: data (B, h, w),
    origin (B, 2), res (B,), pose (B, >=2)."""
    B, h, w = belief.shape
    dev = belief.device
    two_pi = belief.new_full((), 2.0 * math.pi)

    # 1. the window around the pose (edge-clamped, as ops/patch.py)
    cf = (pose[:, :2] - origin) / res[:, None] - 0.5  # fractional (ix, iy)
    start = torch.round(cf).to(torch.int64) - P // 2
    ii = torch.arange(P, device=dev)
    rows = torch.clamp(start[:, 1:2] + ii, 0, h - 1)  # (B, P)
    cols = torch.clamp(start[:, 0:1] + ii, 0, w - 1)
    bi = torch.arange(B, device=dev)[:, None, None]
    truth_w = truth[bi, rows[:, :, None], cols[:, None, :]]  # (B, P, P) [iy, ix]

    # window cell centres relative to the sensor
    gx = origin[:, 0:1] + (cols.to(torch.float32) + 0.5) * res[:, None]
    gy = origin[:, 1:2] + (rows.to(torch.float32) + 0.5) * res[:, None]
    dx = gx[:, None, :] - pose[:, 0, None, None]
    dy = gy[:, :, None] - pose[:, 1, None, None]
    r = torch.sqrt(dx * dx + dy * dy).reshape(B, -1)  # (B, N)
    ang = torch.atan2(dy, dx).reshape(B, -1)  # [-pi, pi]

    # 2. polar bins: the angle bin and the radius step (one cell each) of every
    # window cell; an OCCUPIED cell blocks every bin whose centre lies inside
    # the angular interval the cell subtends (half-width atan(0.55 / r_cells))
    n_r = P // 2 + 2
    bin_i = torch.clamp(torch.floor((ang + math.pi) / two_pi * n_bins), 0, n_bins - 1)
    r_cells = r / res[:, None]
    q = torch.clamp(torch.round(r_cells), 0, n_r - 1).to(torch.int16)  # (B, N)
    occ = truth_w.reshape(B, -1) >= thr
    half_w = torch.atan(0.55 / torch.clamp(r_cells, min=0.5))
    centers = bin_centers(n_bins, dev)
    dang = ang[:, :, None] - centers  # (B, N, n_bins)
    dang = torch.remainder(dang.add_(math.pi), two_pi).sub_(math.pi).abs_()
    blocks = (dang <= half_w[:, :, None]) & occ[:, :, None]
    del dang

    # 3. shadow: a cell is invisible once strictly past the first blocker of
    # its bin, so a bin is described by its nearest blocker's radius step
    far = torch.full((), n_r, dtype=torch.int16, device=dev)
    first = torch.where(blocks, q[:, :, None], far).amin(dim=1)  # (B, n_bins)
    del blocks

    # 4. per-cell visibility + range disc
    vis_w = (q <= torch.gather(first, 1, bin_i.to(torch.int64))) & (r <= sensor_range)

    # 5. write back. Edge-clamped duplicate window cells name the same map
    # cell, hence the same centre, angle, radius and visibility: every copy
    # writes the same value.
    vis = torch.zeros((B, h, w), dtype=torch.bool, device=dev)
    vis[bi, rows[:, :, None], cols[:, None, :]] = vis_w.reshape(B, P, P)
    return torch.where(vis, truth, belief)


def reveal_raycast_plain(belief: GridMap, truth: GridMap, pose, sensor_range: float,
                         window_cells: int, n_bins: int = 256,
                         occupied_threshold: float = 0.65, chunk: int = 64) -> GridMap:
    """Occlusion-aware reveal: cells behind walls stay unknown.

    A polar visibility transform on a local window around the pose: each
    window cell is binned by its polar angle about the sensor and its radius
    step; an occupied cell blocks every angle bin inside the interval it
    subtends; cells strictly behind the first blocker of their bin are
    invisible (the blocker itself is visible); visible cells within
    ``sensor_range`` take the truth's value.

    Args:
        window_cells: window side length; must cover the sensor disc
            (:func:`raycast_window_cells`).
        n_bins: angular resolution; bin arcs should stay under ~1 cell at the
            window edge (n_bins >= pi * window_cells).
        occupied_threshold: truth occupancy from which a cell blocks rays.
        chunk: scenarios per pass (bounds the temporaries' memory).

    The reveal kernel's plain version (:func:`reveal_raycast` dispatches).
    """
    h, w = belief.shape
    P = min(window_cells, h, w)
    if belief.data.dim() == 2:
        data = _raycast_chunk(belief.data[None], truth.data[None], belief.origin[None],
                              belief.resolution[None], pose[None], sensor_range, P, n_bins,
                              occupied_threshold)[0]
        return belief._replace(data=data)
    parts = [_raycast_chunk(belief.data[i:i + chunk], truth.data[i:i + chunk],
                            belief.origin[i:i + chunk], belief.resolution[i:i + chunk],
                            pose[i:i + chunk], sensor_range, P, n_bins, occupied_threshold)
             for i in range(0, belief.data.shape[0], chunk)]
    return belief._replace(data=torch.cat(parts))


reveal_raycast = reveal_raycast_plain


def raycast_window_cells(sensor_range: float, resolution: float) -> int:
    """Window size covering the sensor disc (+1 cell of rounding)."""
    return 2 * (int(math.ceil(sensor_range / resolution)) + 1) + 1


def fraction_known_plain(belief: GridMap) -> torch.Tensor:
    """Scalar in [0, 1]: how much of the map(s) has been observed, exactly:
    the cells that are not UNKNOWN counted in int64, divided by the cells
    in float64 and rounded to float32 once (the JAX package's float32 mean
    differs from it by rounding alone)."""
    known = (belief.data != UNKNOWN).sum()
    return (known.to(torch.float64) / belief.data.numel()).to(torch.float32)


