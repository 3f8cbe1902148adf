"""Euclidean distance transform + gradient field over occupancy grids (port
of ``ergodic_exploration_tpu/ops/distance.py``).

Separable squared-distance decomposition, each pass a dense min-plus
reduction against the (n, n) squared-offset matrix:

    g[i, j]  = min_{i': occ[i', j]} (i - i')^2          (columns pass)
    d2[i, j] = min_{j'} g[i, j'] + (j - j')^2           (rows pass)

A pass materialises (..., n, n) per map, so batches of maps run in chunks of
``chunk`` maps: (4096, 100, 100, 100) float32 would be 16 GB at once. The
EDT runs at map cadence, outside the replan tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FAR = 1.0e6  # "no obstacle anywhere" distance (meters)


def _minplus_pass(g: torch.Tensor, dim: int) -> torch.Tensor:
    """out[.., j] = min_k g[.., k] + (j - k)^2 along ``dim``."""
    n = g.shape[dim]
    k = torch.arange(n, dtype=g.dtype, device=g.device)
    sq = (k[:, None] - k[None, :]) ** 2  # sq[k, j] = (j - k)^2
    gm = g.movedim(dim, -1)
    out = (gm[..., :, None] + sq).amin(dim=-2)
    return out.movedim(-1, dim)


def edt(occ: torch.Tensor, resolution, chunk: int = 256) -> torch.Tensor:
    """Exact Euclidean distance (meters) from each cell centre to the nearest
    occupied cell centre. ``occ``: (..., H, W) bool, ``resolution`` (...) or
    scalar. Empty maps -> FAR."""
    h, w = occ.shape[-2:]
    big = float(max(h, w) ** 2 * 4)
    lead = occ.shape[:-2]
    flat = occ.reshape(-1, h, w)
    parts = []
    for i in range(0, flat.shape[0], chunk):
        g = torch.where(flat[i:i + chunk], 0.0, big).to(torch.float32)
        parts.append(_minplus_pass(_minplus_pass(g, -2), -1))
    d2 = torch.cat(parts).reshape(*lead, h, w)
    res = torch.as_tensor(resolution, dtype=torch.float32, device=occ.device)
    d = torch.sqrt(d2) * res[..., None, None]
    return torch.where(d2 >= big, torch.full_like(d, FAR), d)


def central_gradient(d: torch.Tensor, res: torch.Tensor):
    """Central differences over the last two axes (one-sided at the borders),
    d/dx along W and d/dy along H, with the FAR plateau zeroed."""
    r = res[..., None, None]
    gx = (torch.roll(d, -1, dims=-1) - torch.roll(d, 1, dims=-1)) / (2.0 * r)
    gx[..., :, 0] = (d[..., :, 1] - d[..., :, 0]) / r[..., 0]
    gx[..., :, -1] = (d[..., :, -1] - d[..., :, -2]) / r[..., 0]
    gy = (torch.roll(d, -1, dims=-2) - torch.roll(d, 1, dims=-2)) / (2.0 * r)
    gy[..., 0, :] = (d[..., 1, :] - d[..., 0, :]) / r[..., 0]
    gy[..., -1, :] = (d[..., -1, :] - d[..., -2, :]) / r[..., 0]
    far = d >= FAR
    zero = torch.zeros_like(d)
    return torch.where(far, zero, gx), torch.where(far, zero, gy)


class DistanceField(NamedTuple):
    """Per-map clearance field + gradient."""

    dist: torch.Tensor  # (..., H, W) meters to nearest obstacle
    grad: torch.Tensor  # (..., H, W, 2) d(dist)/d(x, y)
    origin: torch.Tensor  # (..., 2)
    resolution: torch.Tensor  # (...)

    @staticmethod
    def empty(shape, origin=None, resolution: float = 0.05) -> "DistanceField":
        """Obstacle-free world: FAR distances, zero gradients."""
        h, w = shape
        dev = None if origin is None else origin.device
        if origin is None:
            origin = torch.zeros(2, dtype=torch.float32)
        return DistanceField(
            dist=torch.full((h, w), FAR, dtype=torch.float32, device=dev),
            grad=torch.zeros((h, w, 2), dtype=torch.float32, device=dev),
            origin=origin.to(torch.float32),
            resolution=torch.tensor(resolution, dtype=torch.float32, device=dev),
        )

    @staticmethod
    def from_grid(grid, occupied_threshold: float = 0.65) -> "DistanceField":
        """EDT over the occupied mask + central-difference gradient; maps
        batch over leading axes."""
        d = edt(grid.occupied(occupied_threshold), grid.resolution)
        gx, gy = central_gradient(d, grid.resolution)
        return DistanceField(dist=d, grad=torch.stack([gx, gy], dim=-1),
                             origin=grid.origin, resolution=grid.resolution)
