"""Euclidean distance transform + gradient field over occupancy grids (port
of ``ergodic_exploration_tpu/ops/distance.py``).

Separable squared-distance decomposition, each pass a dense min-plus
reduction against the (n, n) squared-offset matrix:

    g[i, j]  = min_{i': occ[i', j]} (i - i')^2          (columns pass)
    d2[i, j] = min_{j'} g[i, j'] + (j - j')^2           (rows pass)

A pass materialises (..., n, n) per map, so batches of maps run in chunks of
``chunk`` maps: (4096, 100, 100, 100) float32 would be 16 GB at once. The
EDT runs at map cadence, outside the replan tick. These are the plain
versions: :meth:`DistanceField.from_grid` on CUDA tensors launches the EDT
kernel of ``ops/edt_kernel.py`` instead.
"""

from __future__ import annotations

import math
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
        batch over leading axes. CPU tensors take the plain version
        (:func:`edt`, then :func:`central_gradient`); CUDA tensors the EDT
        kernel (``ops/edt_kernel.py``), one launch for the batch that
        returns both, or it raises."""
        from ergodic_exploration_tpu_torch.ops import edt_kernel
        from ergodic_exploration_tpu_torch.ops.solve_kernel import _on_cpu

        if _on_cpu(grid.data, "DistanceField.from_grid"):
            d, grad = edt_kernel.edt_field_plain(grid.data, grid.resolution,
                                                 occupied_threshold)
        else:
            lead, (h, w) = grid.data.shape[:-2], grid.data.shape[-2:]
            res = torch.broadcast_to(grid.resolution.to(torch.float32), lead)
            d, grad = edt_kernel.E(grid.data.to(torch.float32).reshape(-1, h, w).contiguous(),
                                   res.reshape(-1).contiguous(), occupied_threshold)
            d, grad = d.reshape(*lead, h, w), grad.reshape(*lead, h, w, 2)
        return DistanceField(dist=d, grad=grad, origin=grid.origin, resolution=grid.resolution)

    def _frac(self, p: torch.Tensor) -> torch.Tensor:
        """Fractional cell coordinates (ix, iy) of world points. ``p`` is
        (*B, *Q, 2) for a field with leading axes B: each map answers the
        points of its own row."""
        nq = p.dim() - 1 - (self.dist.dim() - 2)
        res = self.resolution.reshape(*self.resolution.shape, *([1] * nq), 1)
        origin = self.origin.reshape(*self.origin.shape[:-1], *([1] * nq), 2)
        return (p - origin) / res - 0.5

    def _at(self, a: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
        """a[b, iy, ix] for each map b of the field's leading axes: ``a`` is
        (*B, H, W, ...) and the indices (*B, *Q)."""
        nb = self.dist.dim() - 2
        if nb == 0:
            return a[iy, ix]
        lead = a.shape[:nb]
        b = torch.arange(math.prod(lead), device=a.device).reshape(*lead, *([1] * (iy.dim() - nb)))
        return a.reshape(-1, *a.shape[nb:])[b, iy, ix]

    def query_dist(self, p: torch.Tensor) -> torch.Tensor:
        """Nearest-cell clearance at world points (*B, *Q, 2) -> (*B, *Q):
        half-even rounding to the nearest cell, clamped to the map."""
        h, w = self.dist.shape[-2:]
        n = torch.round(self._frac(p)).to(torch.int64)
        return self._at(self.dist, torch.clamp(n[..., 1], 0, h - 1),
                        torch.clamp(n[..., 0], 0, w - 1))

    def query(self, p: torch.Tensor):
        """Bilinear clearance (*B, *Q) and gradient (*B, *Q, 2) at world
        points (*B, *Q, 2), fractional coordinates clamped to
        [0, w - 1.001] x [0, h - 1.001]; the JAX package's weights in its
        order of operations."""
        h, w = self.dist.shape[-2:]
        f = self._frac(p)
        fx = torch.clamp(f[..., 0], 0.0, w - 1.001)
        fy = torch.clamp(f[..., 1], 0.0, h - 1.001)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        tx, ty = fx - x0, fy - y0
        ix, iy = x0.to(torch.int64), y0.to(torch.int64)
        d00, d01 = self._at(self.dist, iy, ix), self._at(self.dist, iy, ix + 1)
        d10, d11 = self._at(self.dist, iy + 1, ix), self._at(self.dist, iy + 1, ix + 1)
        dist = (d00 * (1 - tx) * (1 - ty) + d01 * tx * (1 - ty) + d10 * (1 - tx) * ty
                + d11 * tx * ty)
        wts = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], dim=-1)
        g00, g01 = self._at(self.grad, iy, ix), self._at(self.grad, iy, ix + 1)
        g10, g11 = self._at(self.grad, iy + 1, ix), self._at(self.grad, iy + 1, ix + 1)
        grad = (g00 * wts[..., 0:1] + g01 * wts[..., 1:2] + g10 * wts[..., 2:3]
                + g11 * wts[..., 3:4])
        return dist, grad
