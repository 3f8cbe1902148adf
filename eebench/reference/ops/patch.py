"""Frozen from ``ergodic_exploration_tpu_torch/ops/patch.py`` at commit e20fa1114c5b:
the local distance-map patch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eebench.reference.grid import rows
from eebench.reference.ops.distance import central_gradient
from eebench.reference.utils.device import constant


def _gather2(a: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """a[s, iy[s, q], ix[s, q]] for a (S, P, P) and indices (S, Q)."""
    P = a.shape[-1]
    return torch.gather(a.reshape(a.shape[0], -1), 1, iy * P + ix)


class PatchField(NamedTuple):
    """Per-scenario (P, P) windows of a distance field."""

    dist: torch.Tensor  # (S, P, P) clearance, indexed [iy_local, ix_local]
    grad: torch.Tensor  # (S, P, P, 2) clearance gradient
    start: torch.Tensor  # (S, 2) int64 (ix, iy) of local cell (0, 0)
    origin: torch.Tensor  # (S, 2) world origin of the parent field
    resolution: torch.Tensor  # (S,)

    @property
    def size(self) -> int:
        return self.dist.shape[-1]

    def _local_frac(self, p: torch.Tensor) -> torch.Tensor:
        """World points (S, Q, 2) -> fractional local cell coords, clamped."""
        rel = (p - rows(self.origin)) / self.resolution[:, None, None] - 0.5
        loc = rel - rows(self.start.to(rel.dtype))
        return torch.clamp(loc, 0.0, self.size - 1.001)

    def query(self, p: torch.Tensor):
        """Bilinear clearance (S, Q) + gradient (S, Q, 2) at points (S, Q, 2):
        hat weights max(0, 1 - |f - c|) on the 2x2 support, contracted over
        rows first, then columns (the JAX hat-matmul order)."""
        f = self._local_frac(p)
        fx, fy = f[..., 0], f[..., 1]
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        wx0, wx1 = 1.0 - (fx - x0), 1.0 - ((x0 + 1.0) - fx)
        wy0, wy1 = 1.0 - (fy - y0), 1.0 - ((y0 + 1.0) - fy)
        ix, iy = x0.to(torch.int64), y0.to(torch.int64)

        def interp(a):
            c00 = _gather2(a, iy, ix)
            c01 = _gather2(a, iy, ix + 1)
            c10 = _gather2(a, iy + 1, ix)
            c11 = _gather2(a, iy + 1, ix + 1)
            return (wy0 * c00 + wy1 * c10) * wx0 + (wy0 * c01 + wy1 * c11) * wx1

        dist = interp(self.dist)
        grad = torch.stack([interp(self.grad[..., 0]), interp(self.grad[..., 1])], dim=-1)
        return dist, grad

    def center_crop(self, size: int) -> "PatchField":
        """Static central (size, size) sub-window (clamped to the patch)."""
        P = self.size
        if size >= P:
            return self
        o = (P - size) // 2
        return PatchField(
            dist=self.dist[:, o:o + size, o:o + size],
            grad=self.grad[:, o:o + size, o:o + size],
            start=self.start + o,
            origin=self.origin,
            resolution=self.resolution,
        )

    def query_dist(self, p: torch.Tensor) -> torch.Tensor:
        """Nearest-cell clearance (S, Q) at world points (S, Q, 2)."""
        n = torch.round(self._local_frac(p)).to(torch.int64)
        return _gather2(self.dist.contiguous(), n[..., 1], n[..., 0])


def patch_start(dist_field, center: torch.Tensor, P: int) -> torch.Tensor:
    """(S, 2) int64 (ix, iy) global index of local cell (0, 0) of the P x P
    window around world points ``center`` (S, 2)."""
    cf = (center - dist_field.origin) / dist_field.resolution[:, None] - 0.5
    return torch.round(cf).to(torch.int64) - P // 2


def gather_window(d: torch.Tensor, start: torch.Tensor, P: int) -> torch.Tensor:
    """(S, P, P) clearance windows starting at ``start`` (S, 2) (ix, iy) of
    maps ``d`` (S, H, W), or of one shared (H, W) map; rows and columns
    outside the map clamp to its edge. Four operations on the card (a tick
    runs it): the window's columns and rows, their clamp, the flat index,
    the gather."""
    h, w = d.shape[-2:]
    S = start.shape[0]
    dev = d.device
    ii = constant(("arange", P), dev, lambda: torch.arange(P, device=dev))
    lo, hi = constant(("window_bounds", h, w), dev, lambda: (
        torch.zeros((2, 1), dtype=torch.int64, device=dev),
        torch.tensor([[w - 1], [h - 1]], dtype=torch.int64, device=dev)))
    cr = torch.clamp(start[:, :, None] + ii, min=lo, max=hi)  # (S, 2, P) columns, rows
    idx = torch.add(cr[:, 0, None, :], cr[:, 1, :, None], alpha=w)  # (S, P, P): iy w + ix
    flat = d.reshape(-1, h * w).expand(S, h * w)
    return torch.gather(flat, 1, idx.reshape(S, P * P)).reshape(S, P, P)


def gather_patch(d: torch.Tensor, start: torch.Tensor, P: int, origin: torch.Tensor,
                 resolution: torch.Tensor) -> PatchField:
    """:func:`gather_window` with the patch's gradient: its own central
    difference (one-sided at the PATCH edges, FAR plateau zeroed), never the
    global field's."""
    pd = gather_window(d, start, P)
    gx, gy = central_gradient(pd, resolution)
    return PatchField(dist=pd, grad=torch.stack([gx, gy], dim=-1), start=start,
                      origin=origin, resolution=resolution)


