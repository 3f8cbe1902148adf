"""Frozen from ``ergodic_exploration_tpu_torch/grid.py`` at commit e20fa1114c5b:
the domain and the occupancy grid.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

UNKNOWN = -1.0  # belief value of a cell no sensor has seen


def rows(v: torch.Tensor) -> torch.Tensor:
    """Per-map (..., 2) vector broadcast against points (..., N, 2)."""
    return v.unsqueeze(-2)


def lattice_fractions(n: int, device) -> torch.Tensor:
    """(n,) float32 cell centres (k + 0.5) / n of a lattice axis, by the
    expression of :meth:`Domain.sample_lattice` on ``device`` (the EDT
    kernel's free mask takes them from here: a division by a Python number
    rounds otherwise on another device)."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


class Domain(NamedTuple):
    """Rectangular exploration domain [x0, x0+Lx] x [y0, y0+Ly]."""

    origin: torch.Tensor  # (..., 2) = (x0, y0)
    lengths: torch.Tensor  # (..., 2) = (Lx, Ly)

    @staticmethod
    def create(x0: float, y0: float, lx: float, ly: float, device=None) -> "Domain":
        return Domain(
            origin=torch.tensor([x0, y0], dtype=torch.float32, device=device),
            lengths=torch.tensor([lx, ly], dtype=torch.float32, device=device),
        )

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        """True where points (..., N, 2) lie inside the domain."""
        rel = p - rows(self.origin)
        return ((rel >= 0.0) & (rel <= rows(self.lengths))).all(dim=-1)

    def sample_lattice(self, shape: Tuple[int, int]) -> torch.Tensor:
        """Cell-centred (..., nsx * nsy, 2) lattice of each domain, x-major."""
        nsx, nsy = shape
        dev = self.origin.device
        fx, fy = lattice_fractions(nsx, dev), lattice_fractions(nsy, dev)
        gx = self.origin[..., 0:1] + fx * self.lengths[..., 0:1]  # (..., nsx)
        gy = self.origin[..., 1:2] + fy * self.lengths[..., 1:2]  # (..., nsy)
        lead = gx.shape[:-1]
        xx = gx[..., :, None].expand(*lead, nsx, nsy)
        yy = gy[..., None, :].expand(*lead, nsx, nsy)
        return torch.stack([xx.reshape(*lead, -1), yy.reshape(*lead, -1)], dim=-1)


class GridMap(NamedTuple):
    """Occupancy grid: ``data`` in {-1 (unknown)} U [0, 1] (occupancy prob)."""

    data: torch.Tensor  # (..., H, W) float32
    origin: torch.Tensor  # (..., 2) world coords of the (0, 0) cell corner
    resolution: torch.Tensor  # (...) meters per cell

    @staticmethod
    def create(data, x0: float = 0.0, y0: float = 0.0, resolution: float = 0.05,
               device=None) -> "GridMap":
        return GridMap(
            data=torch.as_tensor(data, dtype=torch.float32, device=device),
            origin=torch.tensor([x0, y0], dtype=torch.float32, device=device),
            resolution=torch.tensor(resolution, dtype=torch.float32, device=device),
        )

    @staticmethod
    def from_ros(int8_data, x0: float, y0: float, resolution: float, device=None) -> "GridMap":
        """A map from ROS ``nav_msgs/OccupancyGrid`` int8 data: -1 stays
        UNKNOWN, 0..100 becomes the probability 0..1."""
        raw = torch.as_tensor(int8_data, device=device).to(torch.float32)
        data = torch.where(raw < 0.0, torch.full_like(raw, UNKNOWN), raw / 100.0)
        return GridMap.create(data, x0, y0, resolution, device=device)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape[-2:])

    def domain(self) -> Domain:
        """The exploration domain spanned by this map."""
        h, w = self.shape
        return Domain(origin=self.origin,
                      lengths=torch.stack([w * self.resolution, h * self.resolution], dim=-1))

    def world_to_grid(self, p: torch.Tensor) -> torch.Tensor:
        """World points (..., N, 2) -> fractional (ix, iy) indices."""
        return (p - rows(self.origin)) / self.resolution[..., None, None] - 0.5

    def grid_to_world(self, idx) -> torch.Tensor:
        """(ix, iy) indices (..., N, 2) -> world coordinates of the cell
        centres."""
        idx = torch.as_tensor(idx, device=self.origin.device).to(torch.float32)
        return rows(self.origin) + (idx + 0.5) * self.resolution[..., None, None]

    def cell_index(self, p: torch.Tensor) -> torch.Tensor:
        """World points -> integer (ix, iy), clamped to the map (half-even
        rounding, as ``jnp.round``)."""
        h, w = self.shape
        ij = torch.round(self.world_to_grid(p)).to(torch.int64)
        return torch.stack([ij[..., 0].clamp(0, w - 1), ij[..., 1].clamp(0, h - 1)], dim=-1)

    def occupancy_at(self, p: torch.Tensor) -> torch.Tensor:
        """Raw occupancy value at world points (..., N, 2)."""
        h, w = self.shape
        ij = self.cell_index(p)
        flat = self.data.reshape(*self.data.shape[:-2], h * w)
        return torch.gather(flat, -1, ij[..., 1] * w + ij[..., 0])

    def prob(self) -> torch.Tensor:
        """Occupancy probability with unknown cells at 0.5."""
        return torch.where(self.data < 0.0, torch.full_like(self.data, 0.5), self.data)

    def known(self) -> torch.Tensor:
        """Cells some sensor has seen."""
        return self.data >= 0.0

    def occupied(self, threshold: float = 0.65) -> torch.Tensor:
        """Obstacle mask; unknown cells are NOT obstacles."""
        return self.data >= threshold

    def free(self, threshold: float = 0.2) -> torch.Tensor:
        """Known cells at or below the free-space probability ``threshold``."""
        return (self.data >= 0.0) & (self.data <= threshold)
