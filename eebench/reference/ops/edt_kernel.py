"""Frozen from ``ergodic_exploration_tpu_torch/ops/edt_kernel.py`` at commit e20fa1114c5b:
the world rebuild's plain version (``world_plain``); ``world_fields`` is it.
"""

from __future__ import annotations

import torch

from eebench.reference.grid import Domain, GridMap
from eebench.reference.ops.distance import central_gradient, edt


def edt_field_plain(data: torch.Tensor, resolution: torch.Tensor, occupied_threshold: float):
    """E's plain version: (dist (..., h, w), grad (..., h, w, 2)) of the
    occupancy ``data`` (..., h, w) with ``resolution`` (...) or scalar."""
    d = edt(data >= occupied_threshold, resolution)
    gx, gy = central_gradient(d, resolution)
    return d, torch.stack([gx, gy], dim=-1)


def world_plain(grids: GridMap, dom: Domain, occupied_threshold: float, grid_samples):
    """E's plain version with the mask, the JAX ``_world_one`` of every map:
    (dist (S, h, w), grad (S, h, w, 2), free (S, nsx * nsy)), free 1.0 where
    the map's value at a lattice point of ``dom`` is under the threshold."""
    d, g = edt_field_plain(grids.data, grids.resolution, occupied_threshold)
    pts = dom.sample_lattice(grid_samples)
    return d, g, (grids.occupancy_at(pts) < occupied_threshold).to(torch.float32)



world_fields = world_plain
