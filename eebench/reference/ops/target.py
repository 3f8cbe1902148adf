"""Frozen from ``ergodic_exploration_tpu_torch/ops/target.py`` at commit e20fa1114c5b:
the GMM and mutual-information targets.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GaussianMixture(NamedTuple):
    """GMM target; leaves may carry a leading scenario axis."""

    means: torch.Tensor  # (..., J, 2)
    covs: torch.Tensor  # (..., J, 2, 2)
    weights: torch.Tensor  # (..., J)

    @staticmethod
    def create(means, covs, weights=None, device=None) -> "GaussianMixture":
        means = torch.as_tensor(means, dtype=torch.float32, device=device)
        covs = torch.as_tensor(covs, dtype=torch.float32, device=device)
        if covs.dim() == means.dim():  # diagonal covariances given as (..., J, 2)
            covs = torch.diag_embed(covs)
        if weights is None:
            weights = torch.ones(means.shape[:-1], dtype=torch.float32, device=device)
        return GaussianMixture(means, covs,
                               torch.as_tensor(weights, dtype=torch.float32, device=device))


def gmm_eval(points, gmm: GaussianMixture):
    """Unnormalized GMM density at points (N, 2) shared by all mixtures, or
    (..., N, 2) per mixture, -> (..., N) for mixtures with leading axes (...)."""
    d = points[..., :, None, :] - gmm.means[..., None, :, :]  # (..., N, J, 2)
    a = gmm.covs[..., 0, 0][..., None, :]
    b = gmm.covs[..., 0, 1][..., None, :]
    c = gmm.covs[..., 1, 1][..., None, :]
    det = a * c - b * b
    inv_det = 1.0 / det
    dx, dy = d[..., 0], d[..., 1]
    q = (c * dx ** 2 - 2.0 * b * dx * dy + a * dy ** 2) * inv_det
    norm = gmm.weights[..., None, :] / (2.0 * math.pi * torch.sqrt(det))
    return (norm * torch.exp(-0.5 * q)).sum(dim=-1)


# ---------------------------------------------------------------------------
# mutual-information target from an occupancy grid
# ---------------------------------------------------------------------------


def entropy(p, eps: float = 1e-6):
    """Bernoulli cell entropy H(p) = -p log p - (1-p) log(1-p)."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))


def _lattice_cells(grid, grid_samples, domain):
    """Per-axis lattice coordinates of ``domain`` and the nearest cell of
    ``grid`` to each (half-to-even rounding, clamped): gx (..., nsx),
    gy (..., nsy), cx (..., nsx), cy (..., nsy), the cells as int64."""
    h, w = grid.shape
    nsx, nsy = grid_samples
    dev = grid.data.device
    fx = (torch.arange(nsx, dtype=torch.float32, device=dev) + 0.5) / nsx
    fy = (torch.arange(nsy, dtype=torch.float32, device=dev) + 0.5) / nsy
    gx = domain.origin[..., 0:1] + fx * domain.lengths[..., 0:1]
    gy = domain.origin[..., 1:2] + fy * domain.lengths[..., 1:2]
    res = grid.resolution[..., None]
    cx = torch.clamp(torch.round((gx - grid.origin[..., 0:1]) / res - 0.5), 0.0, w - 1.0)
    cy = torch.clamp(torch.round((gy - grid.origin[..., 1:2]) / res - 0.5), 0.0, h - 1.0)
    return gx, gy, cx.to(torch.int64), cy.to(torch.int64)


def _one_hot(cells, n: int):
    """(..., ns) cell indices -> (..., ns, n) float one-hot rows."""
    return (cells[..., None] == torch.arange(n, device=cells.device)).to(torch.float32)


def blur_count_matrix(n: int, radius: int, dtype=torch.float32, device=None):
    """(n, n) small-integer counts C with (C @ v)[i] = sum_{k=i-r}^{i+r}
    v[clip(k, 0, n-1)]: the edge-padded box blur times (2r+1)."""
    if radius <= 0:
        return torch.eye(n, dtype=dtype, device=device)
    i = torch.arange(n, device=device)
    B = ((i[:, None] - i[None, :]).abs() <= radius).to(dtype)
    B[:, 0] = torch.clamp(radius - i + 1, min=0).to(dtype)
    B[:, -1] = torch.clamp(i + radius - (n - 1) + 1, min=0).to(dtype)
    return B


def sampling_one_hots(grid, grid_samples, domain):
    """One-hot nearest-cell sampling matrices (Ax (nsx, W), Ay (nsy, H)) from
    the separable lattice of ``domain`` into ``grid``'s cells. A lattice
    point exactly on a half-cell boundary makes the round depend on the last
    bit of the division; geometries whose lattice divides the cell size
    evenly are safe."""
    h, w = grid.shape
    _, _, cx, cy = _lattice_cells(grid, grid_samples, domain)
    return _one_hot(cx, w), _one_hot(cy, h)


