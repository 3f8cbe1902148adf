"""Target distributions phi(x): Gaussian mixtures, and mutual-information /
entropy maps from an evolving occupancy grid (port of
``ergodic_exploration_tpu/ops/target.py``).

Every function takes leaves with leading scenario axes: a batch of maps
(S, H, W) with origins (S, 2) and resolutions (S,) goes through the same
code as one map (H, W). Nearest-cell lookups are gathers here; the index
arithmetic (round half to even, clamp to the map) is the reference's.
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


def normalize_phi(phi_vals, mask=None, eps: float = 1e-12):
    """Normalize sampled phi (..., N) to sum 1 over the (optional) mask;
    all-zero inputs fall back to uniform over the mask."""
    phi = torch.clamp(phi_vals, min=0.0)
    if mask is not None:
        m = mask.to(phi.dtype)
        phi = phi * m
        fallback = m / torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    else:
        fallback = torch.full_like(phi, 1.0 / phi.shape[-1])
    s = phi.sum(dim=-1, keepdim=True)
    return torch.where(s > eps, phi / torch.clamp(s, min=eps), fallback)


def gmm_target_values(points, gmm: GaussianMixture, free_mask=None):
    """phi values at sample points, normalized over the (masked) free space."""
    return normalize_phi(gmm_eval(points, gmm), mask=free_mask)


# ---------------------------------------------------------------------------
# mutual-information target from an occupancy grid
# ---------------------------------------------------------------------------


def entropy(p, eps: float = 1e-6):
    """Bernoulli cell entropy H(p) = -p log p - (1-p) log(1-p)."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))


def _box_blur_1d(img, radius: int, axis: int):
    """Edge-padded box blur along ``axis`` by cumulative sums."""
    if radius <= 0:
        return img
    n = img.shape[axis]
    x = img.movedim(axis, -1)
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], radius + 1), x,
                   x[..., -1:].expand(*x.shape[:-1], radius)], dim=-1)
    c = torch.cumsum(x, dim=-1)
    out = (c[..., 2 * radius + 1:2 * radius + 1 + n] - c[..., :n]) / (2 * radius + 1)
    return out.movedim(-1, axis)


def frontier_adjacency(grid, cells: int, occupied_threshold: float = 0.65):
    """0/1 mask (..., H, W) of the cells within ``cells`` (Chebyshev
    distance, edge-clamped windows) of a KNOWN-FREE cell: the reachable
    frontier of explored space."""
    kf = ((grid.data >= 0.0) & ~grid.occupied(occupied_threshold)).to(torch.float32)
    cnt = _box_blur_1d(_box_blur_1d(kf, cells, -1), cells, -2)
    return (cnt * float((2 * cells + 1) ** 2) > 0.5).to(torch.float32)


def mutual_information_map(grid, sensor_radius_cells: int = 0, frontier_cells: int = 0,
                           occupied_threshold: float = 0.65):
    """Per-cell information value (..., H, W): the entropy of the occupancy
    probability (unknown cells count 0.5), box-blurred over the sensor
    footprint, masked to the frontier when ``frontier_cells > 0``, and zeroed
    on occupied cells after the blur."""
    h = entropy(grid.prob())
    h = _box_blur_1d(_box_blur_1d(h, sensor_radius_cells, -1), sensor_radius_cells, -2)
    if frontier_cells > 0:
        h = h * frontier_adjacency(grid, frontier_cells, occupied_threshold)
    return torch.where(grid.occupied(occupied_threshold), torch.zeros_like(h), h)


def sample_map_at(values, grid, points):
    """Nearest-cell lookup of a per-cell map (..., H, W) at world points
    (..., N, 2) -> (..., N)."""
    h, w = grid.shape
    ij = grid.cell_index(points)
    flat = values.reshape(*values.shape[:-2], h * w)
    return torch.gather(flat, -1, ij[..., 1] * w + ij[..., 0])


def mi_target_values(grid, points, sensor_radius_cells: int = 0, frontier_cells: int = 0,
                     occupied_threshold: float = 0.65):
    """phi at sample points from the current occupancy grid, normalized to
    sum 1: the reference formulation the separable and dense paths are held
    against."""
    info = mutual_information_map(grid, sensor_radius_cells, frontier_cells,
                                  occupied_threshold)
    return normalize_phi(sample_map_at(info, grid, points))


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


def phik_from_grid_separable(grid, K: int, grid_samples, domain=None,
                             sensor_radius_cells: int = 0, eps: float = 1e-12,
                             frontier_cells: int = 0, occupied_threshold: float = 0.65):
    """MI target coefficients phi_k (..., K, K) from occupancy grids with
    their own geometry each. Equal (up to float32 reassociation) to

        normalize_phi(sample_map_at(info, grid, lattice)) -> basis.coefficients

    with the nearest-cell lattice sampling folded into the separable cosine
    contraction: sampling a separable lattice is a one-hot aggregation per
    axis, so

        raw[k1, k2] = sum_{r, c} info[r, c] Gx[c, k1] Gy[r, k2]
        Gx = Ax^T cosx (W, K),  Ax[i, c] = [nearest column of lattice x_i == c]

    ``raw[0, 0]`` is the normalizer (cos 0 = 1); all-zero information falls
    back to the uniform target over the lattice, as ``normalize_phi`` does.
    """
    from ergodic_exploration_tpu_torch.ops import basis

    info = mutual_information_map(grid, sensor_radius_cells, frontier_cells,
                                  occupied_threshold)
    dom = grid.domain() if domain is None else domain
    nsx, nsy = grid_samples
    h, w = grid.shape
    gx, gy, cx, cy = _lattice_cells(grid, grid_samples, dom)
    k = torch.arange(K, dtype=torch.float32, device=info.device)
    cosx = torch.cos((gx - dom.origin[..., 0:1])[..., :, None]
                     * (k * math.pi / dom.lengths[..., 0:1])[..., None, :])
    cosy = torch.cos((gy - dom.origin[..., 1:2])[..., :, None]
                     * (k * math.pi / dom.lengths[..., 1:2])[..., None, :])
    Gx = torch.matmul(_one_hot(cx, w).transpose(-1, -2), cosx)  # (..., W, K)
    Gy = torch.matmul(_one_hot(cy, h).transpose(-1, -2), cosy)  # (..., H, K)
    t1 = torch.matmul(info, Gx)  # (..., H, K1)
    raw = torch.matmul(t1.transpose(-1, -2), Gy)  # (..., K1, K2)
    hk = basis.hk_norm(K, dom.lengths)
    total = raw[..., 0:1, 0:1]
    ck = raw / (torch.clamp(total, min=eps) * hk)
    ck_u = (cosx.sum(dim=-2)[..., :, None] * cosy.sum(dim=-2)[..., None, :]) / (
        float(nsx * nsy) * hk)
    return torch.where(total > eps, ck, ck_u)


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


def lattice_resample(info, grid, grid_samples, domain):
    """Nearest-cell resampling of a per-cell map (H, W) onto the separable
    lattice of ``domain`` -> (nsx * nsy,), x-major:
    sampled[ix, iy] = info[row(iy), col(ix)], read by index."""
    nsx, nsy = grid_samples
    _, _, cx, cy = _lattice_cells(grid, grid_samples, domain)
    return info[cy[None, :], cx[:, None]].reshape(nsx * nsy)
