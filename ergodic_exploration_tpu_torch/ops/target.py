"""Gaussian-mixture target distributions phi(x) (port of the GMM half of
``ergodic_exploration_tpu/ops/target.py``). The mutual-information half is
not ported yet (see ROADMAP.md)."""

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
