"""Frozen from ``ergodic_exploration_tpu_torch/ops/gmm_kernel.py`` at commit e20fa1114c5b:
K2's plain version; ``phik_from_gmm`` is it.
"""

from __future__ import annotations

import torch

from eebench.reference.ops.target import GaussianMixture, gmm_eval


def phik_from_gmm_plain(means, covs, weights, pts, D, free_mask=None) -> torch.Tensor:
    """K2's plain PyTorch version: means (S, J, 2), covs (S, J, 2, 2),
    weights (S, J), pts (N, 2), D (N, K^2), free_mask (S, N) or None ->
    (S, K^2)."""
    phi = gmm_eval(pts, GaussianMixture(means, covs, weights))  # (S, N)
    if free_mask is not None:
        m = free_mask.to(phi.dtype)
        phi = phi * m
        fallback = torch.matmul(m, D) / torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    else:
        fallback = (D.sum(dim=0) / float(D.shape[0]))[None, :]
    tot = phi.sum(dim=-1, keepdim=True)
    ck = torch.matmul(phi, D) / torch.clamp(tot, min=1e-12)
    return torch.where(tot > 1e-12, ck, fallback)



phik_from_gmm = phik_from_gmm_plain
