"""Frozen from ``ergodic_exploration_tpu_torch/ops/basis.py`` at commit e20fa1114c5b:
the cosine basis, its coefficients and the ergodic metric and gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from eebench.reference.grid import rows
from eebench.reference.utils.device import constant


def lambda_weights(K: int, device=None) -> torch.Tensor:
    """Sobolev weights Lambda_k = (1 + ||k||^2)^(-3/2); (K, K)."""
    k = torch.arange(K, dtype=torch.float32, device=device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    return (1.0 + k2) ** -1.5


def hk_norm(K: int, lengths: torch.Tensor) -> torch.Tensor:
    """L2 normalization h_k; lengths (..., 2) -> (..., K, K). The factors
    c(k) are a constant of (K, device), made once; the rest is arithmetic on
    the device."""
    def make():
        c = torch.full((K,), 0.5, dtype=torch.float32, device=lengths.device)
        c[0] = 1.0
        return c

    c = constant(("hk_c", K), lengths.device, make)
    area = (lengths[..., 0] * lengths[..., 1])[..., None, None]
    return torch.sqrt(area * c[:, None] * c[None, :])


class BasisTables(NamedTuple):
    """Per-point separable cos/sin tables and angular frequencies."""

    Cx: torch.Tensor  # (..., N, K)
    Sx: torch.Tensor  # (..., N, K)
    Cy: torch.Tensor  # (..., N, K)
    Sy: torch.Tensor  # (..., N, K)
    f1: torch.Tensor  # (..., K)
    f2: torch.Tensor  # (..., K)


def _angles(points, K, domain):
    rel = points - rows(domain.origin)
    a = math.pi / domain.lengths  # (..., 2)
    k = torch.arange(K, dtype=points.dtype, device=points.device)
    f1 = k * a[..., 0:1]
    f2 = k * a[..., 1:2]
    return rel[..., 0:1] * rows(f1), rel[..., 1:2] * rows(f2), f1, f2


def tables(points, K: int, domain) -> BasisTables:
    """cos/sin tables for points (..., N, 2) on ``domain`` (origin (..., 2))."""
    ax, ay, f1, f2 = _angles(points, K, domain)
    return BasisTables(torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay), f1, f2)


def cos_tables(points, K: int, domain):
    """(Cx, Cy) only — for coefficient reductions."""
    ax, ay, _, _ = _angles(points, K, domain)
    return torch.cos(ax), torch.cos(ay)


def coefficients_cos(Cx, Cy, weights, hk):
    """Weighted basis expectation from cos tables alone; (..., K, K)."""
    wc = Cx * weights[..., None]
    return torch.matmul(wc.transpose(-1, -2), Cy) / hk


def coefficients(tbl: BasisTables, weights, hk):
    """sum_n w_n F_k(p_n); (..., K, K)."""
    return coefficients_cos(tbl.Cx, tbl.Cy, weights, hk)


def fourier_basis_at(tbl: BasisTables, hk):
    """Dense F_k per point: (..., N, K, K)."""
    return (tbl.Cx[..., :, None] * tbl.Cy[..., None, :]) / hk[..., None, :, :]


def dense_table(tbl: BasisTables, hk):
    """Flattened dense basis table D[n, k1*K + k2] = F_k(p_n): (N, K^2)."""
    N, K = tbl.Cx.shape[-2:]
    return fourier_basis_at(tbl, hk).reshape(*tbl.Cx.shape[:-2], N, K * K)


def axis_cos_tables(K: int, grid_samples, domain):
    """Per-axis lattice cosine tables (cosx (nsx, K), cosy (nsy, K)) of the
    separable lattice of ``Domain.sample_lattice`` on an unbatched domain:
    the inputs of :func:`coefficients_separable`."""
    nsx, nsy = grid_samples
    dev = domain.lengths.device
    k = torch.arange(K, dtype=torch.float32, device=dev)
    fx = (torch.arange(nsx, dtype=torch.float32, device=dev) + 0.5) / nsx * domain.lengths[0]
    fy = (torch.arange(nsy, dtype=torch.float32, device=dev) + 0.5) / nsy * domain.lengths[1]
    cosx = torch.cos(fx[:, None] * (k * math.pi / domain.lengths[0])[None, :])
    cosy = torch.cos(fy[:, None] * (k * math.pi / domain.lengths[1])[None, :])
    return cosx, cosy


def coefficients_separable(phi_grid, cosx, cosy, hk):
    """Raw basis contraction on a separable lattice:
    ck_raw[s, k1, k2] = sum_{ix, iy} phi[s, ix, iy] cosx[ix, k1] cosy[iy, k2] / hk,
    as two small matmuls. ``phi_grid`` (S, nsx, nsy) is the x-major reshape
    of the (S, N) lattice values; ``ck_raw[s, 0, 0] * hk[0, 0]`` is sum(phi)."""
    A = torch.matmul(phi_grid, cosy)  # (S, nsx, K2)
    ck = torch.matmul(cosx.transpose(-1, -2), A)  # (S, K1, K2)
    return ck / hk


def coefficients_dense(phi_batch, D, K: int):
    """(S, N) @ (N, K^2) -> (S, K, K) in float32."""
    return torch.matmul(phi_batch, D).reshape(phi_batch.shape[0], K, K)


def ergodic_metric(ck, phik, lam):
    """E = sum_k Lambda_k (c_k - phi_k)^2 over the last two axes."""
    d = ck - phik
    return (lam * d * d).sum(dim=(-2, -1))


def ergodic_gradient(tbl: BasisTables, ck, phik, lam, hk, M):
    """dE/dp_m = (2/M) sum_k Lambda_k (c_k - phi_k) grad F_k(p_m); (..., N, 2).

    ``M`` (...,) is the total state count behind c_k.
    """
    Wh = (lam * (ck - phik)) / hk  # (..., K, K)
    scale = (2.0 / M)[..., None]
    Px = torch.matmul(tbl.Cy, Wh.transpose(-1, -2))  # (..., N, K1)
    ex = -scale * (tbl.Sx * rows(tbl.f1) * Px).sum(dim=-1)
    Py = torch.matmul(tbl.Cx, Wh)  # (..., N, K2)
    ey = -scale * (tbl.Sy * rows(tbl.f2) * Py).sum(dim=-1)
    return torch.stack([ex, ey], dim=-1)
