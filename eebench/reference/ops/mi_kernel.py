"""Frozen from ``ergodic_exploration_tpu_torch/ops/mi_kernel.py`` at commit e20fa1114c5b:
K3's operands and plain version; ``phik_from_grid`` is it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eebench.reference.ops import basis
from eebench.reference.ops import target as target_ops

# constants of csrc/mi_kernel.cu that its shared-memory layout depends on
_WARPS, _KC, _RWIN = 8, 12, 3  # warps a block; coefficients a chunk; radius with a window


class MiOperands(NamedTuple):
    """What K3 needs beside the beliefs; shared by every scenario."""

    cxA: torch.Tensor  # (w, K) cosine table along x, lattice sampling folded in
    cyA: torch.Tensor  # (K, h) cosine table along y, lattice sampling folded in
    fallback: torch.Tensor  # (K, K) uniform target over the lattice
    hk00: torch.Tensor  # (1,) h_k at k = (0, 0): raw[0, 0] * hk00 is the target's mass


def mi_operands(g0, domain, K: int, grid_samples) -> MiOperands:
    """Operands of K3 for maps of ``g0``'s geometry (an unbatched GridMap;
    only its shape, origin and resolution are read) on the unbatched
    ``domain``."""
    nsx, nsy = grid_samples
    Ax, Ay = target_ops.sampling_one_hots(g0, grid_samples, domain)  # (ns, w), (ns, h)
    cosx, cosy = basis.axis_cos_tables(K, grid_samples, domain)
    ck = torch.full((K,), 0.5, dtype=torch.float32, device=cosx.device)
    ck[0] = 1.0
    sx = 1.0 / torch.sqrt(domain.lengths[0] * ck)
    sy = 1.0 / torch.sqrt(domain.lengths[1] * ck)
    cxA = torch.matmul(Ax.T, cosx * sx[None, :])  # (w, K)
    cyA = torch.matmul((cosy * sy[None, :]).T, Ay)  # (K, h)
    hk = basis.hk_norm(K, domain.lengths)
    fallback = (cosx.sum(dim=0)[:, None] * cosy.sum(dim=0)[None, :]) / (float(nsx * nsy) * hk)
    return MiOperands(cxA.contiguous(), cyA.contiguous(), fallback.contiguous(),
                      hk[0, 0].reshape(1).contiguous())


def _clamped_sum(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """out[i] = sum_{k=i-r..i+r} x[clip(k, 0, n-1)] along ``dim``, the terms
    added in ascending k (``blur_count_matrix``'s semantics as shifted adds)."""
    if radius <= 0:
        return x
    n = x.shape[dim]
    i = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    for d in range(-radius, radius + 1):
        out += x.index_select(dim, torch.clamp(i + d, 0, n - 1))
    return out


def phik_from_grid_plain(data, ops: MiOperands, sensor_radius_cells: int = 0,
                         frontier_cells: int = 0, occupied_threshold: float = 0.65,
                         eps: float = 1e-6) -> torch.Tensor:
    """K3's plain PyTorch version: beliefs ``data`` (S, h, w) -> (S, K, K)."""
    r, fc = sensor_radius_cells, frontier_cells
    p = torch.where(data < 0.0, torch.full_like(data, 0.5), data)
    e = target_ops.entropy(p, eps)
    t2 = _clamped_sum(_clamped_sum(e, r, -1), r, -2)
    keep = data < occupied_threshold
    if fc > 0:
        kf = ((data >= 0.0) & keep).to(torch.int32)
        keep = keep & (_clamped_sum(_clamped_sum(kf, fc, -1), fc, -2) > 0)
    vals = torch.clamp(torch.where(keep, t2, torch.zeros_like(t2)), min=0.0)
    w1 = torch.matmul(vals, ops.cxA)  # (S, h, K1)
    raw = torch.matmul(ops.cyA, w1).transpose(-1, -2)  # (S, K1, K2)
    total = (raw[:, 0, 0] * ops.hk00)[:, None, None]
    return torch.where(total > 1e-12, raw / torch.clamp(total, min=1e-12), ops.fallback)


phik_from_grid = phik_from_grid_plain
