"""Frozen from ``ergodic_exploration_tpu_torch/ops/mi_dense_kernel.py`` at commit e20fa1114c5b:
M's operands and plain version; ``phik_dense`` is it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eebench.reference.ops import basis
from eebench.reference.ops import target as target_ops

# constants of csrc/mi_dense_kernel.cu that its memory layout and grid depend on
_TS, _KC, _NV = 16, 128, 128  # scenarios, coefficients a block; lattice columns a pass of vals
# a launch's kernel (the source's modes): one tile's whole target; the values
# once, into device memory; a tile's contraction of those values
FUSED, VALUES, CONTRACT = 0, 1, 2


class DenseOperands(NamedTuple):
    """What M and its plain version need beside the beliefs; shared by every
    scenario."""

    cx: torch.Tensor  # (nsx,) int32 nearest map column of each lattice column
    cy: torch.Tensor  # (nsy,) int32 nearest row of each lattice row
    D: torch.Tensor  # (nsx * nsy, K^2) dense basis table of the lattice, x-major (plain version)
    fallback: torch.Tensor  # (K, K) the uniform target over the lattice
    cosx: torch.Tensor  # (nsx, K) the lattice's x cosines: D[ix nsy + iy] = cosx[ix] cosy[iy] / hk
    cosy: torch.Tensor  # (nsy, K) its y cosines
    hk: torch.Tensor  # (K, K) the basis normalization h_k: raw[0] hk[0, 0] is the target's mass


def dense_operands(g0, domain, K: int, grid_samples) -> DenseOperands:
    """Operands of M for maps of ``g0``'s geometry (an unbatched GridMap;
    only its shape, origin and resolution are read) on the unbatched
    ``domain``: D and the per-axis tables D is the product of (the same
    floats)."""
    nsy = grid_samples[1]
    pts = domain.sample_lattice(grid_samples)
    hk = basis.hk_norm(K, domain.lengths)
    tbl = basis.tables(pts, K, domain)
    D = basis.dense_table(tbl, hk)
    _, _, cx, cy = target_ops._lattice_cells(g0, grid_samples, domain)
    fallback = (D.sum(dim=0) / float(pts.shape[0])).view(K, K)
    return DenseOperands(cx.to(torch.int32).contiguous(), cy.to(torch.int32).contiguous(),
                         D.contiguous(), fallback.contiguous(), tbl.Cx[::nsy].contiguous(),
                         tbl.Cy[:nsy].contiguous(), hk.contiguous())


def dense_values_plain(data, ops: DenseOperands, sensor_radius_cells: int = 0,
                       frontier_cells: int = 0, occupied_threshold: float = 0.65):
    """(S, nsx * nsy) lattice values of the beliefs ``data`` (S, h, w), x-major:
    the per-scenario entropy map resampled with the sensor-footprint blur
    folded into the sampling matrices (the box blur is linear, so
    blur-then-sample is one small-integer count matrix per axis and the
    (2r+1)^2 scale cancels in the normalization). The free mask and the
    frontier count are sampled the same way and applied at the lattice:
    nearest-cell sampling commutes with elementwise products and monotone
    thresholds. Float32 matmuls with TF32 off throughout."""
    r, fc = sensor_radius_cells, frontier_cells
    nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
    h, w = data.shape[-2:]
    dev = data.device
    Ax, Ay = target_ops._one_hot(ops.cx, w), target_ops._one_hot(ops.cy, h)
    Axb = torch.matmul(Ax, target_ops.blur_count_matrix(w, r, device=dev))  # (nsx, w)
    Ayb = torch.matmul(Ay, target_ops.blur_count_matrix(h, r, device=dev))  # (nsy, h)

    def sampled(field, Mx, My):
        """(S, h, w) cell field -> (S, nsx, nsy): Mx field^T My^T."""
        t1 = torch.matmul(field, Mx.T)  # (S, h, nsx)
        return torch.matmul(t1.transpose(1, 2), My.T)

    occupied = data >= occupied_threshold
    prob = torch.where(data < 0.0, torch.full_like(data, 0.5), data)
    vals = sampled(target_ops.entropy(prob), Axb, Ayb)
    zs = sampled((~occupied).to(torch.float32), Ax, Ay)
    if fc > 0:
        kf = ((data >= 0.0) & ~occupied).to(torch.float32)
        Axf = torch.matmul(Ax, target_ops.blur_count_matrix(w, fc, device=dev))
        Ayf = torch.matmul(Ay, target_ops.blur_count_matrix(h, fc, device=dev))
        zs = zs * (sampled(kf, Axf, Ayf) > 0.5).to(zs.dtype)
    return torch.clamp((vals * zs).reshape(-1, nsx * nsy), min=0.0)  # (S, N)


def phik_dense_plain(data, ops: DenseOperands, sensor_radius_cells: int = 0,
                     frontier_cells: int = 0, occupied_threshold: float = 0.65) -> torch.Tensor:
    """M's plain PyTorch version: beliefs ``data`` (S, h, w) -> (S, K, K),
    :func:`dense_values_plain` then one (S, N) @ (N, K^2) contraction."""
    K = ops.fallback.shape[-1]
    vals = dense_values_plain(data, ops, sensor_radius_cells, frontier_cells,
                              occupied_threshold)
    ck_raw = basis.coefficients_dense(vals, ops.D, K)
    total = (ck_raw[:, 0, 0] * ops.hk[0, 0])[:, None, None]  # scaled sum: the scale cancels
    return torch.where(total > 1e-12, ck_raw / torch.clamp(total, min=1e-12), ops.fallback)


phik_dense = phik_dense_plain
