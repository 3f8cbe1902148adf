"""M, the dense MI target of the mapping refresh (``m_phik_dense``,
``m_columns``, ``m_finish``), one launch a refresh.

Counted from the algorithm, per scenario: the entropy and the free and
known tests of each map cell that a lattice point's box reads (13 each);
per lattice point the sensor box sum (2 (2r + 1)), the frontier count
(2 (2 fc + 1), with fc > 0) and the masks (2); the separable contraction of
the lattice values with the cosine tables, 2 K for each value that is not
0 (what these beliefs need: ``facts["m_nonzero"]``, counted on the
reference's lattice values of the cell's beliefs) and 2 K^2 per lattice
row; the normalisation (3 K^2). Bytes: the map cells read, the lattice's
cell indices, the two cosine tables, h_k, the fallback and the result once.
"""


def count(cfg: dict, S: int, facts: dict):
    K = cfg["num_basis"]
    nsx, nsy = cfg["grid_samples"]
    r, fc = facts["sensor_radius_cells"], cfg["mi_frontier_cells"]
    cells = facts["m_cells"]  # map cells the lattice's boxes read, per scenario
    per_point = 2 * (2 * r + 1) + (2 * (2 * fc + 1) if fc else 0) + 2
    flops = (S * (13 * cells + nsx * nsy * per_point + nsy * 2 * K * K + 3 * K * K)
             + 2 * K * facts["m_nonzero"])
    nbytes = 4 * (S * cells + nsx + nsy + (nsx + nsy) * K + 2 * K * K + S * K * K)
    return flops, nbytes


def facts_from(beliefs, ops, cfg: dict, r: int) -> dict:
    """``m_nonzero`` (lattice values not 0, summed over the scenarios) and
    ``m_cells`` (map cells within max(r, fc) cells of a lattice point's
    cell, per scenario) of the beliefs (S, h, w) on the reference's side."""
    import torch

    from eebench.reference.grid import Domain, GridMap
    from eebench.reference.ops.mi_dense_kernel import dense_operands, dense_values_plain

    S, h, w = beliefs.shape
    res = beliefs.new_full((), 1.0)
    g0 = GridMap(beliefs[0], beliefs.new_zeros(2), res)
    dom = Domain(beliefs.new_zeros(2), torch.tensor([float(w), float(h)], device=beliefs.device))
    ops = dense_operands(g0, dom, cfg["num_basis"], tuple(cfg["grid_samples"]))
    vals = dense_values_plain(beliefs, ops, r, cfg["mi_frontier_cells"],
                              cfg["occupied_threshold"])
    m = max(r, cfg["mi_frontier_cells"])

    def span(idx, n):
        off = torch.arange(-m, m + 1, device=idx.device)
        return int(torch.unique((idx.long()[:, None] + off).clamp(0, n - 1)).numel())

    return {"m_nonzero": int((vals != 0).sum()), "m_cells": span(ops.cy, h) * span(ops.cx, w)}
