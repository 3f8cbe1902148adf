"""The roofline counts of ``eebench/work`` on small shapes against counts
made by hand from each docstring's recipe."""

import math

import pytest
import torch

from eebench.work import edt, k1_refresh, k1_solve, k3, least_seconds, m, reveal


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_k1_refresh():
    cfg = {"num_basis": 2, "grid_samples": [2, 2]}
    # S 2, N 4, nsy 2, K 2, J 1: 2 * (4 * (14 + 2 + 2 * 2) + 2 * 2 * 4 + 2 * 4) flops
    assert k1_refresh.count(cfg, 2, {"gmm_components": 1}) == (
        208, 4 * (2 * 7 + 2 + 2 + 4 + 4 * 2 + 2 * 4 + 2 * 4))


def test_k1_solve_one_knot():
    cfg = {"horizon": 1, "num_basis": 1, "model": "cart"}
    facts = {"drawn_history": 0, "validation_probes": 0, "dwa_probes": 0, "dwa_candidates": 0,
             "map_cells": 0}
    # rollout 3 + 4*5 + 18 + 18 + 3 = 62; tables 6; c_k 2 + 2 + metric 4; gradient 3 + 10;
    # barrier 70, co-state 140, update 18; append 2 + 4
    flops, nbytes = k1_solve.count(cfg, 1, facts)
    assert flops == 62 + 6 + 8 + 13 + 228 + 6
    # in: 3 + 2 + 1 + 1 + 1 + 1 + 3 + 9; out: 2 + 1 + 1 + 1 + 1 + 2 + 1
    assert nbytes == 4 * (21 + 9)
    facts.update(drawn_history=2, validation_probes=10, dwa_probes=4, dwa_candidates=3,
                 map_cells=5)
    f2, b2 = k1_solve.count(cfg, 1, facts)
    assert f2 == flops + 2 * (4 + 2) + 25 * 14 + 10 * 2 * 3
    assert b2 == nbytes + 4 * (4 - 1) + 4 * 5


def test_k3():
    cfg = {"num_basis": 1, "mi_frontier_cells": 1}
    per_cell = 10 + 3 + 2 * 3 + 2 * 3 + 2 + 2  # r = 1, fc = 1, K = 1
    assert k3.count(cfg, 1, {"map_shape": (2, 3), "sensor_radius_cells": 1}) == (
        6 * per_cell + 2 * 2 + 2, 4 * (6 + 3 + 2 + 1 + 1 + 1))


def test_m():
    cfg = {"num_basis": 1, "grid_samples": [2, 1], "mi_frontier_cells": 0}
    facts = {"sensor_radius_cells": 0, "m_cells": 4, "m_nonzero": 3}
    assert m.count(cfg, 1, facts) == (13 * 4 + 2 * (2 + 2) + 2 + 3 + 2 * 3,
                                      4 * (4 + 2 + 1 + 3 + 2 + 1))


def test_edt():
    cfg = {"grid_samples": [1, 2]}
    assert edt.count(cfg, 2, {"map_shape": (2, 2)}) == (2 * (4 * 33 + 10),
                                                         2 * (16 + 4 + 48 + 8))


def test_reveal_count_and_facts():
    facts = {"window_cells": 3, "reveal_occupied": 2, "reveal_blocked_bins": 5}
    assert reveal.count({}, 1, facts) == (9 * 19 + 4 + 15, 4 * 27 + 12)
    truth = torch.zeros((1, 9, 9))
    truth[0, 4, 6] = 1.0  # one occupied cell two cells east of the pose's cell
    pose = torch.tensor([[4.5, 4.5, 0.0]])
    got = reveal.facts_from(truth, pose, 1.0, 5, 8, 0.65)
    assert got["reveal_occupied"] == 1 and got["window_cells"] == 5
    # at 2 cells the cell subtends +-atan(0.55 / 2) = +-0.268 rad about angle 0; of the 8
    # bins (centres at -7pi/8 .. 7pi/8, pi/4 apart) none lies inside
    assert got["reveal_blocked_bins"] == 0
    got = reveal.facts_from(truth, pose, 1.0, 5, 64, 0.65)
    # 64 bins of pi/32: the centres at +-pi/64 and +-3pi/64 lie inside +-0.268
    assert got["reveal_blocked_bins"] == sum(
        1 for j in range(64) if abs((j + 0.5) * 2 * math.pi / 64 - math.pi) <= math.atan(0.275))


def test_m_facts_on_unknown_and_known_beliefs():
    from eebench.reference.grid import Domain, GridMap
    from eebench.reference.ops.mi_dense_kernel import dense_operands

    cfg = {"num_basis": 3, "grid_samples": [4, 4], "mi_frontier_cells": 1,
           "occupied_threshold": 0.65}
    unknown = torch.full((2, 8, 8), -1.0)
    g0 = GridMap(unknown[0], torch.zeros(2), torch.tensor(1.0))
    ops = dense_operands(g0, Domain(torch.zeros(2), torch.tensor([8.0, 8.0])), 3, (4, 4))
    got = m.facts_from(unknown, ops, cfg, 0)
    assert got["m_nonzero"] == 0  # no known-free cell: no frontier
    assert got["m_cells"] == 64  # boxes of one cell around a 4 x 4 lattice on 8 x 8
    half = unknown.clone()
    half[:, :, :4] = 0.0  # the left half known free: the frontier's lattice points count
    assert m.facts_from(half, ops, cfg, 0)["m_nonzero"] > 0
