"""The gmapping cell (``omni_mi_gmapping4000``): its plain reference for
large maps, its hidden world, and its check, on the CPU at small sizes.

- ``reference/ops/edt_blocked.py`` gives the frozen world rebuild's bits
  (``edt_field_plain``, ``world_plain``) on seeded maps: odd shapes, empty
  and full maps, a batch, output blocks of 1, 7 and all rows;
- the tiled floor's clearance is the frozen EDT of the tiled building, and
  of the floor inside its free frame;
- through the cell's driver at a small ``scale`` (400 x 400 cells, two
  tiles, S = 2, 2 refreshes), the port, and the reference in its place, come
  out correct, and each fault of ``test_eebench_faults.py`` fails the cell,
  as does a wrong world rebuild (distances one cell long, or the free mask
  flipped) on which the robots' poses and metric still agree;
- on the card, the TF32 control is not correct at the cell's own size.
"""

import numpy as np
import pytest
import torch

from eebench import gen, harness, program
from eebench.drivers.mapping_gmapping import tiled_floor
from eebench.reference.grid import Domain, GridMap
from eebench.reference.ops import edt_blocked, edt_kernel
from eebench.reference.ops.distance import edt as frozen_edt
from test_eebench_faults import _StaleTarget, _program

CELL = "omni_mi_gmapping4000"
SCALE = {"scenarios": 2, "samples": 1, "refreshes": 2, "check_rows": 2, "cells": 400,
         "building_tiles": 2}
SHAPES = [(13, 29), (30, 17), (2, 5), (3, 33, 21)]


def _maps(shape, density, seed=0):
    g = np.random.default_rng([seed, *shape, int(1000 * density)])
    return torch.from_numpy((g.random(shape) < density).astype(np.float32))


@pytest.mark.parametrize("block", [1, 7, None])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.4, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_blocked_field_is_the_frozen_fields_bits(shape, density, block):
    data = _maps(shape, density)
    res = torch.full(shape[:-2], 0.05) if len(shape) > 2 else torch.tensor(0.05)
    got = edt_blocked.edt_field_plain(data, res, 0.65, block)
    want = edt_kernel.edt_field_plain(data, res, 0.65)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("block", [1, 7, None])
def test_blocked_world_is_the_frozen_worlds_bits(block):
    S, h, w = 3, 37, 26
    data = _maps((S, h, w), 0.05, seed=1) * 0.9 + _maps((S, h, w), 0.2, seed=2) * 0.5
    grids = GridMap(data, torch.tensor([[0.0, 0.0], [0.3, -0.2], [1.0, 2.0]]),
                    torch.tensor([0.05, 0.05, 0.1]))
    dom = grids.domain()
    got = edt_blocked.world_plain(grids, dom, 0.65, (9, 7), block)
    want = edt_kernel.world_plain(grids, dom, 0.65, (9, 7))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_tiled_clearance_is_the_edt_of_the_tiled_building():
    building = gen.building()
    tiled = np.tile(building, (2, 2))
    assert np.array_equal(np.tile(gen.clearance(building, 0.05), (2, 2)),
                          gen.clearance(tiled, 0.05))
    truth, clear, lo, hi = tiled_floor(260, 2, 0.05)
    assert (lo, hi) == (30, 230) and np.array_equal(truth[lo:hi, lo:hi], tiled)
    assert not truth[:lo].any() and not truth[hi:].any()
    d = frozen_edt(torch.from_numpy(truth) >= 0.65, torch.tensor(0.05)).numpy()
    assert np.array_equal(clear[lo:hi, lo:hi], d[lo:hi, lo:hi])
    assert not clear[:lo].any() and not clear[:, hi:].any()


def _run(prog, seed=20251018, scale=SCALE):
    torch.manual_seed(0)
    r = harness.run_cell(CELL, seed, 0.2, False, "cpu", prog, scale=scale)
    assert r["attempted"] >= 1
    return r, {n: c for n, c in r["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("prog", ["port", "reference"])
def test_the_check_passes_the_port_and_the_reference(prog):
    r, failed = _run(program.port() if prog == "port" else program.reference(), 2**33 + 5)
    assert r["correct"] and not failed, r["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "stale"])
def test_check_catches_the_fault(fault):
    if fault == "stale":
        port = program.port()
        prog = port._replace(make_engine=lambda d, dev: _StaleTarget(port.make_engine(d, dev)))
    else:
        prog = _program(fault)
    r, failed = _run(prog, scale=dict(SCALE, cells=300))
    assert not r["correct"] and failed, (fault, r["checks"])


def _wrong_world(engine, fault):
    """The port's engine with its world rebuild (the refresh's and
    ``prepare_world``'s) broken by ``fault``."""
    built = engine._world_batched

    def wrong(grids, dom):
        w = built(grids, dom)
        if fault == "dist_one_cell":
            return w._replace(dist=w.dist._replace(
                dist=w.dist.dist + grids.resolution[:, None, None]))
        return w._replace(free_mask=1.0 - w.free_mask)

    engine._world_batched = wrong
    return engine


@pytest.mark.parametrize("fault", ["dist_one_cell", "free_flipped"])
def test_check_catches_a_wrong_world(fault):
    port = program.port()
    prog = port._replace(make_engine=lambda d, dev: _wrong_world(port.make_engine(d, dev), fault))
    r, failed = _run(prog, scale=dict(SCALE, cells=300))
    assert not r["correct"] and "world_cells_off" in failed, (fault, r["checks"])


@pytest.mark.chip
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 987654321013])
def test_control_is_not_correct(cuda, seed):
    r = harness.run_cell(CELL, seed, 1.0, False, cuda, program.reference(tf32=True))
    assert not r["correct"], r["checks"]
