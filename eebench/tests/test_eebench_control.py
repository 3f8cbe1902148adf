"""The control comes out not correct: the plain reference in the nearest
precision below the configuration's (float32 with TF32 off: TF32), put in
the program's place, on the card at each cell's own size, on three seeds.
Needs the card; ``eebench/readings.py`` reads the same numbers for the
limits."""

import pytest

from eebench import harness, program

CELLS = ["cart_gmm_replan", "omni_mi_mapping", "omni_mi_replan", "cart_gmm_explore"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 987654321013])
def test_control_is_not_correct(cuda, cell, seed):
    r = harness.run_cell(cell, seed, 1.0, False, cuda, program.reference(tf32=True))
    assert not r["correct"], r["checks"]
