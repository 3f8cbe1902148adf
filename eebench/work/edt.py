"""E, the world rebuild of the mapping refresh (``edt_kernel``, or
``edt_rows`` + ``edt_columns`` + ``edt_finish``), one launch a refresh.

Counted from the algorithm, per scenario and map cell: the occupancy test
(1), the exact Euclidean distance transform as two separable passes of the
lower envelope of parabolas (12 a cell a pass), the root and the scale (2),
the central-difference gradient (6); per lattice point the free-mask test
at its nearest cell (5). Bytes: the map in, and the distance (4 bytes),
gradient (8) and free mask (4 a lattice point) out, once each.
"""


def count(cfg: dict, S: int, facts: dict):
    h, w = facts["map_shape"]
    N = cfg["grid_samples"][0] * cfg["grid_samples"][1]
    flops = S * (h * w * (1 + 24 + 2 + 6) + 5 * N)
    nbytes = S * (4 * h * w + 4 + 12 * h * w + 4 * N)
    return flops, nbytes
