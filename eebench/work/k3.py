"""K3, the MI target from the beliefs (``k3_phik`` + ``k3_finish``), one
launch a tick.

Counted from the algorithm, per scenario and map cell: the entropy of the
cell's occupancy (two logs and 8 more operations), the known, free and
occupied tests (3), the sensor footprint's separable box sum (2 (2r + 1)),
the frontier test's separable box count of known-free cells (2 (2 fc + 1),
with fc > 0) and the masking (2); then the contraction with the lattice's
basis tables, which absorb the lattice's sampling of the cells: 2 K per
cell for the x tables and 2 K^2 per map row for the y tables; the
normalisation (2 K^2). Bytes: the beliefs, both tables, the fallback and
the result once.
"""


def count(cfg: dict, S: int, facts: dict):
    K = cfg["num_basis"]
    h, w = facts["map_shape"]
    r, fc = facts["sensor_radius_cells"], cfg["mi_frontier_cells"]
    per_cell = 10 + 3 + 2 * (2 * r + 1) + (2 * (2 * fc + 1) if fc else 0) + 2 + 2 * K
    flops = S * (h * w * per_cell + h * 2 * K * K + 2 * K * K)
    nbytes = 4 * (S * h * w + w * K + h * K + K * K + 1 + S * K * K)
    return flops, nbytes
