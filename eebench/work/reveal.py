"""R, the ray-cast reveal of the mapping refresh (``reveal_kernel``), one
launch a refresh; the coverage count (``coverage_kernel``) is outside it.

Counted from the algorithm, per scenario: for each cell of the sensor's
window (P x P, P = ``raycast_window_cells``) its centre's offset, radius,
angle, angle bin and radius step (15); for each occupied window cell the
angular interval it subtends (2) and, for each angle bin inside it, the
blocking test and the bin's nearest blocker (3): what these maps need
(``facts["reveal_blocked_bins"]`` and ``["reveal_occupied"]``, counted on
the hidden map around the poses of the cell's refreshes); per window cell
the visibility and range tests and the write (4). Bytes: the window's cells
of the belief and of the truth read once, and written once.
"""


def count(cfg: dict, S: int, facts: dict):
    P2 = facts["window_cells"] ** 2
    flops = S * P2 * (15 + 4) + 2 * facts["reveal_occupied"] + 3 * facts["reveal_blocked_bins"]
    nbytes = 4 * 3 * S * P2 + 4 * S * 3
    return flops, nbytes


def facts_from(truth, poses, res: float, window: int, n_bins: int, thr: float) -> dict:
    """``reveal_occupied`` and ``reveal_blocked_bins``: the occupied cells
    of each pose's window, and the angle bins each subtends, summed over
    the poses (S, >= 2) on the hidden maps ``truth`` (S, h, w)."""
    import math

    import torch

    S, h, w = truth.shape
    dev = truth.device
    P = min(window, h, w)
    cf = poses[:, :2] / res - 0.5
    start = torch.round(cf).to(torch.int64) - P // 2
    ii = torch.arange(P, device=dev)
    rows = torch.clamp(start[:, 1:2] + ii, 0, h - 1)
    cols = torch.clamp(start[:, 0:1] + ii, 0, w - 1)
    bi = torch.arange(S, device=dev)[:, None, None]
    occ = truth[bi, rows[:, :, None], cols[:, None, :]] >= thr
    dx = (cols.to(torch.float32) + 0.5) * res - poses[:, 0, None]
    dy = (rows.to(torch.float32) + 0.5) * res - poses[:, 1, None]
    dx, dy = dx[:, None, :].expand(S, P, P), dy[:, :, None].expand(S, P, P)
    rc = torch.sqrt(dx * dx + dy * dy) / res
    ang = torch.atan2(dy, dx)
    half = torch.atan(0.55 / torch.clamp(rc, min=0.5))
    step = 2 * math.pi / n_bins
    hi = torch.floor((ang + half + math.pi) / step - 0.5)
    lo = torch.ceil((ang - half + math.pi) / step - 0.5)
    bins = torch.clamp(hi - lo + 1, min=0)
    return {"reveal_occupied": int(occ.sum()), "reveal_blocked_bins": int(bins[occ].sum()),
            "window_cells": P}
