"""The frozen world rebuild's plain version (``distance.edt``,
``edt_kernel.edt_field_plain`` and ``world_plain``) for maps too large for
it: the same float32 sums and minima, computed map by map and in blocks of
output rows or columns, so that the bits are the same.

The frozen ``edt`` builds, for each of its two min-plus passes, an
(h, w, n) tensor of every sum ``g[k] + (j - k)^2``: 256 GB a map at
4000 x 4000 cells. Here a pass takes the output positions j in blocks of
``block`` (all at once where None; by default as many as keep a block's
sums under ``BUDGET`` elements), and takes the sums over the input positions
k at which some line of the map holds a value under ``big`` (the frozen
version's "no obstacle" value; every input is at most ``big``). That is the
one departure from the frozen code, and it moves no bit: a position where
every line holds ``big`` adds ``big + (j - k)^2 >= big`` to every minimum
(rounding is monotone), and a line whose own value at j is ``big`` reaches
exactly ``big`` at k = j, so each output is ``min(big, the minimum over the
kept positions)``. On beliefs that show a few walls the kept positions are
the few rows and columns those walls cross, so a 4000 x 4000 map takes a
few thousand times less work than the frozen passes. Plain torch, float32,
no matrix product; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from eebench.reference.ops.distance import FAR, central_gradient

BUDGET = 2**26  # sums a block of one pass holds at a time (256 MB of float32)


def _minplus_pass(g: torch.Tensor, dim: int, big: float, block=None) -> torch.Tensor:
    """out[.., j] = min_k g[.., k] + (j - k)^2 along ``dim`` (0 or 1) of one
    map ``g`` (h, w) whose values are at most ``big`` (module docstring)."""
    gm = g if dim == 0 else g.T  # the pass runs along axis 0 of gm (n, m)
    n, m = gm.shape
    out = torch.full_like(gm, big)
    kept = torch.nonzero((gm < big).any(dim=1)).flatten()
    if kept.numel():
        gk = gm[kept]  # (a, m)
        k = kept.to(g.dtype)
        j = torch.arange(n, dtype=g.dtype, device=g.device)
        step = block or max(1, BUDGET // (kept.numel() * m))
        for j0 in range(0, n, step):
            sq = (k[:, None] - j[None, j0:j0 + step]) ** 2  # (a, b): (j - k)^2, as frozen
            sums = gk[:, None, :] + sq[:, :, None]  # (a, b, m)
            out[j0:j0 + step] = torch.clamp(sums.amin(dim=0), max=big)
    return out if dim == 0 else out.T.contiguous()


def edt(occ: torch.Tensor, resolution, block=None) -> torch.Tensor:
    """The frozen ``edt``: exact Euclidean distance (meters) from each cell
    centre to the nearest occupied cell centre of ``occ`` (..., H, W) bool,
    FAR on maps with none; ``block`` output positions a pass at a time."""
    h, w = occ.shape[-2:]
    big = float(max(h, w) ** 2 * 4)
    lead = occ.shape[:-2]
    d2 = torch.stack([
        _minplus_pass(_minplus_pass(torch.where(m, 0.0, big).to(torch.float32), 0, big, block),
                      1, big, block)
        for m in occ.reshape(-1, h, w)]).reshape(*lead, h, w)
    res = torch.as_tensor(resolution, dtype=torch.float32, device=occ.device)
    d = torch.sqrt(d2) * res[..., None, None]
    return torch.where(d2 >= big, torch.full_like(d, FAR), d)


def edt_field_plain(data: torch.Tensor, resolution: torch.Tensor, occupied_threshold: float,
                    block=None):
    """The frozen ``edt_field_plain``: (dist (..., h, w), grad (..., h, w, 2))."""
    d = edt(data >= occupied_threshold, resolution, block)
    gx, gy = central_gradient(d, resolution)
    return d, torch.stack([gx, gy], dim=-1)


def world_plain(grids, dom, occupied_threshold: float, grid_samples, block=None):
    """The frozen ``world_plain``: (dist (S, h, w), grad (S, h, w, 2), free
    (S, nsx * nsy))."""
    d, g = edt_field_plain(grids.data, grids.resolution, occupied_threshold, block)
    pts = dom.sample_lattice(grid_samples)
    return d, g, (grids.occupancy_at(pts) < occupied_threshold).to(torch.float32)
