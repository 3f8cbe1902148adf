"""Runtime guards for the engine's shared-geometry contracts (port of
``ergodic_exploration_tpu/utils/validation.py``).

``cfg.shared_maps`` promises that every scenario holds the same map: K1
reads every scenario's patch from row 0 of the distance field and the
target refresh folds row 0's free mask into the basis table. The MI refresh
on a shared domain (dense path and K3) builds its sampling and cosine tables
from scenario 0's grid geometry. A caller who breaks either promise would
silently get scenario 0's physics everywhere, so these checks raise
instead. Rows are compared on the tensors' device and
only the list of offending rows comes back to the host. A check is made
once per distinct set of tensors (map cadence, not tick cadence): callers
pass a ``cache`` set, which the engine owns.
"""

from __future__ import annotations

from typing import Optional

import torch


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for t in tree for leaf in _leaves(t)]


def _rows_equal(a: torch.Tensor, what: str) -> None:
    """Raise ValueError unless every leading-axis row of ``a`` equals row 0."""
    if a.dim() < 1 or a.shape[0] <= 1:
        return
    flat = a.reshape(a.shape[0], -1)
    bad = torch.nonzero((flat != flat[:1]).any(dim=1)).flatten().tolist()
    if bad:
        raise ValueError(
            f"shared-geometry contract violated: {what} differs from scenario 0 "
            f"at scenario indices {bad[:8]}{' ...' if len(bad) > 8 else ''} — every "
            f"scenario must share one geometry on this path (cfg.shared_maps). Use "
            f"shared_maps=False for heterogeneous worlds."
        )


def check_rows_shared(tree, what: str, cache: Optional[set] = None) -> None:
    """Validate that every tensor in ``tree`` is identical across its
    leading (scenario) axis. With ``cache``, a set of tensors already
    checked (same objects, storage and version) is skipped."""
    leaves = _leaves(tree)
    key = (what, tuple((id(t), t.data_ptr(), t._version) for t in leaves))
    if cache is not None and key in cache:
        return
    for leaf in leaves:
        _rows_equal(leaf, what)
    if cache is not None:
        if len(cache) >= 4096:
            cache.clear()
        cache.add(key)


def check_shared_world(world, what: str = "world.dist", cache: Optional[set] = None) -> None:
    """``cfg.shared_maps`` contract: all scenarios share one distance field
    (map data, origin, resolution) and free mask."""
    check_rows_shared(
        {"dist": world.dist.dist, "origin": world.dist.origin,
         "resolution": world.dist.resolution, "free_mask": world.free_mask},
        what, cache)


def check_shared_grid_geometry(grids, what: str = "grids", cache: Optional[set] = None) -> None:
    """Dense MI refresh contract: all grids share origin, resolution and
    shape (the sampling and cosine tables are built from scenario 0's
    geometry). Map DATA may differ."""
    check_rows_shared({"origin": grids.origin, "resolution": grids.resolution}, what, cache)
