"""Drivers: one module a traffic driver, each with a ``Driver(ctx)`` class
that the harness runs as ``setup()``, ``request()`` until the window
closes, ``release()`` (the program's state freed) and ``check()`` (a list
of (number, value, limit)). A driver tells the harness its
``ticks_per_request`` and ``refreshes_per_request`` and, after the check,
the ``facts`` the work counts of ``eebench/work`` take. What the drivers
share is here: the request's record, the seeded choice of the requests the
check compares, and the statistics of a comparison.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from eebench import gen


class Request(NamedTuple):
    solves: int  # scenario replans the request completed
    ok: bool  # its outputs came back finite
    latency_s: Optional[float] = None  # poses handed over -> controls on the host
    dispatch_s: Optional[float] = None  # the harness's clock around the entry call


class Samples:
    """The requests the check compares: the first one, and ``k`` more drawn
    uniformly from all later ones by reservoir sampling on the seed's own
    stream (so the choice does not depend on how many the window holds)."""

    def __init__(self, seed: int, k: int):
        self.g = gen.rng(seed, 99)
        self.k = k
        self.first = None
        self.rest: List[Tuple[int, object]] = []
        self.seen = 0

    def offer(self, i: int, make):
        """Request ``i`` (0, 1, ...): keep ``make()`` if it is chosen."""
        if i == 0:
            self.first = (0, make())
            return
        self.seen += 1
        if len(self.rest) < self.k:
            self.rest.append((i, make()))
            return
        j = int(self.g.integers(0, self.seen))
        if j < self.k:
            self.rest[j] = (i, make())

    def all(self):
        return ([self.first] if self.first is not None else []) + sorted(self.rest,
                                                                         key=lambda s: s[0])


def rows(t: torch.Tensor) -> torch.Tensor:
    """(S, ...) -> (S, n) float64 on the CPU."""
    t = t.detach().to("cpu", torch.float64)
    return t.reshape(t.shape[0], -1)


def p99(values: List[torch.Tensor]) -> float:
    """The 99th percentile of the concatenated values (NaN counts as inf)."""
    v = torch.cat([x.reshape(-1) for x in values]).to(torch.float64)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    return float(np.percentile(v.numpy(), 99))


def abs_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(S,) the largest |got - want| of each scenario's row."""
    return (rows(got) - rows(want)).abs().amax(dim=1)


def rel_gap(got: torch.Tensor, want: torch.Tensor, floor: float) -> torch.Tensor:
    """(S,) |got - want| / max(|want|, floor), the largest of each row."""
    g, w = rows(got), rows(want)
    return ((g - w).abs() / w.abs().clamp(min=floor)).amax(dim=1)


def cells_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements that differ (an exact comparison)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def ring_off(got, want) -> int:
    """Elements of two ring buffers (states, cursor, count) that differ."""
    return sum(cells_off(a, b) for a, b in zip(got, want))


def take_rows(tree, rows: torch.Tensor):
    """``tree`` (NamedTuples of (S, ...) tensors, such as Scenarios) with
    only the scenarios ``rows``: every scenario's state is its own rows."""
    if isinstance(tree, torch.Tensor):
        return tree[rows.to(tree.device)]
    return type(tree)(*(take_rows(f, rows) for f in tree))


def later_points(g: np.random.Generator, n: int, total: int, block: int = 1) -> List[int]:
    """``n`` distinct points drawn by ``g`` among the multiples of ``block``
    in [block, total - 1], one from each of ``n`` equal parts (fewer where
    the range holds fewer): where a prefix of a request ends and the check
    compares the request's next tick."""
    choices = np.arange(block, total, block)
    if len(choices) == 0:
        return []
    parts = np.array_split(choices, min(n, len(choices)))
    return sorted(int(g.choice(p)) for p in parts)


def limits(ctx, names) -> List[Tuple[str, float, float]]:
    """[(name, value, limit)] for the numbers ``names`` (name -> value), in
    the order of the cell file's ``checks``, which holds every limit."""
    lim = ctx.cell["checks"]
    missing = set(names) ^ set(lim)
    if missing:
        raise RuntimeError(f"the check's numbers and the cell file's limits differ: "
                           f"{sorted(missing)}")
    return [(n, float(names[n]), float(lim[n])) for n in lim]


def k1_facts(ctx, ref, world, ticks) -> dict:
    """The counts ``eebench/work/k1_solve.py`` takes, per tick, averaged over
    ``ticks``: (x, vb, u, diag) of reference ticks on ``world``."""
    from eebench.work import k1_solve

    cfg = ctx.engine_config
    S = ctx.scenarios
    h, w = world.dist.dist.shape[-2:]
    P = min(cfg["patch_cells"], h, w)
    shared_draw = cfg["use_fused_solve"] and cfg["shared_history_draw"]
    facts = {"drawn_history": 0 if shared_draw or not cfg["buffer_batch"] else
             cfg["buffer_batch"],
             "map_cells": h * w if cfg["shared_maps"] else S * P * P,
             "map_shape": (h, w)}
    sums = {"validation_probes": 0, "dwa_probes": 0, "dwa_candidates": 0}
    for x, vb, u, diag in ticks:
        got = k1_solve.safety_facts(ref.config, ref.model, x, vb, u, diag.dwa_active, world)
        for k in sums:
            sums[k] += got[k]
    facts.update({k: v / max(len(ticks), 1) for k, v in sums.items()})
    return facts
