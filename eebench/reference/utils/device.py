"""Frozen from ``ergodic_exploration_tpu_torch/utils/device.py`` at commit e20fa1114c5b:
per-device constants.
"""

from __future__ import annotations

import torch

_CONSTANTS: dict = {}  # (key, device) -> what ``constant``'s ``make`` returned


def constant(key, device, make):
    """What ``make()`` builds for ``key`` on ``device``: built on the first
    call for that (key, device) and kept for every later one.

    A tensor made from Python values (``torch.tensor([...], device=...)``)
    is a copy from pageable host memory, after which the host waits for the
    device, and a CUDA graph cannot capture it. The tick's constants are made
    here once instead, outside any capture (the capture's warm-up makes
    them). ``make`` must depend on ``key`` and ``device`` alone; the few
    entries (one per configuration and device) are never evicted, so none is
    made again under a capture."""
    k = (key, torch.device(device))
    hit = _CONSTANTS.get(k)
    if hit is None:
        hit = _CONSTANTS[k] = make()
    return hit
