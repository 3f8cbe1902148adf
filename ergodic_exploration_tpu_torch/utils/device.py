"""The device an entry point runs on.

The port's entry points (``Engine``, ``utils.interop.*_from_numpy``) run on
the CUDA device unless the caller asks for the CPU, as the CPU tests do.
"""

from __future__ import annotations

import torch

_CONSTANTS: dict = {}  # (key, device) -> what ``constant``'s ``make`` returned


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is
    available: nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the default) but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


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
