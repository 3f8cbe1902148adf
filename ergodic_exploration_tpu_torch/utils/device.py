"""The device an entry point runs on.

The port's entry points (``Engine``, ``utils.interop.*_from_numpy``) run on
the CUDA device unless the caller asks for the CPU, as the CPU tests do.
"""

from __future__ import annotations

import torch


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
