"""Frozen from ``ergodic_exploration_tpu_torch/utils/prng.py`` at commit e20fa1114c5b:
the threefry key words and draws.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for uint32 values a and a uint32 constant c."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) of counts (x0, x1) under
    ``key`` (..., 2); returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for keys (..., 2) -> (..., num, 2).

    Partitionable threefry: new key i is threefry2x32(key, (hi(i), lo(i)))
    of the 64-bit counter i.
    """
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k = key.unsqueeze(-2)  # (..., 1, 2) broadcast over the num counters
    b0, b1 = threefry2x32(k, i >> 32, i & _M32)
    return torch.stack([b0, b1], dim=-1)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (``ops/buffer.py::_mix32``)."""
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def uniform01(key: torch.Tensor, n: int) -> torch.Tensor:
    """``ops/buffer.py::uniform01`` for keys (..., 2) -> (..., n) float32:
    the top 24 bits of the lowbias32 hash, exact in float32 and < 1."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    h = _mix32(_mul32(i, 2654435761) ^ key[..., 0:1])
    h = _mix32((h + key[..., 1:2]) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
