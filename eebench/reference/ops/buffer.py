"""Frozen from ``ergodic_exploration_tpu_torch/ops/buffer.py`` at commit e20fa1114c5b:
the ring buffer of visited positions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eebench.reference.utils.prng import uniform01

__all__ = ["RingBuffer", "uniform01"]


class RingBuffer(NamedTuple):
    states: torch.Tensor  # (S, 2, capacity) visited positions
    cursor: torch.Tensor  # (S,) int32: next write slot
    count: torch.Tensor  # (S,) int32: number of valid entries (<= capacity)

    @staticmethod
    def create(capacity: int, S: int, device=None) -> "RingBuffer":
        return RingBuffer(
            states=torch.zeros((S, 2, capacity), dtype=torch.float32, device=device),
            cursor=torch.zeros((S,), dtype=torch.int32, device=device),
            count=torch.zeros((S,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.states.shape[-1]

    @property
    def positions(self) -> torch.Tensor:
        """(S, capacity, 2) point-major view."""
        return self.states.transpose(-1, -2)

    def append(self, p: torch.Tensor) -> "RingBuffer":
        """Append one position (S, 2) per scenario; overwrites the oldest."""
        cap = self.capacity
        hot = (torch.arange(cap, device=p.device) == self.cursor[:, None])[:, None, :]
        return RingBuffer(
            states=torch.where(hot, p[:, :2, None], self.states),
            cursor=(self.cursor + 1) % cap,
            count=torch.clamp(self.count + 1, max=cap),
        )

    def append_(self, p: torch.Tensor) -> "RingBuffer":
        """:meth:`append` in place: writes each scenario's position (S, 2)
        into the cursor's slot of ``states`` itself (``states[s, :, cursor[s]]
        = p[s]``) and returns the ring with that tensor and the advanced
        cursor and count. Only for a ring its caller owns and advances (a
        graph's static state, where the JAX engine donates its state); the
        values are :meth:`append`'s bit for bit."""
        cap = self.capacity
        slot = self.cursor.to(torch.int64)[:, None, None].expand(-1, 2, 1)
        self.states.scatter_(2, slot, p[:, :2, None].to(self.states.dtype))
        return RingBuffer(
            states=self.states,
            cursor=(self.cursor + 1) % cap,
            count=torch.clamp(self.count + 1, max=cap),
        )

    def valid_mask(self) -> torch.Tensor:
        """(S, capacity) float mask of live entries."""
        idx = torch.arange(self.capacity, device=self.count.device)
        return (idx < self.count[:, None]).to(torch.float32)

    def _draw_indices(self, batch: int, rng: torch.Tensor) -> torch.Tensor:
        """(S, batch) with-replacement indices of valid entries; keys (S, 2)."""
        u = uniform01(rng, batch)
        n = torch.clamp(self.count, min=1).to(u.dtype)[:, None]
        return torch.floor(u * n).to(torch.int64)

    def sample_mask(self, batch: Optional[int], rng: torch.Tensor) -> torch.Tensor:
        """(S, capacity) multiplicity weights of the history draw (every
        valid entry once when ``batch`` is None)."""
        mask = self.valid_mask()
        if batch is None:
            return mask
        idx = self._draw_indices(batch, rng)
        counts = torch.zeros_like(mask).scatter_add_(1, idx, torch.ones_like(idx, dtype=mask.dtype))
        return torch.where(self.count[:, None] > 0, counts, torch.zeros_like(counts))

    def sample_states(self, batch: int, rng: torch.Tensor):
        """Drawn states (S, batch, 2) and the live count n (S,)."""
        idx = self._draw_indices(batch, rng)
        states = torch.gather(self.states, 2, idx[:, None, :].expand(-1, 2, -1))
        n = torch.where(self.count > 0, float(batch), 0.0)
        return states.transpose(1, 2), n
