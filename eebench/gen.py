"""The benchmark's one traffic generator: maps, poses, targets and beliefs
made from a seed and the parameters of a configuration and a traffic file,
and the plant that moves the robots between replans.

Everything here is the benchmark's own (copied from the port's bench and
smoke generators and rewritten against the plain reference), so that a
change to the program cannot change its inputs. The same seed gives the
same arrays on every machine: numpy draws in a fixed order, on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from eebench.reference.ops.distance import edt


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of ``seed`` (any whole number) for one ``stream`` of
    draws: streams are independent, so adding a draw to one moves no other."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def wall_and_pillar(cells: int) -> np.ndarray:
    """The shared (cells, cells) map of the port's bench room: a wall and a
    pillar (the port's ``bench.case_arrays`` map, at 100 x 100)."""
    data = np.zeros((cells, cells), np.float32)
    data[45 * cells // 100:50 * cells // 100, 20 * cells // 100:80 * cells // 100] = 1.0
    data[70 * cells // 100:78 * cells // 100, 60 * cells // 100:68 * cells // 100] = 1.0
    return data


def building() -> np.ndarray:
    """The quality run's hidden building, (100, 100): outer walls, a long
    wall with a 1.3 m doorway on the right, an upper divider with a 1.6 m
    doorway on the left, and a pillar."""
    data = np.zeros((100, 100), np.float32)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 1.0
    data[45:48, 0:64] = 1.0
    data[45:48, 90:100] = 1.0
    data[70:72, 32:100] = 1.0
    data[20:28, 70:78] = 1.0
    return data


def clearance(data: np.ndarray, res: float, threshold: float = 0.65) -> np.ndarray:
    """The distance (m) from each cell to the nearest occupied cell, by the
    reference's plain Euclidean distance transform."""
    occ = torch.from_numpy(np.ascontiguousarray(data)) >= threshold
    return edt(occ, torch.tensor(res, dtype=torch.float32)).numpy()


def spawn(g: np.random.Generator, S: int, clear: np.ndarray, res: float, need: float,
          lo: float, hi: float) -> np.ndarray:
    """(S, 3) float32 poses uniform over [lo, hi]^2 x (-pi, pi), redrawn
    until the clearance at the pose's cell exceeds ``need``."""
    xy = np.empty((0, 2))
    while len(xy) < S:
        p = g.uniform(lo, hi, (2 * S, 2))
        ij = (p / res).astype(np.int64)
        ok = clear[ij[:, 1], ij[:, 0]] > need
        xy = np.concatenate([xy, p[ok]])
    th = g.uniform(-np.pi, np.pi, (S, 1))
    return np.concatenate([xy[:S], th], axis=1).astype(np.float32)


class Mixtures(NamedTuple):
    means: np.ndarray  # (S, J, 2)
    covs: np.ndarray  # (S, J, 2, 2)
    weights: np.ndarray  # (S, J)


def mixtures(g: np.random.Generator, S: int, J: int, cov: float, lo: float,
             hi: float) -> Mixtures:
    """J Gaussian components a scenario: means uniform in [lo, hi]^2,
    covariance ``cov`` I, equal weights."""
    means = g.uniform(lo, hi, (S, J, 2)).astype(np.float32)
    covs = np.tile((cov * np.eye(2, dtype=np.float32))[None, None], (S, J, 1, 1))
    return Mixtures(means, covs, np.ones((S, J), np.float32))


def distinct_rooms(g: np.random.Generator, S: int, cells: int, res: float):
    """S distinct (cells, cells) maps: a wall (5 x 60 cells) and a pillar
    (8 x 8) at per-scenario positions (the port's smoke ``distinct_case``
    maps, at 100 x 100). Returns (maps (S, cells, cells), the rectangles in
    metres ((S, 4) wall, (S, 4) pillar))."""
    wr, wc = g.integers(10, cells - 15, S), g.integers(5, cells - 65, S)
    br, bc = g.integers(5, cells - 13, S), g.integers(5, cells - 13, S)
    data = np.zeros((S, cells, cells), np.float32)
    for s in range(S):
        data[s, wr[s]:wr[s] + 5, wc[s]:wc[s] + 60] = 1.0
        data[s, br[s]:br[s] + 8, bc[s]:bc[s] + 8] = 1.0
    wall = np.stack([wc, wr, wc + 60, wr + 5], axis=1) * res
    pillar = np.stack([bc, br, bc + 8, br + 8], axis=1) * res
    return data, (wall, pillar)


def spawn_clear_of(g: np.random.Generator, rects, need: float, lo: float,
                   hi: float) -> np.ndarray:
    """(S, 3) float32 poses uniform over [lo, hi]^2 x (-pi, pi), each redrawn
    until it lies more than ``need`` m from its own scenario's rectangles."""
    S = rects[0].shape[0]
    xy = g.uniform(lo, hi, (S, 2))
    for _ in range(256):
        ok = np.ones(S, bool)
        for r in rects:
            dx = np.maximum(np.maximum(r[:, 0] - xy[:, 0], xy[:, 0] - r[:, 2]), 0.0)
            dy = np.maximum(np.maximum(r[:, 1] - xy[:, 1], xy[:, 1] - r[:, 3]), 0.0)
            ok &= np.hypot(dx, dy) > need
        if ok.all():
            break
        xy[~ok] = g.uniform(lo, hi, (int((~ok).sum()), 2))
    else:
        raise RuntimeError("no clear pose found for some scenarios")
    th = g.uniform(-np.pi, np.pi, (S, 1))
    return np.concatenate([xy, th], axis=1).astype(np.float32)


def disc_beliefs(truth: np.ndarray, g: np.random.Generator, S: int, points: int, radius: float,
                 res: float, clear: np.ndarray, need: float, device) -> torch.Tensor:
    """(S, h, w) float32 beliefs on ``device``: each scenario's map unknown
    (-1) but for discs of ``radius`` m around ``points`` seeded free points
    of its own, where it shows the truth (a plain disc reveal)."""
    h, w = truth.shape
    pts = np.stack([spawn(g, S, clear, res, need, 0.3, w * res - 0.3)[:, :2]
                    for _ in range(points)], axis=1)  # (S, points, 2)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * res
    cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * res
    seen = torch.zeros((S, h, w), dtype=torch.bool, device=device)
    for k in range(points):
        d2 = ((cx[None, None, :] - p[:, k, 0, None, None]) ** 2
              + (cy[None, :, None] - p[:, k, 1, None, None]) ** 2)
        seen |= d2 <= radius * radius
    t = torch.as_tensor(truth, device=device).expand(S, h, w)
    return torch.where(seen, t, torch.full_like(t, -1.0))


class Plant:
    """The robots' true motion between replans, in float32 numpy: the body
    twist of the wheel velocities held for ``dt``, integrated exactly (the
    constant-twist arc), the heading wrapped to (-pi, pi]."""

    def __init__(self, engine_cfg: dict):
        self.dt = np.float32(engine_cfg["dt"])
        self.model = engine_cfg["model"]
        p = engine_cfg[self.model]
        r = float(p["wheel_radius"])
        if self.model == "cart":
            self.k = (np.float32(0.5 * r), np.float32(r / float(p["wheel_base"])))
        else:
            L = float(p["lx"]) + float(p["ly"])
            self.k = (np.float32(0.25 * r), np.float32(0.25 * r / L))

    def twist(self, u: np.ndarray) -> np.ndarray:
        """(S, 3) float32 body twists (vx, vy, omega) of wheel speeds u."""
        kv, kw = self.k
        tw = np.empty((u.shape[0], 3), np.float32)
        if self.model == "cart":
            tw[:, 0] = kv * (u[:, 0] + u[:, 1])
            tw[:, 1] = 0.0
            tw[:, 2] = kw * (u[:, 1] - u[:, 0])
            return tw
        tw[:, 0] = kv * (u[:, 0] + u[:, 1] + u[:, 2] + u[:, 3])
        tw[:, 1] = kv * (-u[:, 0] + u[:, 1] + u[:, 2] - u[:, 3])
        tw[:, 2] = kw * (-u[:, 0] + u[:, 1] - u[:, 2] + u[:, 3])
        return tw

    def step(self, x: np.ndarray, u: np.ndarray):
        """(poses after dt (S, 3) float32, body twists (S, 3) float32)."""
        tw = self.twist(u)
        vx, vy, w = tw[:, 0], tw[:, 1], tw[:, 2]
        th = x[:, 2]
        a = w * self.dt
        small = np.abs(a) < 1e-6
        safe = np.where(small, np.float32(1.0), w)
        sa, ca = np.sin(a), np.cos(a)
        # the arc in the body frame at the start of the step
        bx = np.where(small, vx * self.dt, (vx * sa + vy * (ca - 1.0)) / safe)
        by = np.where(small, vy * self.dt, (vx * (1.0 - ca) + vy * sa) / safe)
        c, s = np.cos(th), np.sin(th)
        out = np.empty_like(x)
        out[:, 0] = x[:, 0] + c * bx - s * by
        out[:, 1] = x[:, 1] + s * bx + c * by
        pi = np.float32(math.pi)
        out[:, 2] = pi - np.mod(pi - (th + a), np.float32(2 * math.pi))
        return out, tw
