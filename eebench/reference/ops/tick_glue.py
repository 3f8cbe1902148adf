"""Frozen from ``ergodic_exploration_tpu_torch/ops/tick_glue.py`` at commit e20fa1114c5b:
the tick glue's plain versions; ``glue_pre`` and ``glue_post`` are them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eebench.reference.grid import Domain
from eebench.reference.ops import basis
from eebench.reference.ops.buffer import RingBuffer
from eebench.reference.ops.collision import CRASH
from eebench.reference.ops.patch import patch_start
from eebench.reference.utils import prng


class PatchGeometry(NamedTuple):
    """What the patch start needs: the distance field's origin (S, 2) and
    resolution (S,), and the patch's cells."""

    origin: torch.Tensor
    resolution: torch.Tensor
    P: int


class GluePre(NamedTuple):
    # (S, K^2) sums ("sums", "full"; "accumulate": ck_sum itself) or (S, nb, 2)
    # positions ("nb")
    hist: Optional[torch.Tensor]
    nh: Optional[torch.Tensor]  # (S,) float32 history state count (None without history)
    orbiting: torch.Tensor  # (S,) bool: the orbit guard reset the warm start
    U: torch.Tensor  # (S, H, nu) warm start
    pstart: Optional[torch.Tensor]  # (S, 2) int32 patch starts (with a PatchGeometry)


class GluePost(NamedTuple):
    U: torch.Tensor  # (S, H, nu) shifted warm start
    buffer: RingBuffer  # the ring after the append (its states the input's with ring_in_place)
    hist_count: torch.Tensor  # (S,) int32
    rng: torch.Tensor  # (S, 2) int64 next keys
    u: torch.Tensor  # (S, nu) emitted controls
    code: torch.Tensor  # (S,) int32 validation codes (0 with safety off)
    dwa_active: torch.Tensor  # (S,) bool
    feasible: torch.Tensor  # (S,) bool
    diverged: torch.Tensor  # (S,) bool
    x: Optional[torch.Tensor]  # (S, 3) poses one dt on (``advance``)
    vb: Optional[torch.Tensor]  # (S, 3) body twists of ``u`` (``advance``)


def history_mode(cfg, fused: bool) -> str:
    """glue_pre's history mode for ``cfg``: ``"sums"`` for the fused tick's
    shared draw, ``"nb"`` for per-scenario draws (the fused tick without the
    shared draw, and the eager step), ``"full"`` for the full ring
    (``buffer_batch`` None) and ``"accumulate"`` for the accumulate mode."""
    if cfg.history != "ring":
        return "accumulate"
    if not cfg.buffer_batch:
        return "full"
    return "sums" if fused and cfg.shared_history_draw else "nb"


def orbit_window(cfg, capacity: int) -> int:
    """The orbit guard's window clamped to the ring (0: the guard is off)."""
    return 0 if cfg.orbit_window <= 0 else min(cfg.orbit_window, capacity)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def shared_draw_sums(cfg, buffer: RingBuffer, sub0: torch.Tensor, domain: Domain):
    """The shared draw's history (the JAX tick's compaction): ONE index draw
    under the key ``sub0`` (2,) over row 0's count (the scenarios share the
    key and tick together, so their counts are equal), gathered from every
    ring; the reduction is one batched (K, nb) @ (nb, K) product. Returns
    (sums (S, K^2), n_hist (S,))."""
    nb, K = cfg.buffer_batch, cfg.num_basis
    S = buffer.states.shape[0]
    u = prng.uniform01(sub0, nb)  # (nb,)
    n0 = torch.clamp(buffer.count[0], min=1).to(u.dtype)
    idx = torch.floor(u * n0).to(torch.int64)
    s_buf = buffer.states.index_select(2, idx).transpose(1, 2)  # (S, nb, 2)
    n_hist = torch.where(buffer.count > 0, float(nb), 0.0)
    Cbx, Cby = basis.cos_tables(s_buf, K, domain)
    w = (n_hist > 0).to(torch.float32)[:, None, None]
    hk = basis.hk_norm(K, domain.lengths)
    return (torch.bmm(Cbx.transpose(1, 2), Cby) * (w / hk)).reshape(S, K * K), n_hist


def glue_pre_plain(cfg, mode: Optional[str], rng, buffer: RingBuffer, U, x, domain: Domain,
                   patch: Optional[PatchGeometry] = None, hist_count=None,
                   ck_sum=None) -> GluePre:
    """glue_pre's plain version: keys ``rng`` (S, 2), the ring, the warm
    start U (S, H, nu), poses x (S, 3), the per-scenario ``domain`` ((S, 2)
    leaves), for the patch starts a :class:`PatchGeometry` and, for the
    accumulate mode, ``hist_count`` (S,) and ``ck_sum`` (S, K, K). The full
    ring and the accumulate mode take ``controller.history_sums``."""
    from eebench.reference.controller import (
        ControllerState, history_sums, orbit_guard)

    hist = nh = pstart = None
    if mode == "sums":
        hist, nh = shared_draw_sums(cfg, buffer, prng.split(rng[0])[1], domain)
    elif mode == "nb":
        hist, nh = buffer.sample_states(cfg.buffer_batch, prng.split(rng)[:, 1])
    elif mode in ("full", "accumulate"):
        K = cfg.num_basis
        hist, nh = history_sums(cfg, ControllerState(U, buffer, ck_sum, hist_count, rng), domain,
                                basis.hk_norm(K, domain.lengths))
        hist = hist.reshape(x.shape[0], K * K)
    orbiting = orbit_guard(cfg, buffer, x[:, :2])
    U_warm = torch.where(orbiting[:, None, None], torch.zeros_like(U), U)
    if patch is not None:
        pstart = patch_start(patch, x[:, :2], patch.P).to(torch.int32)
    return GluePre(hist, nh, orbiting, U_warm, pstart)


def glue_post_plain(cfg, shared_key: bool, U_new, safety, buffer: RingBuffer, hist_count, rng,
                    x, advance: bool = False, ring_in_place: bool = False) -> GluePost:
    """glue_post's plain version: U_new (S, H, nu) from the descent,
    ``safety`` (code (S,) int32, u_dwa (S, nu), feasible (S,) int32) or None
    (safety off), the ring, ``hist_count``, the keys ``rng`` (S, 2) (with
    ``shared_key`` every row's next key is row 0's), poses x (S, 3). With
    ``ring_in_place`` the pose is written into ``buffer.states`` itself
    (:meth:`RingBuffer.append_`), else into a new ring."""
    S = x.shape[0]
    u0 = U_new[:, 0]
    if safety is not None:
        code, u_dwa, feasible = safety
        use_dwa = code >= CRASH
        u_cmd = torch.where(use_dwa[:, None], u_dwa, u0)
        feasible = feasible.to(torch.bool)
    else:
        code = torch.zeros(S, dtype=torch.int32, device=x.device)
        feasible = torch.ones(S, dtype=torch.bool, device=x.device)
        use_dwa = torch.zeros(S, dtype=torch.bool, device=x.device)
        u_cmd = u0
    # divergence guard: a non-finite solve resets THIS scenario's controls
    diverged = ~(torch.isfinite(U_new).all(dim=(1, 2)) & torch.isfinite(u_cmd).all(dim=1))
    U_new = torch.where(diverged[:, None, None], torch.zeros_like(U_new), U_new)
    u_cmd = torch.where(diverged[:, None], torch.zeros_like(u_cmd), u_cmd)
    U_next = torch.cat([U_new[:, 1:], torch.zeros_like(U_new[:, :1])], dim=1)
    if shared_key:
        nxt = prng.split(rng[0])[0].expand(S, 2).clone()
    else:
        nxt = prng.split(rng)[:, 0]
    x_next = vb_next = None
    if advance:
        from eebench.reference.models import make_model
        from eebench.reference.ops.integrator import rollout

        model = make_model(cfg)
        x_next = rollout(model, x, u_cmd[:, None, :], cfg.dt)[:, -1]
        vb_next = model.twist(u_cmd)
    ring = buffer.append_(x[:, :2]) if ring_in_place else buffer.append(x[:, :2])
    return GluePost(U_next, ring, hist_count + 1, nxt, u_cmd, code, use_dwa, feasible, diverged,
                    x_next, vb_next)


glue_pre = glue_pre_plain
glue_post = glue_post_plain
