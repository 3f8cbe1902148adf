"""Frozen from ``ergodic_exploration_tpu_torch/controller.py`` at commit e20fa1114c5b:
the batched controller: descent, safety, the tick's tail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from eebench.reference.config import EngineConfig
from eebench.reference.grid import Domain
from eebench.reference.models import make_model
from eebench.reference.ops import basis
from eebench.reference.ops.barrier import barrier
from eebench.reference.ops.buffer import RingBuffer
from eebench.reference.ops.collision import validate_control
from eebench.reference.ops.distance import DistanceField
from eebench.reference.ops.dwa import dwa_control
from eebench.reference.ops.integrator import costate_solve, rollout
from eebench.reference.utils.device import constant


class World(NamedTuple):
    """Per-scenario world data (leaves with a leading scenario axis)."""

    domain: Domain
    dist: DistanceField
    # (S, N) free-space weights at the phi sample lattice, or None
    free_mask: Optional[torch.Tensor] = None

    @staticmethod
    def empty(domain: Domain, shape=(2, 2)) -> "World":
        """Obstacle-free world over an unbatched ``domain``."""
        return World(domain=domain, dist=DistanceField.empty(shape, origin=domain.origin))


class ControllerState(NamedTuple):
    """Warm-started solver state, one row per scenario."""

    U: torch.Tensor  # (S, H, nu) control sequence
    buffer: RingBuffer  # visited-state history (ring mode)
    ck_sum: torch.Tensor  # (S, K, K) running sum of F_k over visited states
    hist_count: torch.Tensor  # (S,) int32
    rng: torch.Tensor  # (S, 2) int64 threefry key words


class StepDiagnostics(NamedTuple):
    ergodic_metric: torch.Tensor  # (S,)
    barrier_cost: torch.Tensor  # (S,) mean barrier value along the horizon
    collision_code: torch.Tensor  # (S,) int32 validation result for u0
    dwa_active: torch.Tensor  # (S,) bool: emitted control came from DWA
    dwa_feasible: torch.Tensor  # (S,) bool
    diverged: torch.Tensor  # (S,) bool: non-finite solve; scenario was reset
    orbit_reset: torch.Tensor  # (S,) bool: orbit guard reset the warm start


def orbit_guard(cfg: EngineConfig, buffer: RingBuffer, p_now: torch.Tensor) -> torch.Tensor:
    """(S,) True where a scenario's net displacement over the last
    ``cfg.orbit_window`` ticks (clamped to the ring capacity) is below
    ``cfg.orbit_eps``: the caller then resets its warm start."""
    W = cfg.orbit_window
    if W <= 0:
        return torch.zeros(p_now.shape[0], dtype=torch.bool, device=p_now.device)
    cap = buffer.capacity
    W = min(W, cap)
    idx = ((buffer.cursor - W) % cap).to(torch.int64)
    prev = torch.gather(buffer.states, 2, idx[:, None, None].expand(-1, 2, 1))[..., 0]
    disp2 = ((p_now - prev) ** 2).sum(dim=-1)
    return (buffer.count >= W) & (disp2 < cfg.orbit_eps * cfg.orbit_eps)


def history_sums(cfg: EngineConfig, state: ControllerState, domain: Domain, hk: torch.Tensor):
    """History term of c_k where no draw feeds it (``glue_pre``'s history
    mode None): the full ring (``buffer_batch`` None) or the accumulate mode.
    Returns (sum of F_k over the history (S, K, K), its state count (S,))."""
    if cfg.history == "accumulate":
        return state.ck_sum, state.hist_count.to(torch.float32)
    buf = state.buffer
    Cbx, Cby = basis.cos_tables(buf.positions, cfg.num_basis, domain)
    w_buf = buf.valid_mask()
    return basis.coefficients_cos(Cbx, Cby, w_buf, hk), w_buf.sum(dim=-1)


def drawn_history_sums(s_buf: torch.Tensor, n_hist: torch.Tensor, K: int, domain: Domain,
                       hk: torch.Tensor) -> torch.Tensor:
    """Sum of F_k (S, K, K) over the positions drawn from the ring buffer,
    ``s_buf`` (S, nb, 2); an empty buffer (``n_hist`` = 0) gives zeros."""
    Cbx, Cby = basis.cos_tables(s_buf, K, domain)
    w_buf = (n_hist > 0).to(torch.float32)[:, None].expand(-1, s_buf.shape[1])
    return basis.coefficients_cos(Cbx, Cby, w_buf, hk)


def control_constants(cfg: EngineConfig, device):
    """(1 / R (nu,), u_min (nu,), u_max (nu,)) as float32 tensors on
    ``device``, made once per (configuration, device): 1 / R is the float32
    division of 1 by float32(r), as K1's parameter block holds it."""
    def make():
        kw = dict(dtype=torch.float32, device=device)
        return (1.0 / torch.tensor(cfg.r_diag, **kw), torch.tensor(cfg.u_min, **kw),
                torch.tensor(cfg.u_max, **kw))

    return constant(("controls", tuple(cfg.r_diag), tuple(cfg.u_min), tuple(cfg.u_max)),
                    device, make)


def descent(cfg: EngineConfig, model, x, U_warm, hist_sum, n_hist, phik, domain,
            patch, lam, hk):
    """One ergodic descent step for every scenario: rollout -> c_k ->
    ergodic + barrier gradients -> backward co-state -> saturated update.

    Returns (U_new (S, H, nu), metric (S,), mean barrier value (S,))."""
    H = cfg.horizon
    X = rollout(model, x, U_warm, cfg.dt)  # (S, H+1, 3)
    knots = X[:, :-1]
    P = knots[..., :2]
    tbl = basis.tables(P, cfg.num_basis, domain)
    roll_sum = basis.coefficients(tbl, torch.ones_like(P[..., 0]), hk)
    M = n_hist + H
    ck = (hist_sum + roll_sum) / M[:, None, None]
    e = basis.ergodic_gradient(tbl, ck, phik, lam, hk, M)  # (S, H, 2)
    bval, bgrad = barrier(P, domain, patch, cfg)
    g_xy = cfg.ergodic_weight * e + cfg.barrier_weight * bgrad
    gs = torch.cat([g_xy, torch.zeros_like(g_xy[..., :1])], dim=-1)
    rho = costate_solve(model.A(knots, U_warm), gs, cfg.dt)  # (S, H, 3)
    Bs = model.B(knots, U_warm)  # (S, H, 3, nu)
    r_inv, u_lo, u_hi = control_constants(cfg, x.device)
    # B^T rho summed in row order (as K1 sums it)
    bt = ((Bs[..., 0, :] * rho[..., 0:1] + Bs[..., 1, :] * rho[..., 1:2])
          + Bs[..., 2, :] * rho[..., 2:3])
    u_star = -bt * r_inv
    U_new = torch.clamp(u_star, u_lo, u_hi)
    return U_new, basis.ergodic_metric(ck, phik, lam), bval.mean(dim=-1)


def safety_on_crop(cfg: EngineConfig, model, x, vb, u0, domain, crop):
    """Validation of u0 + the DWA fallback on ``crop``, a PatchField whose
    nearest-cell clearance is all they read.
    Returns (code (S,) int32, u_dwa (S, nu), feasible (S,) bool)."""
    code = validate_control(model, x, u0, domain, crop, cfg)
    u_dwa, feasible = dwa_control(model, x, vb, u0, domain, crop, cfg)
    return code, u_dwa, feasible


def safety(cfg: EngineConfig, model, x, vb, u0, domain, patch):
    """:func:`safety_on_crop` on the central crop of the patch."""
    return safety_on_crop(cfg, model, x, vb, u0, domain,
                          patch.center_crop(cfg.safety_patch_cells))


def finish_tick(cfg: EngineConfig, state: ControllerState, x, U_new, safety_out, ck_sum,
                metric, bcost, orbiting, shared_key: bool = False, advance: bool = False,
                ring_in_place: bool = False):
    """Shared tail of a tick (``glue_post``: the DWA select, the divergence
    guard, the warm-start shift, the ring append, ``hist_count + 1`` and the
    next keys; a kernel on the card). ``safety_out`` is (code, u_dwa,
    feasible (int32)) or None (safety disabled); with ``shared_key`` every
    row's next key is row 0's. Returns (new_state, u_cmd, diag), and with
    ``advance`` also the poses one dt on through the true kinematics and their
    body twists. With ``ring_in_place`` the pose is appended into
    ``state.buffer.states`` itself, which the new state shares: for a state
    its caller owns and advances (a graph's static buffers)."""
    from eebench.reference.ops.tick_glue import glue_post

    post = glue_post(cfg, shared_key, U_new, safety_out, state.buffer, state.hist_count,
                     state.rng, x, advance, ring_in_place)
    new_state = ControllerState(U=post.U, buffer=post.buffer, ck_sum=ck_sum,
                                hist_count=post.hist_count, rng=post.rng)
    diag = StepDiagnostics(
        ergodic_metric=metric,
        barrier_cost=bcost,
        collision_code=post.code,
        dwa_active=post.dwa_active,
        dwa_feasible=post.feasible,
        diverged=post.diverged,
        orbit_reset=orbiting,
    )
    if advance:
        return new_state, post.u, diag, post.x, post.vb
    return new_state, post.u, diag


@dataclass(frozen=True)
class ErgodicController:
    """Batched ergodic MPC (the JAX package's ``jax.vmap(step)``)."""

    config: EngineConfig

    def __post_init__(self):
        self.config.validate()

    @property
    def model(self):
        return make_model(self.config)

    def init_state(self, rng: torch.Tensor) -> ControllerState:
        """Fresh state for keys ``rng`` (S, 2): one scenario per key row
        (a row of zeros is the JAX package's default ``PRNGKey(0)``)."""
        cfg = self.config
        S, dev = rng.shape[0], rng.device
        K = cfg.num_basis
        return ControllerState(
            U=torch.zeros((S, cfg.horizon, cfg.nu), dtype=torch.float32, device=dev),
            buffer=RingBuffer.create(cfg.buffer_capacity, S, device=dev),
            ck_sum=torch.zeros((S, K, K), dtype=torch.float32, device=dev),
            hist_count=torch.zeros((S,), dtype=torch.int32, device=dev),
            rng=rng,
        )

    def target_coefficients(self, phi_vals, points, domain: Domain):
        """phi_k (..., K, K) from normalized phi samples (..., N) at shared
        points (N, 2) on an unbatched domain."""
        K = self.config.num_basis
        tbl = basis.tables(points, K, domain)
        return basis.coefficients(tbl, phi_vals, basis.hk_norm(K, domain.lengths))

    def step(self, state: ControllerState, x, vb, phik, world: World, advance: bool = False,
             ring_in_place: bool = False):
        """One ergodic-MPC tick for every scenario.

        x (S, 3) poses, vb (S, 3) body twists, phik (S, K, K) targets.
        Returns (new_state, u_cmd (S, nu), StepDiagnostics), and with
        ``advance`` also the poses one dt on and their twists (see
        :func:`finish_tick`, also for ``ring_in_place``).

        The chain of the fused tick with the step's own semantics:
        ``glue_pre`` (per-scenario draws, the full ring's or the accumulate
        mode's sums, the patch starts), K1 without its safety stage (the
        descent and the ``ck_sum`` append, the patch read from the map by its
        start), validation + DWA (``fused_safety_map``) on the central
        ``safety_patch_cells`` crop of that patch, read from the map too,
        ``glue_post``. On CPU tensors each stage is its plain version
        (:func:`descent`, :func:`safety_on_crop` on the gathered crop), on
        CUDA tensors its kernel.
        """
        from eebench.reference.ops.solve_kernel import (
            fused_safety_map, fused_solve, fused_tick_inputs)

        cfg = self.config
        S, K = x.shape[0], cfg.num_basis
        inp, orbiting = fused_tick_inputs(cfg, state, x, vb, phik, world, fused=False)
        out = fused_solve(cfg, inp)
        safety_out = None
        if cfg.enable_safety:
            safety_out = fused_safety_map(cfg, inp.x, inp.vb, out.U_new, inp.dist, inp.pstart,
                                          inp.porigin, inp.pres, inp.dorigin, inp.dlen)
        return finish_tick(cfg, state, inp.x, out.U_new, safety_out, out.ck_sum.view(S, K, K),
                           out.metric, out.barrier, orbiting, advance=advance,
                           ring_in_place=ring_in_place)

    def predicted_path(self, state: ControllerState, x) -> torch.Tensor:
        """(S, H+1, 3) forward-simulated path of each scenario's control
        sequence from poses ``x`` (S, 3) (the reference publishes it as a
        ``nav_msgs/Path``)."""
        return rollout(self.model, x, state.U, self.config.dt)
