"""The receding-horizon ergodic controller, batched over scenarios (port of
``ergodic_exploration_tpu/controller.py``; ``jax.vmap(step)`` becomes one
eager step on tensors whose leading axis is the scenario).

One tick (SURVEY.md section 4.2): roll the warm-started controls out, form
c_k over [history || rollout], take the ergodic and barrier gradients at
the knots, integrate the co-state backward, update u = sat(-R^-1 B^T rho),
validate the emitted control and fall back to DWA on a predicted crash.
The descent and safety stages are shared with the plain version of the
fused kernel (ops/solve_kernel.py). In the eager :meth:`ErgodicController.step`
the descent is batched PyTorch ops (the JAX package has no kernel there
either); its safety stage goes through ``ops.solve_kernel.fused_safety``: the
CUDA kernel for CUDA tensors, :func:`safety_on_crop` for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ergodic_exploration_tpu_torch.config import EngineConfig
from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.models import make_model
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops.barrier import barrier
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.ops.collision import CRASH, validate_control
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.ops.dwa import dwa_control
from ergodic_exploration_tpu_torch.ops.integrator import costate_solve, rollout
from ergodic_exploration_tpu_torch.ops.patch import extract_patch
from ergodic_exploration_tpu_torch.utils import prng


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


def history_sums(cfg: EngineConfig, state: ControllerState, sub: torch.Tensor,
                 domain: Domain, hk: torch.Tensor):
    """History term of c_k: (sum of F_k over the history (S, K, K), its
    state count (S,)) for the ring (sampled batch or full) or accumulate
    mode. ``sub`` (S, 2) are this tick's draw keys."""
    K = cfg.num_basis
    if cfg.history == "accumulate":
        return state.ck_sum, state.hist_count.to(torch.float32)
    buf = state.buffer
    if cfg.buffer_batch is not None:
        s_buf, n_hist = buf.sample_states(cfg.buffer_batch, sub)
        return drawn_history_sums(s_buf, n_hist, K, domain, hk), n_hist
    Cbx, Cby = basis.cos_tables(buf.positions, K, domain)
    w_buf = buf.sample_mask(None, sub)
    return basis.coefficients_cos(Cbx, Cby, w_buf, hk), w_buf.sum(dim=-1)


def drawn_history_sums(s_buf: torch.Tensor, n_hist: torch.Tensor, K: int, domain: Domain,
                       hk: torch.Tensor) -> torch.Tensor:
    """Sum of F_k (S, K, K) over the positions drawn from the ring buffer,
    ``s_buf`` (S, nb, 2); an empty buffer (``n_hist`` = 0) gives zeros."""
    Cbx, Cby = basis.cos_tables(s_buf, K, domain)
    w_buf = (n_hist > 0).to(torch.float32)[:, None].expand(-1, s_buf.shape[1])
    return basis.coefficients_cos(Cbx, Cby, w_buf, hk)


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
    kw = dict(dtype=torch.float32, device=x.device)
    r_inv = 1.0 / torch.tensor(cfg.r_diag, **kw)
    # B^T rho summed in row order (as K1 sums it)
    bt = ((Bs[..., 0, :] * rho[..., 0:1] + Bs[..., 1, :] * rho[..., 1:2])
          + Bs[..., 2, :] * rho[..., 2:3])
    u_star = -bt * r_inv
    U_new = torch.clamp(u_star, torch.tensor(cfg.u_min, **kw), torch.tensor(cfg.u_max, **kw))
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


def finish_tick(cfg: EngineConfig, state: ControllerState, x, U_new, u0, safety_out,
                ck_sum, rng, metric, bcost, orbiting):
    """Shared tail of a tick: DWA select, divergence guard, warm-start
    shift, ring append. ``safety_out`` is (code, u_dwa, feasible) or None
    (safety disabled)."""
    S = x.shape[0]
    if safety_out is not None:
        code, u_dwa, feasible = safety_out
        use_dwa = code >= CRASH
        u_cmd = torch.where(use_dwa[:, None], u_dwa, u0)
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
    new_state = ControllerState(
        U=U_next,
        buffer=state.buffer.append(x[:, :2]),
        ck_sum=ck_sum,
        hist_count=state.hist_count + 1,
        rng=rng,
    )
    diag = StepDiagnostics(
        ergodic_metric=metric,
        barrier_cost=bcost,
        collision_code=code,
        dwa_active=use_dwa,
        dwa_feasible=feasible,
        diverged=diverged,
        orbit_reset=orbiting,
    )
    return new_state, u_cmd, diag


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

    def step(self, state: ControllerState, x, vb, phik, world: World):
        """One ergodic-MPC tick for every scenario.

        x (S, 3) poses, vb (S, 3) body twists, phik (S, K, K) targets.
        Returns (new_state, u_cmd (S, nu), StepDiagnostics).
        """
        cfg = self.config
        model = self.model
        K = cfg.num_basis
        domain = world.domain
        lam = basis.lambda_weights(K, device=x.device)
        hk = basis.hk_norm(K, domain.lengths)
        patch = extract_patch(world.dist, x[:, :2], cfg.patch_cells)

        orbiting = orbit_guard(cfg, state.buffer, x[:, :2])
        U_warm = torch.where(orbiting[:, None, None], torch.zeros_like(state.U), state.U)

        keys = prng.split(state.rng)  # (S, 2, 2)
        rng, sub = keys[:, 0], keys[:, 1]
        hist_sum, n_hist = history_sums(cfg, state, sub, domain, hk)
        U_new, metric, bcost = descent(cfg, model, x, U_warm, hist_sum, n_hist, phik,
                                       domain, patch, lam, hk)
        u0 = U_new[:, 0]
        safety_out = None
        if cfg.enable_safety:
            from ergodic_exploration_tpu_torch.ops.solve_kernel import fused_safety

            crop = patch.center_crop(cfg.safety_patch_cells)
            code, u_dwa, feas = fused_safety(
                cfg, x.contiguous(), vb.contiguous(), u0.contiguous(), crop.dist.contiguous(),
                crop.start.to(torch.int32), crop.origin.contiguous(),
                crop.resolution.contiguous(), domain.origin.contiguous(),
                domain.lengths.contiguous())
            safety_out = (code, u_dwa, feas.to(torch.bool))

        # history: the running basis sum gains F_k at the ACTUAL current pose
        Cnx, Cny = basis.cos_tables(x[:, None, :2], K, domain)
        ck_sum = state.ck_sum + basis.coefficients_cos(Cnx, Cny, torch.ones_like(x[:, :1]), hk)
        return finish_tick(cfg, state, x, U_new, u0, safety_out, ck_sum, rng, metric,
                           bcost, orbiting)

    def predicted_path(self, state: ControllerState, x) -> torch.Tensor:
        """(S, H+1, 3) forward-simulated path of each scenario's control
        sequence from poses ``x`` (S, 3) (the reference publishes it as a
        ``nav_msgs/Path``)."""
        return rollout(self.model, x, state.U, self.config.dt)
