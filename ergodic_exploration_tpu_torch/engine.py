"""The batched engine: many ergodic-MPC scenarios per tick on one device
(port of the single-device subset of ``ergodic_exploration_tpu/engine.py``).

    engine = Engine(config, device="cuda")
    sc     = engine.init_scenarios(x0s)                       # (S, 3) poses
    world  = engine.prepare_world(grids)                      # map cadence
    sc, us, diags = engine.replan_refresh(sc, gmm, domain, world)   # one tick

Every tensor carries the scenario axis first. The tick runs eagerly; with
``use_fused_solve`` + ``shared_maps`` on a shared domain (the bench
configuration) it is one launch of K1 (ops/solve_kernel.py) between small
batched PyTorch stages. Device meshes, ``explore`` and the MI target are
not ported yet (ROADMAP.md).

TF32 is switched off where the engine is built
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``): the history reductions and the
target contraction need full float32, as the JAX package's HIGHEST
precision gives them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ergodic_exploration_tpu_torch.config import EngineConfig
from ergodic_exploration_tpu_torch.controller import ControllerState, ErgodicController, World
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops import target as target_ops
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.utils import prng


class Scenarios(NamedTuple):
    """Batched solver state: one row per (map, start-pose) scenario."""

    state: ControllerState
    x: torch.Tensor  # (S, 3) poses
    vb: torch.Tensor  # (S, 3) body twists


class Engine:
    """Batched ergodic-MPC engine on one device.

    Args:
        config: controller configuration.
        device: the torch device every tensor of the engine lives on.
        mesh: not supported yet (multi-device scale-out is a later port).
    """

    def __init__(self, config: EngineConfig, device="cpu", mesh=None):
        if mesh is not None:
            raise NotImplementedError("Engine mesh paths are not ported yet")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config.validate()
        self.device = torch.device(device)
        self.controller = ErgodicController(config)
        self.model = self.controller.model
        self._validated = set()  # shared-geometry checks already made

    # ------------------------------------------------------------------
    # shared-geometry contract guards (utils/validation.py)
    # ------------------------------------------------------------------

    def _check_shared_world(self, world: World) -> None:
        if self.config.shared_maps and self.config.validate_shared:
            from ergodic_exploration_tpu_torch.utils.validation import check_shared_world

            check_shared_world(world, cache=self._validated)

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def init_scenarios(self, x0, vb0=None, rng=None) -> Scenarios:
        """Batched initial state for poses ``x0`` (S, 3). ``rng`` is a key
        (2,) of uint32 words (default: the words of ``jax.random.PRNGKey(0)``);
        under ``shared_history_draw`` every scenario gets that key, else
        ``split(rng, S)``."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        S = x0.shape[0]
        vb0 = (torch.zeros((S, 3), dtype=torch.float32, device=self.device) if vb0 is None
               else torch.as_tensor(vb0, dtype=torch.float32, device=self.device))
        key = torch.zeros(2, dtype=torch.int64, device=self.device) if rng is None else \
            torch.as_tensor(rng, device=self.device).to(torch.int64)
        keys = key.expand(S, 2).clone() if self.config.shared_history_draw else prng.split(key, S)
        return Scenarios(state=self.controller.init_state(keys), x=x0, vb=vb0)

    def prepare_world(self, grids: GridMap, domain: Optional[Domain] = None) -> World:
        """Batched world preprocessing (map cadence): EDT + gradient and the
        free-space phi mask per map; ``grids`` leaves lead with (S, ...).
        The domain is each map's extent unless ``domain`` is given."""
        cfg = self.config
        grids = GridMap(*(torch.as_tensor(t, device=self.device).to(torch.float32)
                          for t in grids))
        S = grids.data.shape[0]
        if cfg.shared_maps and cfg.validate_shared:
            from ergodic_exploration_tpu_torch.utils.validation import check_rows_shared

            check_rows_shared(grids, "grids (cfg.shared_maps)", cache=self._validated)
        if domain is None:
            dom = grids.domain()
        else:
            dom = Domain(domain.origin.expand(S, 2).contiguous(),
                         domain.lengths.expand(S, 2).contiguous())
        pts = dom.sample_lattice(cfg.grid_samples)  # (S, N, 2)
        free = (grids.occupancy_at(pts) < cfg.occupied_threshold).to(torch.float32)
        return World(domain=dom, dist=DistanceField.from_grid(grids, cfg.occupied_threshold),
                     free_mask=free)

    def _phik_from_gmm_fn(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """Batched target coefficients (S, K, K).

        Shared (unbatched) domain: one dense (S, N) @ (N, K^2) contraction;
        with ``shared_maps`` the shared free mask is folded into the table
        and the normalizer repaired from the k = (0, 0) coefficient. With
        ``use_pallas`` (and S % 8 == 0) the JAX package runs its K2 kernel
        here: on a CUDA device that kernel is not ported yet and this
        raises; on the CPU the plain contraction below is K2's plain version.
        """
        cfg = self.config
        K = cfg.num_basis
        S = gmm.means.shape[0]
        if domain.origin.dim() != 1:  # per-scenario domains
            pts = domain.sample_lattice(cfg.grid_samples)  # (S, N, 2)
            phi = target_ops.gmm_target_values(pts, gmm, free_mask=free_mask)
            return self.controller.target_coefficients(phi, pts, domain)
        if cfg.use_pallas and S % 8 == 0 and self.device.type != "cpu":
            raise NotImplementedError("K2 phik_from_gmm kernel not ported yet")
        pts = domain.sample_lattice(cfg.grid_samples)
        hk = basis.hk_norm(K, domain.lengths)
        D = basis.dense_table(basis.tables(pts, K, domain), hk)
        if free_mask is not None and cfg.shared_maps:
            m = (free_mask[0] if free_mask.dim() == 2 else free_mask).to(D.dtype)
            D = D * m[:, None]
            mask_ck = (D.sum(dim=0) / torch.clamp(m.sum(), min=1.0)).view(K, K)
            ck = basis.coefficients_dense(target_ops.gmm_target_values(pts, gmm), D, K)
            denom = hk[0, 0] * ck[:, 0, 0]  # phi mass on the free space
            return torch.where((denom > 1e-12)[:, None, None],
                               ck / torch.clamp(denom, min=1e-12)[:, None, None], mask_ck)
        phi = target_ops.gmm_target_values(pts, gmm, free_mask=free_mask)
        return basis.coefficients_dense(phi, D, K)

    def phik_from_gmm(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """Batched target coefficients for GMM targets; ``free_mask`` may be
        (S, N) or a batched :class:`World` (its ``free_mask`` is used)."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        return self._phik_from_gmm_fn(gmm, domain, free_mask)

    # ------------------------------------------------------------------
    # the batched API
    # ------------------------------------------------------------------

    def _replan_batched(self, state, x, vb, phik, world):
        if self.config.use_fused_solve:
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            return replan_batched_fused(self.config, self.model, state, x, vb, phik, world)
        return self.controller.step(state, x, vb, phik, world)

    def _replan_fn(self, sc: Scenarios, phik, world: World):
        state, u, diag = self._replan_batched(sc.state, sc.x, sc.vb, phik, world)
        return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag

    def replan(self, sc: Scenarios, phik, world: World):
        """One batched replan tick: (S,) solves -> (S, nu) controls. Does not
        advance the poses (the caller owns the plant)."""
        self._check_shared_world(world)
        return self._replan_fn(sc, phik, world)

    def _refresh_and_replan_fn(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """GMM target refresh + batched solve: the full per-tick work. With
        the fused solve + shared maps on a shared domain the refresh runs
        inside K1 — the whole tick is one kernel launch."""
        cfg = self.config
        if cfg.use_fused_solve and cfg.shared_maps and domain.origin.dim() == 1:
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            state, u, diag = replan_batched_fused(cfg, self.model, sc.state, sc.x, sc.vb,
                                                  None, world, gmm=gmm, domain=domain)
            return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag
        phik = self._phik_from_gmm_fn(gmm, domain, world.free_mask)
        return self._replan_fn(sc, phik, world)

    def replan_refresh(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """One batched tick including the per-tick GMM target refresh (the
        tick ``bench.py`` times in the JAX package)."""
        self._check_shared_world(world)
        return self._refresh_and_replan_fn(sc, gmm, domain, world)
