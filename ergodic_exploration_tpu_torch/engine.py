"""The batched engine: many ergodic-MPC scenarios per tick on one device
(port of the single-device subset of ``ergodic_exploration_tpu/engine.py``).

    engine = Engine(config)                                   # the CUDA device
    sc     = engine.init_scenarios(x0s)                       # (S, 3) poses
    world  = engine.prepare_world(grids)                      # map cadence
    phik   = engine.phik_from_gmm(gmm, domain, world)         # K2
    out    = engine.explore(sc, phik, world, n_ticks=200)     # closed loop
    engine.save_checkpoint("run.npz", out.scenarios)          # resume later
    sc, us, diags = engine.replan_refresh(sc, gmm, domain, world)   # one tick

``Engine(config)`` runs on the CUDA device and raises when there is none;
``Engine(config, device="cpu")`` runs on the CPU, where every kernel wrapper
takes its plain PyTorch version. Every tensor carries the scenario axis
first. The tick runs eagerly: with ``use_fused_solve`` it is one launch of K1
(ops/solve_kernel.py) between small batched PyTorch stages, otherwise the
batched controller step whose safety stage is the ``fused_safety`` kernel;
``phik_from_gmm`` with ``use_pallas`` goes through K2 (ops/gmm_kernel.py).
Device meshes and the MI target are not ported yet (ROADMAP.md).

TF32 is switched off where the engine is built
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``): the history reductions and the
target contraction need full float32, as the JAX package's HIGHEST
precision gives them.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ergodic_exploration_tpu_torch.config import EngineConfig
from ergodic_exploration_tpu_torch.controller import (
    ControllerState,
    ErgodicController,
    StepDiagnostics,
    World,
)
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops import target as target_ops
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.ops.integrator import rollout
from ergodic_exploration_tpu_torch.utils import prng
from ergodic_exploration_tpu_torch.utils.device import resolve_device

# dtypes of the StepDiagnostics leaves, in field order
_DIAG_DTYPES = (torch.float32, torch.float32, torch.int32, torch.bool, torch.bool,
                torch.bool, torch.bool)


class Scenarios(NamedTuple):
    """Batched solver state: one row per (map, start-pose) scenario."""

    state: ControllerState
    x: torch.Tensor  # (S, 3) poses
    vb: torch.Tensor  # (S, 3) body twists


class ExploreOutput(NamedTuple):
    scenarios: Scenarios  # final state after n_ticks
    trajectory: torch.Tensor  # (T, S, 3) poses over time
    controls: torch.Tensor  # (T, S, nu) emitted controls
    diag: StepDiagnostics  # per-tick diagnostics, leaves (T, S)

    @property
    def ergodic_metric(self):
        return self.diag.ergodic_metric


class Engine:
    """Batched ergodic-MPC engine on one device.

    Args:
        config: controller configuration.
        device: the torch device every tensor of the engine lives on; None
            (the default) is the CUDA device, and raises when there is none.
            Pass ``"cpu"`` to run on the CPU.
        mesh: not supported yet (multi-device scale-out is a later port).
    """

    def __init__(self, config: EngineConfig, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("Engine mesh paths are not ported yet")
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config.validate()
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

    def _here(self, tree):
        """A NamedTuple of tensors (a target, a domain) on the engine's
        device: what a caller made elsewhere is moved, never computed on
        where it lies."""
        return type(tree)(*(t.to(self.device) for t in tree))

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
            domain = self._here(domain)
            dom = Domain(domain.origin.expand(S, 2).contiguous(),
                         domain.lengths.expand(S, 2).contiguous())
        pts = dom.sample_lattice(cfg.grid_samples)  # (S, N, 2)
        free = (grids.occupancy_at(pts) < cfg.occupied_threshold).to(torch.float32)
        return World(domain=dom, dist=DistanceField.from_grid(grids, cfg.occupied_threshold),
                     free_mask=free)

    def empty_world(self, domain: Domain, n: int) -> World:
        """Obstacle-free batched world of ``n`` scenarios over an unbatched
        ``domain``."""
        one = World.empty(self._here(domain))

        def rows_n(t):
            return t.expand(n, *t.shape).contiguous()

        return World(domain=Domain(*map(rows_n, one.domain)),
                     dist=DistanceField(*map(rows_n, one.dist)), free_mask=None)

    def _phik_from_gmm_fn(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """Batched target coefficients (S, K, K).

        Shared (unbatched) domain: the lattice and the dense table D (N, K^2)
        are the same for every scenario. With ``shared_maps`` the shared free
        mask is folded into D and the normalizer repaired from the k = (0, 0)
        coefficient; otherwise a per-scenario (S, N) mask multiplies phi
        before the normalizer. With ``use_pallas`` (the default) the
        reduction is K2 (ops/gmm_kernel.py: the CUDA kernel on the card for
        every S, its plain version on the CPU); without it, the plain dense
        contraction. Per-scenario domains take the separable contraction.
        """
        cfg = self.config
        K = cfg.num_basis
        S = gmm.means.shape[0]
        if domain.origin.dim() != 1:  # per-scenario domains
            pts = domain.sample_lattice(cfg.grid_samples)  # (S, N, 2)
            phi = target_ops.gmm_target_values(pts, gmm, free_mask=free_mask)
            return self.controller.target_coefficients(phi, pts, domain)
        pts = domain.sample_lattice(cfg.grid_samples)
        hk = basis.hk_norm(K, domain.lengths)
        D = basis.dense_table(basis.tables(pts, K, domain), hk)
        mask_ck = None
        if free_mask is not None and cfg.shared_maps:
            m = (free_mask[0] if free_mask.dim() == 2 else free_mask).to(D.dtype)
            D = D * m[:, None]
            mask_ck = (D.sum(dim=0) / torch.clamp(m.sum(), min=1.0)).view(K, K)
            free_mask = None
        if cfg.use_pallas:
            from ergodic_exploration_tpu_torch.ops.gmm_kernel import phik_from_gmm

            g = [t.contiguous() for t in gmm]
            mask = None if free_mask is None else free_mask.to(torch.float32).contiguous()
            ck = phik_from_gmm(*g, pts.contiguous(), D.contiguous(), mask).view(S, K, K)
        else:
            phi = target_ops.gmm_target_values(pts, gmm, free_mask=free_mask)
            ck = basis.coefficients_dense(phi, D, K)
        if mask_ck is None:
            return ck
        denom = hk[0, 0] * ck[:, 0, 0]  # phi mass on the free space
        return torch.where((denom > 1e-12)[:, None, None],
                           ck / torch.clamp(denom, min=1e-12)[:, None, None], mask_ck)

    def phik_from_gmm(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """Batched target coefficients for GMM targets; ``free_mask`` may be
        (S, N) or a batched :class:`World` (its ``free_mask`` is used)."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        if free_mask is not None:
            free_mask = free_mask.to(self.device)
        return self._phik_from_gmm_fn(self._here(gmm), self._here(domain), free_mask)

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
        return self._refresh_and_replan_fn(sc, self._here(gmm), self._here(domain), world)

    # ------------------------------------------------------------------
    # the closed loop
    # ------------------------------------------------------------------

    def _tick_batched(self, state, x, vb, phik, world):
        """One replan + one dt of real motion through the true kinematics."""
        state, u, diag = self._replan_batched(state, x, vb, phik, world)
        x_next = rollout(self.model, x, u[:, None, :], self.config.dt)[:, -1]
        return state, x_next, self.model.twist(u), u, diag

    def explore(self, sc: Scenarios, phik, world: World, n_ticks: int) -> ExploreOutput:
        """Closed-loop batched exploration on the engine's device: each tick
        replans and applies the emitted control for one dt. The JAX
        package's ``lax.scan`` is a Python loop here that writes into
        preallocated (T, S, ...) tensors and never waits for the device."""
        S, nu = sc.x.shape[0], self.config.nu
        kw = dict(device=sc.x.device)
        traj = torch.empty((n_ticks, S, 3), dtype=torch.float32, **kw)
        ctrl = torch.empty((n_ticks, S, nu), dtype=torch.float32, **kw)
        diags = StepDiagnostics(*(torch.empty((n_ticks, S), dtype=dt, **kw)
                                  for dt in _DIAG_DTYPES))
        state, x, vb = sc.state, sc.x, sc.vb
        for t in range(n_ticks):
            state, x, vb, u, diag = self._tick_batched(state, x, vb, phik, world)
            traj[t], ctrl[t] = x, u
            for rows, leaf in zip(diags, diag):
                rows[t] = leaf
        return ExploreOutput(scenarios=Scenarios(state=state, x=x, vb=vb), trajectory=traj,
                             controls=ctrl, diag=diags)

    # ------------------------------------------------------------------
    # startup
    # ------------------------------------------------------------------

    def warmup(self, S: int, domain: Domain, map_shape=None, gmm_components: int = 1,
               n_ticks=()) -> dict:
        """Pay the startup costs before the first real tick: on a CUDA device
        build (or load) every kernel library, then run each entry point once
        on dummy data of ``S`` scenarios: ``init_scenarios``, ``prepare_world``
        (when ``map_shape`` is given, else an empty world), ``phik_from_gmm``,
        ``replan``, ``replan_refresh`` and ``explore`` for each length in
        ``n_ticks``. Returns {stage: seconds}. The MI stages of the JAX
        package's warmup (``phik_from_grid``, ``replan_refresh_mi``) come with
        the MI part of the port (ROADMAP.md).
        """
        timings = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[name] = round(time.perf_counter() - t0, 3)
            return out

        if self.device.type == "cuda":
            from ergodic_exploration_tpu_torch.utils.cuda_build import build_all

            timed("build_kernels", build_all)
        domain = self._here(domain)
        J = gmm_components
        gmm = target_ops.GaussianMixture.create(
            means=np.full((S, J, 2), 0.5, np.float32),
            covs=np.tile(np.eye(2, dtype=np.float32)[None, None], (S, J, 1, 1)),
            weights=np.ones((S, J), np.float32), device=self.device)
        sc = timed("init_scenarios", lambda: self.init_scenarios(np.zeros((S, 3), np.float32)))
        if map_shape is not None:
            res = float(domain.lengths[0]) / map_shape[1]
            grids = GridMap(
                data=torch.zeros((S,) + tuple(map_shape), dtype=torch.float32),
                origin=domain.origin.expand(S, 2),
                resolution=torch.full((S,), res, dtype=torch.float32))
            world = timed("prepare_world", lambda: self.prepare_world(grids))
        else:
            world = self.empty_world(domain, S)
        phik = timed("phik_from_gmm", lambda: self.phik_from_gmm(gmm, domain, world.free_mask))
        timed("replan", lambda: self.replan(sc, phik, world))
        timed("replan_refresh", lambda: self.replan_refresh(sc, gmm, domain, world))
        for n in n_ticks:
            timed(f"explore_{n}", lambda n=n: self.explore(sc, phik, world, n))
        return timings

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str, sc: Scenarios) -> None:
        """Snapshot the full batched solver state to ``path`` (.npz), in the
        JAX package's checkpoint format: a file either package wrote loads
        in the other. The key words are written as uint32, as JAX holds
        them."""
        from ergodic_exploration_tpu_torch.utils.checkpoint import save_pytree
        from ergodic_exploration_tpu_torch.utils.interop import to_numpy

        tree = to_numpy(sc)
        state = tree.state._replace(rng=tree.state.rng.astype(np.uint32))
        save_pytree(path, tree._replace(state=state))

    def load_checkpoint(self, path: str) -> Scenarios:
        """Restore :class:`Scenarios` saved by :meth:`save_checkpoint` (of
        this package or of the JAX package) onto this engine's device."""
        from ergodic_exploration_tpu_torch.utils.checkpoint import load_pytree

        with np.load(path) as data:
            # every Scenarios leaf has the scenario count as its leading axis
            leaf_keys = sorted(k for k in data.files if k.startswith("leaf_"))
            S = data[leaf_keys[0]].shape[0]
        like = self.init_scenarios(np.zeros((S, 3), np.float32))
        return load_pytree(path, like)
