"""The benchmark's plain reference engine: the entry points the cells drive,
as plain PyTorch loops over the frozen modules of this package.

Frozen from ``ergodic_exploration_tpu_torch/engine.py`` at commit
e20fa1114c5b (``init_scenarios``, ``prepare_world``, ``phik_from_gmm``,
``replan_refresh``, ``replan_refresh_mi``, ``explore`` and
``explore_mapping_fused`` as their eager functions run on the CPU), without
meshes, graphs or kernels: every stage is the plain version, on whatever
device the inputs lie. It imports nothing of the program.

``RefEngine(cfg, device, tf32=False)`` has the same methods and returns the
same tuples as the program's ``Engine``, so the harness can put it in the
program's place. With ``tf32`` its float32 matrix products run in TF32:
that is the control, the reference in the nearest precision below the
configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from eebench.reference.controller import ErgodicController, StepDiagnostics, World
from eebench.reference.grid import Domain, GridMap
from eebench.reference.ops import basis, sensor
from eebench.reference.ops.distance import DistanceField
from eebench.reference.ops.edt_kernel import world_plain
from eebench.reference.ops.gmm_kernel import phik_from_gmm_plain
from eebench.reference.ops.mi_dense_kernel import dense_operands, phik_dense_plain
from eebench.reference.ops.mi_kernel import mi_operands, phik_from_grid_plain
from eebench.reference.ops.solve_kernel import lattice_operands, replan_batched_fused
from eebench.reference.ops.target import GaussianMixture
from eebench.reference.utils import prng

__all__ = ["RefEngine", "Scenarios", "ExploreOutput", "GridMap", "Domain", "GaussianMixture"]


class Scenarios(NamedTuple):
    state: object  # controller.ControllerState
    x: torch.Tensor  # (S, 3)
    vb: torch.Tensor  # (S, 3)


class ExploreOutput(NamedTuple):
    scenarios: Scenarios
    trajectory: torch.Tensor  # (T, S, 3)
    controls: torch.Tensor  # (T, S, nu)
    diag: StepDiagnostics  # leaves (T, S)


class RefEngine:
    """The plain reference of the program's ``Engine`` entry points."""

    def __init__(self, config, device, tf32: bool = False):
        self.config = config.validate()
        self.device = torch.device(device)
        self.controller = ErgodicController(config)
        self.model = self.controller.model
        self.tf32 = tf32

    @contextlib.contextmanager
    def _precision(self):
        """Float32 products in full float32 (TF32 off), or in TF32 for the
        control; the caller's setting is restored."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _here(self, tree):
        return type(tree)(*(torch.as_tensor(t, device=self.device) for t in tree))

    def init_scenarios(self, x0, rng=None) -> Scenarios:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        S = x0.shape[0]
        key = (torch.zeros(2, dtype=torch.int64, device=self.device) if rng is None
               else torch.as_tensor(rng, device=self.device).to(torch.int64))
        keys = (key.expand(S, 2).clone() if self.config.shared_history_draw
                else prng.split(key, S))
        return Scenarios(self.controller.init_state(keys), x0,
                         torch.zeros((S, 3), dtype=torch.float32, device=self.device))

    def prepare_world(self, grids: GridMap, domain: Optional[Domain] = None) -> World:
        grids = GridMap(*(torch.as_tensor(t, device=self.device).to(torch.float32)
                          for t in grids))
        S = grids.data.shape[0]
        if domain is None:
            dom = grids.domain()
        else:
            domain = self._here(domain)
            dom = Domain(domain.origin.expand(S, 2).contiguous(),
                         domain.lengths.expand(S, 2).contiguous())
        return self._world(grids, dom)

    def _world(self, grids: GridMap, dom: Domain) -> World:
        cfg = self.config
        d, g, free = world_plain(grids, dom, cfg.occupied_threshold, cfg.grid_samples)
        return World(domain=dom, dist=DistanceField(d, g, grids.origin, grids.resolution),
                     free_mask=free)

    def phik_from_gmm(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """K2's route on a shared domain (``Engine._phik_from_gmm_fn`` with
        ``use_pallas``): the shared free mask folded into the table, or the
        per-scenario mask on phi."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        cfg = self.config
        K = cfg.num_basis
        gmm, domain = self._here(gmm), self._here(domain)
        S = gmm.means.shape[0]
        with self._precision():
            pts = domain.sample_lattice(cfg.grid_samples)
            hk = basis.hk_norm(K, domain.lengths)
            D = basis.dense_table(basis.tables(pts, K, domain), hk)
            mask_ck = None
            if free_mask is not None and cfg.shared_maps:
                m = (free_mask[0] if free_mask.dim() == 2 else free_mask).to(D.dtype)
                D = D * m[:, None]
                mask_ck = (D.sum(dim=0) / torch.clamp(m.sum(), min=1.0)).view(K, K)
                free_mask = None
            mask = None if free_mask is None else free_mask.to(torch.float32)
            ck = phik_from_gmm_plain(*gmm, pts, D, mask).view(S, K, K)
            if mask_ck is None:
                return ck
            denom = hk[0, 0] * ck[:, 0, 0]
            return torch.where((denom > 1e-12)[:, None, None],
                               ck / torch.clamp(denom, min=1e-12)[:, None, None], mask_ck)

    def _replan(self, sc: Scenarios, phik, world: World, advance: bool = False):
        cfg = self.config
        if cfg.use_fused_solve:
            return replan_batched_fused(cfg, self.model, sc.state, sc.x, sc.vb, phik, world,
                                        advance=advance)
        return self.controller.step(sc.state, sc.x, sc.vb, phik, world, advance=advance)

    def replan_refresh(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """One tick with the GMM refresh (inside K1 on a shared map and
        domain, else K2's route ahead of the solve)."""
        cfg = self.config
        gmm, domain = self._here(gmm), self._here(domain)
        with self._precision():
            if cfg.use_fused_solve and cfg.shared_maps and domain.origin.dim() == 1:
                lattice = lattice_operands(cfg, domain, world.free_mask)
                state, u, diag = replan_batched_fused(cfg, self.model, sc.state, sc.x, sc.vb,
                                                      None, world, gmm=gmm, domain=domain,
                                                      lattice=lattice)
            else:
                phik = self.phik_from_gmm(gmm, domain, world.free_mask)
                state, u, diag = self._replan(sc, phik, world)
        return Scenarios(state, sc.x, sc.vb), u, diag

    def _geometry(self, grids: GridMap, domain: Optional[Domain]):
        """(scenario 0's map, the domain): the geometry operands depend on."""
        if domain is None:
            domain = Domain(origin=grids.origin[0], lengths=grids.domain().lengths[0])
        return GridMap(grids.data[0], grids.origin[0], grids.resolution[0]), domain

    def mi_target(self, grids: GridMap, domain: Domain, r: int) -> torch.Tensor:
        """K3's route: the MI target of every belief on a shared domain."""
        cfg = self.config
        g0, domain = self._geometry(grids, self._here(domain))
        with self._precision():
            ops = mi_operands(g0, domain, cfg.num_basis, cfg.grid_samples)
            return phik_from_grid_plain(grids.data.contiguous(), ops, r, cfg.mi_frontier_cells,
                                        cfg.occupied_threshold)

    def replan_refresh_mi(self, sc: Scenarios, grids: GridMap, world: World,
                          sensor_radius_cells: int = 0, domain: Optional[Domain] = None,
                          use_mi_kernel: bool = True):
        """One tick with the MI refresh by K3's route on a shared domain."""
        if domain is None or not use_mi_kernel:
            raise ValueError("the reference follows K3's route: a shared domain, use_mi_kernel")
        grids = GridMap(*(torch.as_tensor(t, device=self.device).to(torch.float32)
                          for t in grids))
        with self._precision():
            phik = self.mi_target(grids, domain, sensor_radius_cells)
            state, u, diag = self._replan(sc, phik, world)
        return Scenarios(state, sc.x, sc.vb), u, diag

    def tick(self, sc: Scenarios, phik, world: World):
        """One closed-loop tick: (Scenarios advanced one dt, u, diag)."""
        with self._precision():
            state, u, diag, x, vb = self._replan(sc, phik, world, advance=True)
        return Scenarios(state, x, vb), u, diag

    def explore(self, sc: Scenarios, phik, world: World, n_ticks: int) -> ExploreOutput:
        traj, ctrl, diags = [], [], []
        for _ in range(n_ticks):
            sc, u, diag = self.tick(sc, phik, world)
            traj.append(sc.x)
            ctrl.append(u)
            diags.append(diag)
        return ExploreOutput(sc, torch.stack(traj), torch.stack(ctrl),
                             StepDiagnostics(*(torch.stack(d) for d in zip(*diags))))

    def mapping_refresh(self, sc: Scenarios, belief: GridMap, truth: GridMap, win: int,
                        refresh_every: int, sensor_range: float, sensor_radius_cells: int,
                        ops=None, n_ticks: Optional[int] = None):
        """One refresh of ``explore_mapping_fused``: reveal, M, E, then
        ``refresh_every`` ticks (``n_ticks`` of them when given). Returns
        (Scenarios, belief, coverage, trajectory (n, S, 3), metric (n, S))."""
        cfg = self.config
        with self._precision():
            if ops is None:
                ops = dense_operands(*self._geometry(truth, None), cfg.num_basis,
                                     cfg.grid_samples)
            belief = sensor.reveal_raycast_plain(belief, truth, sc.x, sensor_range, win,
                                                 occupied_threshold=cfg.occupied_threshold,
                                                 chunk=1024)
            phik = phik_dense_plain(belief.data, ops, sensor_radius_cells,
                                    cfg.mi_frontier_cells, cfg.occupied_threshold)
            world = self._world(belief, belief.domain())
            out = self.explore(sc, phik, world, refresh_every if n_ticks is None else n_ticks)
        return (out.scenarios, belief, sensor.fraction_known_plain(belief), out.trajectory,
                out.diag.ergodic_metric)

    def explore_mapping_fused(self, sc: Scenarios, truth: GridMap, n_refreshes: int,
                              refresh_every: int = 10, sensor_range: float = 1.5,
                              sensor_radius_cells: int = 0):
        cfg = self.config
        truth = GridMap(*(torch.as_tensor(t, device=self.device).to(torch.float32)
                          for t in truth))
        win = sensor.raycast_window_cells(sensor_range, float(truth.resolution.min()))
        ops = dense_operands(*self._geometry(truth, None), cfg.num_basis, cfg.grid_samples)
        belief = truth._replace(data=torch.full_like(truth.data, -1.0))
        cov, traj, metric = [], [], []
        for _ in range(n_refreshes):
            sc, belief, c, tr, m = self.mapping_refresh(sc, belief, truth, win, refresh_every,
                                                        sensor_range, sensor_radius_cells, ops)
            cov.append(c)
            traj.append(tr)
            metric.append(m)
        return sc, belief, torch.stack(cov), torch.stack(traj), torch.stack(metric)
