"""The batched engine: many ergodic-MPC scenarios per tick, on one device or
sharded over ranks (port of ``ergodic_exploration_tpu/engine.py``).

    engine = Engine(config)                                   # the CUDA device
    sc     = engine.init_scenarios(x0s)                       # (S, 3) poses
    world  = engine.prepare_world(grids)                      # map cadence
    phik   = engine.phik_from_gmm(gmm, domain, world)         # K2
    out    = engine.explore(sc, phik, world, n_ticks=200)     # closed loop
    engine.save_checkpoint("run.npz", out.scenarios)          # resume later
    sc, us, diags = engine.replan_refresh(sc, gmm, domain, world)   # one tick

    phik   = engine.phik_from_grid(beliefs, domain=domain)    # MI target
    sc, us, diags = engine.replan_refresh_mi(                 # one MI tick (K3)
        sc, beliefs, world, sensor_radius_cells=3, domain=domain, use_mi_kernel=True)
    sc, belief, coverage, traj, metric = engine.explore_mapping_fused(
        sc, truth, n_refreshes=50)                            # sense, map, plan, act

``Engine(config)`` runs on the CUDA device and raises when there is none;
``Engine(config, device="cpu")`` runs on the CPU, where every kernel wrapper
takes its plain PyTorch version. Every tensor carries the scenario axis
first. The tick runs eagerly: with ``use_fused_solve`` it is one launch of K1
(ops/solve_kernel.py) between small batched PyTorch stages, otherwise the
batched controller step whose safety stage is the ``fused_safety`` kernel;
``phik_from_gmm`` with ``use_pallas`` goes through K2 (ops/gmm_kernel.py).
The mutual-information target is recomputed from the belief maps by
``phik_from_grid`` (dense on a shared domain, separable otherwise) and, in
``replan_refresh_mi(..., domain=<shared>, use_mi_kernel=True)``, by K3
(ops/mi_kernel.py); ``explore_mapping`` and ``explore_mapping_fused`` close
the loop with the range sensor of ops/sensor.py.

Scale-out (``Engine(config, mesh=make_scenario_mesh())`` or
``make_mesh(n_scenario, n_sample)``, over ``torch.distributed``: one process a
device, see ``parallel``): the constructors (``init_scenarios``,
``prepare_world``, ``empty_world``, ``phik_from_gmm``, ``phik_from_grid``,
``load_checkpoint``) take the GLOBAL batch and return this rank's rows; the
tick methods take those local slices, and a per-tick input (a target,
beliefs, a truth map) is laid out by the caller with ``shard_scenarios``. A
tick on the ``scenario`` dim needs no communication; a populated ``sample``
dim splits the target's lattice and combines it with two ``all_reduce``.
``save_checkpoint`` is collective.

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
    """Batched ergodic-MPC engine.

    Args:
        config: controller configuration.
        device: the torch device every tensor of the engine lives on; None
            (the default) is the CUDA device, and raises when there is none.
            Pass ``"cpu"`` to run on the CPU.
        mesh: optional ``DeviceMesh`` (``make_scenario_mesh``, ``make_mesh``)
            with a ``scenario`` dim. The engine then lives on the mesh's
            device: the rank's current CUDA device under a CUDA mesh (which
            raises where there is no card), the CPU under a CPU mesh.
    """

    SCENARIO_AXIS = "scenario"
    SAMPLE_AXIS = "sample"

    def __init__(self, config: EngineConfig, device=None, mesh=None):
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None)
            if not names or self.SCENARIO_AXIS not in names:
                raise ValueError(f"mesh must have a {self.SCENARIO_AXIS!r} axis, got {names}")
            on_card = mesh.device_type == "cuda"
            mesh_dev = torch.device("cuda", torch.cuda.current_device()) if (
                on_card and torch.cuda.is_available()) else torch.device(mesh.device_type)
            if device is not None and torch.device(device).type != mesh_dev.type:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device_type!r}")
            device = mesh_dev
        self.mesh = mesh
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config.validate()
        self.controller = ErgodicController(config)
        self.model = self.controller.model
        self._validated = set()  # shared-geometry checks already made
        self._mi_operands = {}  # geometry key -> (tensors of the key, MiOperands)

    # ------------------------------------------------------------------
    # shared-geometry contract guards (utils/validation.py)
    # ------------------------------------------------------------------

    def _check_shared_world(self, world: World) -> None:
        if self.config.shared_maps and self.config.validate_shared:
            from ergodic_exploration_tpu_torch.utils.validation import check_shared_world

            check_shared_world(world, cache=self._validated)

    def _check_shared_grids(self, grids: GridMap) -> None:
        if self.config.validate_shared:
            from ergodic_exploration_tpu_torch.utils.validation import (
                check_shared_grid_geometry,
            )

            check_shared_grid_geometry(grids, cache=self._validated)

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _here(self, tree):
        """A NamedTuple of tensors (a target, a domain) on the engine's
        device: what a caller made elsewhere is moved, never computed on
        where it lies."""
        return type(tree)(*(torch.as_tensor(t, device=self.device) for t in tree))

    # ------------------------------------------------------------------
    # sharding plumbing
    # ------------------------------------------------------------------

    def _rows(self, S: int):
        """(lo, hi): the rows of a global batch of S scenarios this rank
        holds ((0, S) without a mesh)."""
        if self.mesh is None:
            return 0, S
        from ergodic_exploration_tpu_torch.parallel import process_scenario_slice

        return process_scenario_slice(S, self.mesh)

    def shard_scenarios(self, tree):
        """This rank's rows of a batched tree whose leaves are GLOBAL-shaped
        (tensors or arrays, the scenario axis first), on the engine's device.
        Every rank passes the same global value. Without a mesh the tree is
        returned as it is."""
        if self.mesh is None:
            return tree
        from ergodic_exploration_tpu_torch.parallel import map_tree

        def one(a):
            lo, hi = self._rows(a.shape[0])
            return torch.as_tensor(a[lo:hi], device=self.device)

        return map_tree(one, tree)

    def shard_scenarios_from_local(self, tree):
        """A batched tree of THIS RANK's slice (leaves of the local scenario
        count, made by the rank itself) on the engine's device: the feeding
        path in which no rank materializes another's scenarios. Raises
        ``ValueError`` unless the leaves agree on the leading axis. Without a
        mesh the tree is returned as it is."""
        if self.mesh is None:
            return tree
        from ergodic_exploration_tpu_torch.parallel import map_tree

        counts = set()

        def one(a):
            counts.add(a.shape[0])
            return torch.as_tensor(a, device=self.device)

        out = map_tree(one, tree)
        if len(counts) > 1:
            raise ValueError(f"local leaves disagree on the scenario count: {sorted(counts)}")
        return out

    def _check_local(self, sc: "Scenarios", **trees) -> None:
        """Under a mesh, every leaf of the per-tick inputs must lead with this
        rank's scenario count, that of ``sc``."""
        if self.mesh is None:
            return
        from ergodic_exploration_tpu_torch.parallel import map_tree

        n = sc.x.shape[0]
        for name, tree in trees.items():
            def one(a, name=name):
                if a.shape[0] != n:
                    raise ValueError(
                        f"{name} leads with {a.shape[0]} scenarios where this rank holds {n}: "
                        "lay per-tick inputs out with engine.shard_scenarios(global_tree)")

            map_tree(one, tree)

    def _local_mask(self, free_mask, S: int):
        """A free mask of the global batch (S rows) or of this rank's slice,
        as this rank's rows."""
        lo, hi = self._rows(S)
        if free_mask is None or free_mask.shape[0] == hi - lo:
            return free_mask
        if free_mask.shape[0] != S:
            raise ValueError(f"free_mask has {free_mask.shape[0]} rows: need {S} (global) or "
                             f"{hi - lo} (this rank's)")
        return free_mask[lo:hi]

    # ------------------------------------------------------------------
    # construction helpers (global batch in, this rank's rows out)
    # ------------------------------------------------------------------

    def init_scenarios(self, x0, vb0=None, rng=None) -> Scenarios:
        """Batched initial state for poses ``x0`` (S, 3), the GLOBAL batch
        under a mesh (this rank's rows come back). ``rng`` is a key (2,) of
        uint32 words (default: the words of ``jax.random.PRNGKey(0)``); under
        ``shared_history_draw`` every scenario gets that key, else
        ``split(rng, S)`` over the global S, so that no draw depends on the
        mesh."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        S = x0.shape[0]
        vb0 = (torch.zeros((S, 3), dtype=torch.float32, device=self.device) if vb0 is None
               else torch.as_tensor(vb0, dtype=torch.float32, device=self.device))
        key = torch.zeros(2, dtype=torch.int64, device=self.device) if rng is None else \
            torch.as_tensor(rng, device=self.device).to(torch.int64)
        keys = key.expand(S, 2).clone() if self.config.shared_history_draw else prng.split(key, S)
        lo, hi = self._rows(S)
        return Scenarios(state=self.controller.init_state(keys[lo:hi]), x=x0[lo:hi],
                         vb=vb0[lo:hi])

    def prepare_world(self, grids: GridMap, domain: Optional[Domain] = None) -> World:
        """Batched world preprocessing (map cadence): EDT + gradient and the
        free-space phi mask per map; ``grids`` leaves lead with the global
        (S, ...) (this rank's rows are built). The domain is each map's
        extent unless ``domain`` is given."""
        return self._prepare_world(self._grids_here(self.shard_scenarios(grids)), domain)

    def _prepare_world(self, grids: GridMap, domain: Optional[Domain] = None) -> World:
        cfg = self.config
        S = grids.data.shape[0]
        if cfg.shared_maps and cfg.validate_shared:
            from ergodic_exploration_tpu_torch.utils.validation import check_rows_shared

            check_rows_shared(grids, "grids (cfg.shared_maps)", cache=self._validated)
        if domain is None:
            return self._world_batched(grids, grids.domain())
        domain = self._here(domain)
        return self._world_batched(grids, Domain(domain.origin.expand(S, 2).contiguous(),
                                                 domain.lengths.expand(S, 2).contiguous()))

    def _grids_here(self, grids: GridMap) -> GridMap:
        """``grids`` as float32 tensors on the engine's device (the same
        objects where they already are)."""
        return GridMap(*(torch.as_tensor(t, device=self.device).to(torch.float32)
                         for t in grids))

    def _world_batched(self, grids: GridMap, dom: Domain) -> World:
        cfg = self.config
        pts = dom.sample_lattice(cfg.grid_samples)  # (S, N, 2)
        free = (grids.occupancy_at(pts) < cfg.occupied_threshold).to(torch.float32)
        return World(domain=dom, dist=DistanceField.from_grid(grids, cfg.occupied_threshold),
                     free_mask=free)

    def empty_world(self, domain: Domain, n: int) -> World:
        """Obstacle-free batched world of ``n`` scenarios (global) over an
        unbatched ``domain``: this rank's rows of it."""
        lo, hi = self._rows(n)
        n = hi - lo
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
        if self._use_sample_sharding(domain):
            return self._phik_gmm_sharded_fn(gmm, domain, free_mask)
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
        """Batched target coefficients for GMM targets; gmm leaves lead with
        the global S (this rank's rows come back). ``free_mask`` may be
        (S, N), this rank's rows of it, or a batched :class:`World` (its
        ``free_mask`` is used). A mesh with a populated ``sample`` dim takes
        :meth:`phik_from_gmm_sample_sharded`."""
        gmm, free_mask = self._gmm_inputs(gmm, free_mask)
        return self._phik_from_gmm_fn(gmm, self._here(domain), free_mask)

    def _gmm_inputs(self, gmm, free_mask):
        """This rank's rows of a global GMM batch and of its free mask."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        S = gmm.means.shape[0]
        gmm = self._here(self.shard_scenarios(gmm))
        if free_mask is not None:
            free_mask = self._local_mask(torch.as_tensor(free_mask, device=self.device), S)
        return gmm, free_mask

    def _use_sample_sharding(self, domain: Domain) -> bool:
        return self._sample_ranks() > 1 and domain.origin.dim() == 1

    def _sample_ranks(self) -> int:
        """Ranks on the mesh's ``sample`` dim (1 without one)."""
        if self.mesh is None or self.SAMPLE_AXIS not in self.mesh.mesh_dim_names:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.SAMPLE_AXIS))

    def _sample_block(self, pts: torch.Tensor):
        """(lo, hi) of this rank's contiguous block of the lattice ``pts``
        (N, 2) on the ``sample`` dim, in the lattice's own order (the blocks
        of ``P("sample", None)`` in the JAX package)."""
        names = self.mesh.mesh_dim_names
        if self.SAMPLE_AXIS not in names:
            raise ValueError(f"the sample-sharded target needs a mesh with a "
                             f"{self.SAMPLE_AXIS!r} dim, got {names}")
        d = names.index(self.SAMPLE_AXIS)
        n, j = self.mesh.size(d), self.mesh.get_coordinate()[d]
        N = pts.shape[0]
        if N % n:
            raise ValueError(f"a lattice of {N} points does not split into {n} sample blocks")
        return j * (N // n), (j + 1) * (N // n)

    def _sample_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the mesh's ``sample`` group."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.mesh.get_group(self.SAMPLE_AXIS))
        return t

    def _phik_gmm_sharded_fn(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """phi_k (S, K, K) with the lattice split over the mesh's ``sample``
        dim: each rank evaluates the mixtures on its block of the lattice
        (clamped at 0, free-space masked), one ``all_reduce`` forms the
        per-scenario mass (and the mask's, for the fallback), the uniform
        fallback replaces a target with no mass, and a second ``all_reduce``
        adds the (S, K^2) partial contractions, taken in full float32. Plain
        PyTorch, as the JAX package computes it outside any Pallas kernel;
        needs a shared (unbatched) domain."""
        cfg = self.config
        K = cfg.num_basis
        pts = domain.sample_lattice(cfg.grid_samples)
        lo, hi = self._sample_block(pts)
        n_global = float(pts.shape[0])
        pts = pts[lo:hi]
        D = basis.dense_table(basis.tables(pts, K, domain), basis.hk_norm(K, domain.lengths))
        phi = torch.clamp(target_ops.gmm_eval(pts, gmm), min=0.0)  # (S, N_blk)
        if free_mask is None:
            total = self._sample_sum(phi.sum(dim=1))
            fallback = torch.full_like(phi, 1.0 / n_global)
        else:
            m = free_mask[:, lo:hi].to(phi.dtype)
            phi = phi * m
            sums = self._sample_sum(torch.stack([phi.sum(dim=1), m.sum(dim=1)], dim=1))
            total = sums[:, 0]
            fallback = m / torch.clamp(sums[:, 1], min=1.0)[:, None]
        phi = torch.where((total > 1e-12)[:, None],
                          phi / torch.clamp(total, min=1e-12)[:, None], fallback)
        ck = self._sample_sum(torch.matmul(phi, D))  # (S, K^2)
        return ck.view(-1, K, K)

    def phik_from_gmm_sample_sharded(self, gmm, domain: Domain, free_mask=None) -> torch.Tensor:
        """:meth:`phik_from_gmm` through the sample-sharded reduction
        (:meth:`_phik_gmm_sharded_fn`) on a mesh with a ``sample`` dim; the
        same inputs (global gmm; the mask global, local or a World)."""
        gmm, free_mask = self._gmm_inputs(gmm, free_mask)
        return self._phik_gmm_sharded_fn(gmm, self._here(domain), free_mask)

    # ------------------------------------------------------------------
    # the mutual-information target (BASELINE config 4)
    # ------------------------------------------------------------------

    def _phik_grid_one(self, grids: GridMap, sensor_radius_cells: int = 0) -> torch.Tensor:
        """MI target coefficients of grids with their own geometry each (the
        separable contraction of ops/target.py, batched over scenarios)."""
        cfg = self.config
        return target_ops.phik_from_grid_separable(
            grids, cfg.num_basis, cfg.grid_samples, sensor_radius_cells=sensor_radius_cells,
            frontier_cells=cfg.mi_frontier_cells, occupied_threshold=cfg.occupied_threshold)

    def _phik_grid_batch_dense_fn(self, grids: GridMap, domain: Domain,
                                  sensor_radius_cells: int) -> torch.Tensor:
        """Batched MI target coefficients on a SHARED (unbatched) domain and
        shared grid geometry: per-scenario entropy map -> lattice resample
        with the sensor-footprint blur folded into the sampling matrices
        (the box blur is linear, so blur-then-sample is one small-integer
        count matrix per axis and the (2r+1)^2 scale cancels in the
        normalization) -> one (S, N) @ (N, K^2) contraction. The free mask
        and the frontier count are sampled the same way and applied at the
        lattice: nearest-cell sampling commutes with elementwise products and
        monotone thresholds. Float32 matmuls with TF32 off throughout."""
        cfg = self.config
        K, r, fc = cfg.num_basis, sensor_radius_cells, cfg.mi_frontier_cells
        nsx, nsy = cfg.grid_samples
        pts = domain.sample_lattice(cfg.grid_samples)
        hk = basis.hk_norm(K, domain.lengths)
        D = basis.dense_table(basis.tables(pts, K, domain), hk)
        h, w = grids.shape
        dev = grids.data.device
        g0 = GridMap(grids.data[0], grids.origin[0], grids.resolution[0])
        Ax, Ay = target_ops.sampling_one_hots(g0, cfg.grid_samples, domain)
        Axb = torch.matmul(Ax, target_ops.blur_count_matrix(w, r, device=dev))  # (nsx, w)
        Ayb = torch.matmul(Ay, target_ops.blur_count_matrix(h, r, device=dev))  # (nsy, h)

        def sampled(field, Mx, My):
            """(S, h, w) cell field -> (S, nsx, nsy): Mx field^T My^T."""
            t1 = torch.matmul(field, Mx.T)  # (S, h, nsx)
            return torch.matmul(t1.transpose(1, 2), My.T)

        occupied = grids.occupied(cfg.occupied_threshold)
        vals = sampled(target_ops.entropy(grids.prob()), Axb, Ayb)
        zs = sampled((~occupied).to(torch.float32), Ax, Ay)
        if fc > 0:
            kf = ((grids.data >= 0.0) & ~occupied).to(torch.float32)
            Axf = torch.matmul(Ax, target_ops.blur_count_matrix(w, fc, device=dev))
            Ayf = torch.matmul(Ay, target_ops.blur_count_matrix(h, fc, device=dev))
            zs = zs * (sampled(kf, Axf, Ayf) > 0.5).to(zs.dtype)
        vals = torch.clamp((vals * zs).reshape(-1, nsx * nsy), min=0.0)  # (S, N)
        ck_raw = basis.coefficients_dense(vals, D, K)
        total = (ck_raw[:, 0, 0] * hk[0, 0])[:, None, None]  # scaled sum: the scale cancels
        fallback = (D.sum(dim=0) / float(pts.shape[0])).view(K, K)
        return torch.where(total > 1e-12, ck_raw / torch.clamp(total, min=1e-12), fallback)

    def _phik_grid_kernel(self, grids: GridMap, domain: Domain,
                          sensor_radius_cells: int) -> torch.Tensor:
        """MI target coefficients through K3 (ops/mi_kernel.py). Its operands
        depend on the geometry alone and are built once per (grids' origin and
        resolution tensors, domain tensors, map shape)."""
        from ergodic_exploration_tpu_torch.ops.mi_kernel import mi_operands, phik_from_grid

        cfg = self.config
        held = (grids.origin, grids.resolution, domain.origin, domain.lengths)
        key = (tuple((t.data_ptr(), t._version) for t in held), grids.shape)
        hit = self._mi_operands.get(key)
        if hit is None:
            if len(self._mi_operands) >= 16:
                self._mi_operands.clear()
            g0 = GridMap(grids.data[0], grids.origin[0], grids.resolution[0])
            # the tensors are kept with the entry, so their storage is not
            # handed to other tensors while the key is in use
            hit = (held, mi_operands(g0, domain, cfg.num_basis, cfg.grid_samples))
            self._mi_operands[key] = hit
        return phik_from_grid(grids.data.contiguous(), hit[1], sensor_radius_cells,
                              cfg.mi_frontier_cells, cfg.occupied_threshold)

    def _phik_grid_sharded_fn(self, grids: GridMap, sensor_radius_cells: int = 0) -> torch.Tensor:
        """The MI twin of :meth:`_phik_gmm_sharded_fn`: each rank builds the
        full information map of its scenarios (map-space work does not split
        along samples), samples it on its own block of the lattice (scenario
        0's domain: the grids share one geometry), and the two ``all_reduce``
        combine the blocks."""
        cfg = self.config
        K = cfg.num_basis
        dom = Domain(grids.origin[0], grids.domain().lengths[0])
        pts = dom.sample_lattice(cfg.grid_samples)
        lo, hi = self._sample_block(pts)
        n_global = float(pts.shape[0])
        pts = pts[lo:hi]
        D = basis.dense_table(basis.tables(pts, K, dom), basis.hk_norm(K, dom.lengths))
        info = target_ops.mutual_information_map(grids, sensor_radius_cells,
                                                 cfg.mi_frontier_cells, cfg.occupied_threshold)
        vals = torch.clamp(target_ops.sample_map_at(info, grids, pts), min=0.0)  # (S, N_blk)
        total = self._sample_sum(vals.sum(dim=1))
        phi = torch.where((total > 1e-12)[:, None], vals / torch.clamp(total, min=1e-12)[:, None],
                          torch.full_like(vals, 1.0 / n_global))
        ck = self._sample_sum(torch.matmul(phi, D))
        return ck.view(-1, K, K)

    def phik_from_grid(self, grids: GridMap, sensor_radius_cells: int = 0,
                       domain: Optional[Domain] = None) -> torch.Tensor:
        """Batched mutual-information target coefficients (S, K, K)
        recomputed from the (evolving) occupancy grids, whose leaves lead
        with the global S (this rank's rows come back). A mesh with a
        populated ``sample`` dim takes the sample-sharded reduction. Else,
        pass the unbatched shared exploration ``domain`` when all grids share
        it and one geometry: the dense path then runs; without it, the
        per-scenario separable path."""
        return self._phik_grid(self._grids_here(self.shard_scenarios(grids)),
                               sensor_radius_cells, domain)

    def _phik_grid(self, grids: GridMap, sensor_radius_cells: int,
                   domain: Optional[Domain]) -> torch.Tensor:
        if self._sample_ranks() > 1:
            self._check_shared_grids(grids)  # the lattice of scenario 0's domain
            return self._phik_grid_sharded_fn(grids, sensor_radius_cells)
        if domain is not None and domain.origin.dim() == 1:
            self._check_shared_grids(grids)  # dense path: scenario-0 geometry
            return self._phik_grid_batch_dense_fn(grids, self._here(domain),
                                                  sensor_radius_cells)
        return self._phik_grid_one(grids, sensor_radius_cells)

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
        self._check_local(sc, phik=phik, world=world)
        self._check_shared_world(world)
        return self._replan_fn(sc, phik, world)

    def _refresh_and_replan_fn(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """GMM target refresh + batched solve: the full per-tick work. With
        the fused solve + shared maps on a shared domain the refresh runs
        inside K1 — the whole tick is one kernel launch, also on a scenario
        mesh (this rank's slice; reads of row 0 see the local row 0, the same
        map by the shared contracts). A populated ``sample`` dim keeps the
        sample-sharded refresh ahead of the solve."""
        cfg = self.config
        if (cfg.use_fused_solve and cfg.shared_maps and domain.origin.dim() == 1
                and not self._use_sample_sharding(domain)):
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            state, u, diag = replan_batched_fused(cfg, self.model, sc.state, sc.x, sc.vb,
                                                  None, world, gmm=gmm, domain=domain)
            return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag
        phik = self._phik_from_gmm_fn(gmm, domain, world.free_mask)
        return self._replan_fn(sc, phik, world)

    def replan_refresh(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """One batched tick including the per-tick GMM target refresh (the
        tick ``bench.py`` times in the JAX package). Under a mesh ``gmm`` is
        this rank's rows (``shard_scenarios``)."""
        self._check_local(sc, gmm=gmm, world=world)
        self._check_shared_world(world)
        return self._refresh_and_replan_fn(sc, self._here(gmm), self._here(domain), world)

    def _refresh_mi_and_replan_fn(self, sc: Scenarios, grids: GridMap, world: World,
                                  sensor_radius_cells: int, domain: Optional[Domain] = None,
                                  use_mi_kernel: bool = False):
        """MI target refresh from the evolving occupancy grids + batched
        solve: config 4's full per-tick work. A mesh with a populated
        ``sample`` dim takes the sample-sharded reduction; else, on a shared
        ``domain``, the refresh is K3 (one launch from the (S, h, w) beliefs)
        when ``use_mi_kernel`` is set, else the dense path; without a shared
        domain, the per-scenario separable contraction."""
        shared = domain is not None and domain.origin.dim() == 1
        if self._sample_ranks() > 1:
            phik = self._phik_grid_sharded_fn(grids, sensor_radius_cells)
        elif use_mi_kernel and shared:
            phik = self._phik_grid_kernel(grids, domain, sensor_radius_cells)
        elif shared:
            phik = self._phik_grid_batch_dense_fn(grids, domain, sensor_radius_cells)
        else:
            phik = self._phik_grid_one(grids, sensor_radius_cells)
        return self._replan_fn(sc, phik, world)

    def replan_refresh_mi(self, sc: Scenarios, grids: GridMap, world: World,
                          sensor_radius_cells: int = 0, domain: Optional[Domain] = None,
                          use_mi_kernel: bool = False):
        """One batched tick including the per-tick MUTUAL-INFORMATION target
        refresh (config 4's hot path). ``world`` carries the distance field
        built from the same beliefs at map cadence. Pass the shared ``domain``
        when all grids span it; ``use_mi_kernel`` then selects K3. Under a
        mesh ``grids`` is this rank's rows (``shard_scenarios``)."""
        self._check_local(sc, grids=grids, world=world)
        self._check_shared_world(world)
        grids = self._grids_here(grids)
        if domain is not None:
            domain = self._here(domain)
            if domain.origin.dim() == 1:
                self._check_shared_grids(grids)  # scenario-0 geometry
        return self._refresh_mi_and_replan_fn(sc, grids, world, sensor_radius_cells, domain,
                                              use_mi_kernel)

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
        self._check_local(sc, phik=phik, world=world)
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

    def explore_mapping(self, sc: Scenarios, truth: GridMap, n_ticks: int,
                        sensor_range: float = 1.5, refresh_every: int = 10,
                        belief: Optional[GridMap] = None, sensor_model: str = "raycast"):
        """Closed-loop exploration WITH online mapping (config 4 end to end):
        per-scenario beliefs start unknown, a range sensor reveals the hidden
        ground-truth maps as the robots move, and the MI target and the
        distance field are recomputed from the evolving beliefs every
        ``refresh_every`` ticks.

        ``sensor_model``: "raycast" (occlusion-aware: cells behind walls stay
        unknown) or "disc" (sees through walls).

        Returns (ExploreOutput of the final chunk, belief GridMap, coverage
        (n_refreshes,) fraction-known history). Under a mesh ``truth`` (and
        ``belief``) are this rank's rows, and so is the coverage.
        """
        from ergodic_exploration_tpu_torch.ops import sensor

        self._check_local(sc, truth=truth, belief=belief)
        truth = self._grids_here(truth)
        if belief is None:
            belief = truth._replace(data=torch.full_like(truth.data, -1.0))
        if sensor_model == "raycast":
            win = sensor.raycast_window_cells(sensor_range, float(truth.resolution.min()))

            def reveal_b(b, t, x):
                return sensor.reveal_raycast(b, t, x, sensor_range, win,
                                             occupied_threshold=self.config.occupied_threshold)
        elif sensor_model == "disc":
            def reveal_b(b, t, x):
                return sensor.reveal(b, t, x, sensor_range)
        else:
            raise ValueError(f"unknown sensor_model {sensor_model!r}")
        coverage = []
        out = None
        for _ in range(max(1, n_ticks // refresh_every)):
            belief = reveal_b(belief, truth, sc.x)
            phik = self._phik_grid(belief, 0, None)
            world = self._prepare_world(belief)
            out = self.explore(sc, phik, world, refresh_every)
            sc = out.scenarios
            coverage.append(sensor.fraction_known(belief))
        return out, belief, torch.stack(coverage)

    def explore_mapping_fused(self, sc: Scenarios, truth: GridMap, n_refreshes: int,
                              refresh_every: int = 10, sensor_range: float = 1.5,
                              sensor_radius_cells: int = 0):
        """:meth:`explore_mapping` with the ray-cast sensor and the dense MI
        refresh, for identically-shaped grids sharing one domain: each
        refresh = occlusion-aware reveal -> MI target (dense path) -> EDT
        world rebuild -> ``refresh_every`` ticks of :meth:`explore`. The JAX
        package runs it as one ``lax.scan``; here it is a Python loop that
        never waits for the device (the coverage stays on it).

        Returns (Scenarios, belief GridMap, coverage (n_refreshes,),
        trajectory (n_refreshes, refresh_every, S, 3), ergodic metric
        (n_refreshes, refresh_every, S): the per-tick metric against each
        refresh's CURRENT target). Under a mesh ``truth`` is this rank's rows.
        """
        from ergodic_exploration_tpu_torch.ops import sensor

        self._check_local(sc, truth=truth)
        truth = self._grids_here(truth)
        win = sensor.raycast_window_cells(sensor_range, float(truth.resolution.min()))
        dom = Domain(origin=truth.origin[0], lengths=truth.domain().lengths[0])
        belief = truth._replace(data=torch.full_like(truth.data, -1.0))
        coverage, traj, metric = [], [], []
        for _ in range(n_refreshes):
            belief = sensor.reveal_raycast(belief, truth, sc.x, sensor_range, win,
                                           occupied_threshold=self.config.occupied_threshold)
            phik = self._phik_grid_batch_dense_fn(belief, dom, sensor_radius_cells)
            world = self._world_batched(belief, belief.domain())
            out = self.explore(sc, phik, world, refresh_every)
            sc = out.scenarios
            coverage.append(sensor.fraction_known(belief))
            traj.append(out.trajectory)
            metric.append(out.ergodic_metric)
        return sc, belief, torch.stack(coverage), torch.stack(traj), torch.stack(metric)

    # ------------------------------------------------------------------
    # startup
    # ------------------------------------------------------------------

    def warmup(self, S: int, domain: Domain, map_shape=None, gmm_components: int = 1,
               n_ticks=(), persistent_cache=None) -> dict:
        """Pay the startup costs before the first real tick: on a CUDA device
        build (or load) every kernel library, then run each entry point once
        on dummy data of ``S`` scenarios: ``init_scenarios``, ``prepare_world``
        with ``phik_from_grid`` and ``replan_refresh_mi`` (when ``map_shape``
        is given, else an empty world), ``phik_from_gmm``, ``replan``,
        ``replan_refresh`` and ``explore`` for each length in ``n_ticks``.
        ``S`` is the global count: under a mesh each rank warms its rows.
        ``persistent_cache`` (True for the default ``build/kernels/``, or a
        directory) is where the kernel libraries are built and loaded from
        then on (``utils.cuda_build.set_build_dir``); a library built there
        survives the process, as the JAX package's compile cache does. On the
        CPU it changes nothing. Returns {stage: seconds}.
        """
        timings = {}
        if persistent_cache and self.device.type == "cuda":
            from ergodic_exploration_tpu_torch.utils.cuda_build import set_build_dir

            set_build_dir(None if persistent_cache is True else persistent_cache)

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
            timed("phik_from_grid", lambda: self.phik_from_grid(grids))
            timed("replan_refresh_mi", lambda: self.replan_refresh_mi(
                sc, self.shard_scenarios(grids), world, domain=domain))
        else:
            world = self.empty_world(domain, S)
        phik = timed("phik_from_gmm", lambda: self.phik_from_gmm(gmm, domain, world.free_mask))
        timed("replan", lambda: self.replan(sc, phik, world))
        timed("replan_refresh", lambda: self.replan_refresh(sc, self.shard_scenarios(gmm),
                                                            domain, world))
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
        them. Under a mesh the call is collective: every rank calls it with
        its rows, the state is gathered over the ``scenario`` group
        (``parallel.process_allgather``), world rank 0 writes the global
        batch, and no rank returns before the file is whole."""
        from ergodic_exploration_tpu_torch.utils.checkpoint import save_pytree
        from ergodic_exploration_tpu_torch.utils.interop import to_numpy

        if self.mesh is not None:
            from ergodic_exploration_tpu_torch.parallel import process_allgather

            sc = process_allgather(sc, self.mesh)
        tree = to_numpy(sc)
        state = tree.state._replace(rng=tree.state.rng.astype(np.uint32))
        save_pytree(path, tree._replace(state=state), collective=self.mesh is not None)

    def load_checkpoint(self, path: str) -> Scenarios:
        """Restore :class:`Scenarios` saved by :meth:`save_checkpoint` (of
        this package or of the JAX package) onto this engine's device; under
        a mesh every rank reads the file and keeps its rows (the mesh may
        differ from the run that wrote it)."""
        from ergodic_exploration_tpu_torch.utils.checkpoint import load_pytree

        with np.load(path) as data:
            # every Scenarios leaf has the scenario count as its leading axis
            leaf_keys = sorted(k for k in data.files if k.startswith("leaf_"))
            S = data[leaf_keys[0]].shape[0]
        keys = torch.zeros((S, 2), dtype=torch.int64, device=self.device)
        zeros = torch.zeros((S, 3), dtype=torch.float32, device=self.device)
        like = Scenarios(state=self.controller.init_state(keys), x=zeros, vb=zeros)
        return self.shard_scenarios(load_pytree(path, like))


def _mesh(shape, names, devices):
    """A DeviceMesh of ``shape`` over the ranks of the process group, rank r
    at row-major position r."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call parallel.initialize_multihost() first")
    need, have = int(np.prod(shape)), dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    if have > need:
        raise ValueError(f"need {need} devices, have {have}: a rank outside the mesh would "
                         "hold no scenarios; start as many ranks as the mesh has devices")
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    if device_type == "cuda":
        resolve_device("cuda")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=names)


def make_scenario_mesh(n_devices: Optional[int] = None, devices: Optional[str] = None):
    """1-D ``("scenario",)`` mesh over the ranks of the process group (one
    process a device). ``n_devices``: the ranks of the mesh (None: the
    world). ``devices``: the device type the mesh lives on, ``"cuda"`` or
    ``"cpu"`` (None: the group's, ``"cuda"`` under NCCL and ``"cpu"`` under
    gloo; gloo on the card passes ``"cuda"``).

    Raises ``ValueError`` when the world is smaller than the mesh, as the JAX
    package does, and also when it is larger: a rank is a process here, and a
    process outside the mesh would hold no scenarios."""
    import torch.distributed as dist

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n_devices,), (Engine.SCENARIO_AXIS,), devices)


def make_mesh(n_scenario: int, n_sample: int = 1, devices: Optional[str] = None):
    """2-D ``("scenario", "sample")`` mesh: scenario-parallel solves with the
    grid-sample reduction split over ``n_sample`` ranks each. Rank r holds
    scenario coordinate ``r // n_sample`` and sample coordinate
    ``r % n_sample``. ``devices`` and the refusals as for
    :func:`make_scenario_mesh`."""
    return _mesh((n_scenario, n_sample), (Engine.SCENARIO_AXIS, Engine.SAMPLE_AXIS), devices)
