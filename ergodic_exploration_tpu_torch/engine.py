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
first. A tick is, with ``use_fused_solve``, one launch of K1
(ops/solve_kernel.py) between the tick's two glue kernels (ops/tick_glue.py:
the RNG split, the history draw and the orbit guard ahead of it; the DWA
select, the guards, the ring append and, in the closed loops, the pose
advance after it), otherwise the batched controller step between the same
two glue kernels, whose safety stage is the ``fused_safety`` kernel;
``phik_from_gmm`` with ``use_pallas`` goes through K2 (ops/gmm_kernel.py).
On the card every entry point runs as one compiled program, as the JAX
package's ``jax.jit`` runs it: the single-tick entry points (``replan``,
``replan_refresh``, ``replan_refresh_mi``) each replay a CUDA graph of one
tick (:meth:`Engine._graph_tick`), ``explore`` replays graphs of 10 ticks
(and of 1 tick for the rest), and ``explore_mapping_fused`` one graph per
map refresh (utils/graphs.py), each captured once per shape. A graph
appends each tick's pose into its static state's ring in place, the twin of
the JAX engine's donated state; the eager functions write a new ring and
change none of their inputs. The eager functions are their plain versions, which the CPU runs and which can be
called by name on the card: ``_replan_fn``, ``_refresh_and_replan_fn``,
``_refresh_mi_and_replan_fn``, ``_explore_loop`` and
``_explore_mapping_fused_loop``. A tick with collectives (``replan_refresh``
and ``replan_refresh_mi`` on a mesh with a populated ``sample`` dim, whose
two ``all_reduce`` a graph cannot hold under gloo) runs eagerly; the choice
is made by the mesh's shape, never by a failed capture.
The mutual-information target is recomputed from the belief maps by
``phik_from_grid`` (dense on a shared domain: M, ops/mi_dense_kernel.py;
separable otherwise) and, in ``replan_refresh_mi(..., domain=<shared>,
use_mi_kernel=True)``, by K3 (ops/mi_kernel.py; without it, M);
``explore_mapping`` and ``explore_mapping_fused`` close the loop with the
range sensor of ops/sensor.py.

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
from ergodic_exploration_tpu_torch.utils import graphs, prng
from ergodic_exploration_tpu_torch.utils.device import resolve_device
from ergodic_exploration_tpu_torch.utils.profiling import COUNTS, spanned

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
    GRAPH_BLOCK = 10  # ticks one captured explore graph holds

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
        self._dense_operands = {}  # geometry key -> (tensors of the key, DenseOperands)
        self._lattices = {}  # refresh geometry key -> (tensors of the key, Lattice)
        self._graphs = graphs.GraphCache()  # the closed loops' static buffers and graphs
        self._tick_graphs = graphs.GraphCache()  # the single-tick entry points'

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
        """The world of each map over its domain (the JAX ``_world_one``,
        vmapped): on the card one launch of the EDT kernel with the free
        mask, on the CPU its plain composition (``ops/edt_kernel.py``)."""
        from ergodic_exploration_tpu_torch.ops.edt_kernel import world_fields

        cfg = self.config
        dist, grad, free = world_fields(grids, dom, cfg.occupied_threshold, cfg.grid_samples)
        return World(domain=dom, dist=DistanceField(dist, grad, grids.origin, grids.resolution),
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
                                  sensor_radius_cells: int, ops=None) -> torch.Tensor:
        """Batched MI target coefficients on a SHARED (unbatched) domain and
        shared grid geometry (scenario 0's): the entropy of every belief
        sampled at the lattice with the sensor-footprint box sum, the free
        and frontier masks, one (S, N) @ (N, K^2) contraction. M
        (ops/mi_dense_kernel.py) for CUDA tensors; its plain version, the
        JAX function's body, for CPU tensors. ``ops`` are its
        operands (:meth:`_dense_ops` of the geometry when None)."""
        from ergodic_exploration_tpu_torch.ops.mi_dense_kernel import phik_dense

        cfg = self.config
        ops = self._dense_ops(grids, domain) if ops is None else ops
        return phik_dense(grids.data, ops, sensor_radius_cells, cfg.mi_frontier_cells,
                          cfg.occupied_threshold)

    def _geometry_ops(self, cache: dict, grids: GridMap, domain: Optional[Domain], build):
        """``build(g0, domain, K, grid_samples)`` for the geometry of
        ``grids`` on ``domain`` (g0: scenario 0's map; ``domain`` None: the
        extent of scenario 0's map): operands that depend on it alone, built
        once per (grids' origin and resolution tensors, domain tensors, their
        ``_version``, map shape) and kept in ``cache``. Reads the host (the
        cache's key, the build), so a graph's tick takes them as an input."""
        held = (grids.origin, grids.resolution) + (
            () if domain is None else (domain.origin, domain.lengths))
        key = (tuple((t.data_ptr(), t._version) for t in held), grids.shape)
        hit = cache.get(key)
        if hit is None:
            COUNTS["operand_builds"] += 1
            if len(cache) >= 16:
                cache.clear()
            if domain is None:
                domain = Domain(origin=grids.origin[0], lengths=grids.domain().lengths[0])
            g0 = GridMap(grids.data[0], grids.origin[0], grids.resolution[0])
            # the tensors are kept with the entry, so their storage is not
            # handed to other tensors while the key is in use
            hit = cache[key] = (held, build(g0, domain, self.config.num_basis,
                                            self.config.grid_samples))
        return hit[1]

    def _mi_ops(self, grids: GridMap, domain: Domain):
        """K3's operands (ops/mi_kernel.py::MiOperands) for the geometry of
        ``grids`` on ``domain`` (:meth:`_geometry_ops`)."""
        from ergodic_exploration_tpu_torch.ops.mi_kernel import mi_operands

        return self._geometry_ops(self._mi_operands, grids, domain, mi_operands)

    def _dense_ops(self, grids: GridMap, domain: Optional[Domain]):
        """M's operands (ops/mi_dense_kernel.py::DenseOperands: the lattice
        cells, the dense table D, the fallback, hk[0, 0]) for the geometry of
        ``grids`` on ``domain``, None for scenario 0's map extent
        (:meth:`_geometry_ops`)."""
        from ergodic_exploration_tpu_torch.ops.mi_dense_kernel import dense_operands

        return self._geometry_ops(self._dense_operands, grids, domain, dense_operands)

    def _phik_grid_kernel(self, grids: GridMap, domain: Domain, sensor_radius_cells: int,
                          ops=None) -> torch.Tensor:
        """MI target coefficients through K3 (ops/mi_kernel.py) on the
        operands ``ops`` (:meth:`_mi_ops` of the geometry when None)."""
        from ergodic_exploration_tpu_torch.ops.mi_kernel import phik_from_grid

        cfg = self.config
        ops = self._mi_ops(grids, domain) if ops is None else ops
        return phik_from_grid(grids.data.contiguous(), ops, sensor_radius_cells,
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

    def _replan_batched(self, state, x, vb, phik, world, advance: bool = False,
                        ring_in_place: bool = False):
        """One tick: (state, u, diag), and with ``advance`` also the poses
        one dt on through the true kinematics and their twists. With
        ``ring_in_place`` (the graph bodies, whose state is a static buffer
        the graph advances) the ring append writes into ``state``'s ring."""
        if self.config.use_fused_solve:
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            return replan_batched_fused(self.config, self.model, state, x, vb, phik, world,
                                        advance=advance, ring_in_place=ring_in_place)
        return self.controller.step(state, x, vb, phik, world, advance=advance,
                                    ring_in_place=ring_in_place)

    def _replan_fn(self, sc: Scenarios, phik, world: World, ring_in_place: bool = False):
        state, u, diag = self._replan_batched(sc.state, sc.x, sc.vb, phik, world,
                                              ring_in_place=ring_in_place)
        return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag

    @spanned("ee.replan")
    def replan(self, sc: Scenarios, phik, world: World):
        """One batched replan tick: (S,) solves -> (S, nu) controls. Does not
        advance the poses (the caller owns the plant). On the card a replay
        of the 1-tick graph of :meth:`_replan_fn` (:meth:`_graph_tick`)."""
        self._check_local(sc, phik=phik, world=world)
        self._check_shared_world(world)
        if self._on_graphs():
            return self._graph_tick("replan", self._replan_fn, (sc, phik, world), ())
        return self._replan_fn(sc, phik, world)

    def _refresh_in_kernel(self, domain: Domain) -> bool:
        """Whether the GMM refresh of a tick on ``domain`` runs inside K1."""
        cfg = self.config
        return (cfg.use_fused_solve and cfg.shared_maps and domain.origin.dim() == 1
                and not self._use_sample_sharding(domain))

    def _lattice_ops(self, domain: Domain, free_mask):
        """The in-kernel refresh's lattice operands
        (ops/solve_kernel.py::Lattice) for ``domain`` and ``free_mask``: they
        depend on those (and the configuration) alone and are built once per
        (their tensors and ``_version``). Reads the host (the cache's key, the
        build), so a graph's tick takes them as an input."""
        from ergodic_exploration_tpu_torch.ops.solve_kernel import lattice_operands

        held = (domain.origin, domain.lengths) + ((free_mask,) if free_mask is not None else ())
        key = tuple((t.data_ptr(), t._version) for t in held)
        hit = self._lattices.get(key)
        if hit is None:
            COUNTS["operand_builds"] += 1
            if len(self._lattices) >= 16:
                self._lattices.clear()
            # the tensors are kept with the entry, so their storage is not
            # handed to other tensors while the key is in use
            hit = self._lattices[key] = (held, lattice_operands(self.config, domain, free_mask))
        return hit[1]

    def _refresh_and_replan_fn(self, sc: Scenarios, gmm, domain: Domain, world: World,
                               lattice=None, ring_in_place: bool = False):
        """GMM target refresh + batched solve: the full per-tick work. With
        the fused solve + shared maps on a shared domain the refresh runs
        inside K1 on the ``lattice`` operands (:meth:`_lattice_ops` when
        None), between the tick's two glue kernels, also on a scenario mesh
        (this rank's slice; reads of row 0 see the local row 0, the same map
        by the shared contracts). A populated ``sample`` dim keeps the
        sample-sharded refresh ahead of the solve."""
        cfg = self.config
        if self._refresh_in_kernel(domain):
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            if lattice is None:
                lattice = self._lattice_ops(domain, world.free_mask)
            state, u, diag = replan_batched_fused(cfg, self.model, sc.state, sc.x, sc.vb,
                                                  None, world, gmm=gmm, domain=domain,
                                                  lattice=lattice, ring_in_place=ring_in_place)
            return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag
        phik = self._phik_from_gmm_fn(gmm, domain, world.free_mask)
        return self._replan_fn(sc, phik, world, ring_in_place)

    @spanned("ee.replan_refresh")
    def replan_refresh(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """One batched tick including the per-tick GMM target refresh (the
        tick ``bench.py`` times in the JAX package). Under a mesh ``gmm`` is
        this rank's rows (``shard_scenarios``). On the card a replay of the
        1-tick graph of :meth:`_refresh_and_replan_fn`, except on a populated
        ``sample`` dim (module docstring); the in-kernel refresh's lattice
        operands are built outside the graph (:meth:`_lattice_ops`) and
        copied in."""
        self._check_local(sc, gmm=gmm, world=world)
        self._check_shared_world(world)
        ins = (sc, self._here(gmm), self._here(domain), world)
        if self._on_graphs(collective=True):
            domain = ins[2]
            lattice = (self._lattice_ops(domain, world.free_mask)
                       if self._refresh_in_kernel(domain) else None)
            return self._graph_tick("replan_refresh", self._refresh_and_replan_fn,
                                    ins + (lattice,), ())
        return self._refresh_and_replan_fn(*ins)

    def _refresh_mi_and_replan_fn(self, sc: Scenarios, grids: GridMap, world: World,
                                  sensor_radius_cells: int, domain: Optional[Domain] = None,
                                  use_mi_kernel: bool = False, mi_ops=None,
                                  ring_in_place: bool = False):
        """MI target refresh from the evolving occupancy grids + batched
        solve: config 4's full per-tick work. A mesh with a populated
        ``sample`` dim takes the sample-sharded reduction; else, on a shared
        ``domain``, the refresh is K3 (one launch from the (S, h, w) beliefs,
        on the operands ``mi_ops``, :meth:`_mi_ops` when None) when
        ``use_mi_kernel`` is set, else the dense path (M, on the operands
        ``mi_ops``, :meth:`_dense_ops` when None); without a shared domain,
        the per-scenario separable contraction."""
        shared = domain is not None and domain.origin.dim() == 1
        if self._sample_ranks() > 1:
            phik = self._phik_grid_sharded_fn(grids, sensor_radius_cells)
        elif use_mi_kernel and shared:
            phik = self._phik_grid_kernel(grids, domain, sensor_radius_cells, mi_ops)
        elif shared:
            phik = self._phik_grid_batch_dense_fn(grids, domain, sensor_radius_cells, mi_ops)
        else:
            phik = self._phik_grid_one(grids, sensor_radius_cells)
        return self._replan_fn(sc, phik, world, ring_in_place)

    @spanned("ee.replan_refresh_mi")
    def replan_refresh_mi(self, sc: Scenarios, grids: GridMap, world: World,
                          sensor_radius_cells: int = 0, domain: Optional[Domain] = None,
                          use_mi_kernel: bool = False):
        """One batched tick including the per-tick MUTUAL-INFORMATION target
        refresh (config 4's hot path). ``world`` carries the distance field
        built from the same beliefs at map cadence. Pass the shared ``domain``
        when all grids span it; ``use_mi_kernel`` then selects K3. Under a
        mesh ``grids`` is this rank's rows (``shard_scenarios``). On the card a
        replay of the 1-tick graph of :meth:`_refresh_mi_and_replan_fn`, one
        graph per (``sensor_radius_cells``, shared domain or not,
        ``use_mi_kernel``), except on a populated ``sample`` dim (module
        docstring); K3's or M's operands are built outside the graph and copied
        in."""
        self._check_local(sc, grids=grids, world=world)
        self._check_shared_world(world)
        grids = self._grids_here(grids)
        shared = False
        if domain is not None:
            domain = self._here(domain)
            shared = domain.origin.dim() == 1
            if shared:
                self._check_shared_grids(grids)  # scenario-0 geometry
        if not self._on_graphs(collective=True):
            return self._refresh_mi_and_replan_fn(sc, grids, world, sensor_radius_cells, domain,
                                                  use_mi_kernel)
        r = sensor_radius_cells
        ops = None
        if shared:
            ops = self._mi_ops(grids, domain) if use_mi_kernel else self._dense_ops(grids, domain)

        def body(sc_, grids_, world_, domain_, ops_, ring_in_place=False):
            return self._refresh_mi_and_replan_fn(sc_, grids_, world_, r, domain_,
                                                  use_mi_kernel, ops_, ring_in_place)

        return self._graph_tick("replan_refresh_mi", body, (sc, grids, world, domain, ops),
                                (r, shared, use_mi_kernel))

    # ------------------------------------------------------------------
    # the single-tick entry points as graphs
    # ------------------------------------------------------------------

    def _on_graphs(self, collective: bool = False) -> bool:
        """Whether an entry point replays graphs: on the card, unless it is
        a ``collective`` tick (a refresh, whose target a populated
        ``sample`` dim combines with two ``all_reduce``) on such a mesh."""
        return self.device.type == "cuda" and not (collective and self._sample_ranks() > 1)

    def _graph_tick(self, name: str, body, ins: tuple, static: tuple):
        """One tick of the entry point ``name`` as a replay of its 1-tick
        graph, the twin of the JAX package's ``jax.jit(..., donate=(0,))``:
        ``body(*ins, ring_in_place=True)``, the eager function (``ins[0]``
        the Scenarios; it returns (Scenarios, u, diag)) with the ring
        appended in place in the static state, captured over static copies
        of ``ins``, keyed on (``name``, the configuration, the signature of
        ``ins``, ``static``: the entry's arguments that are not tensors) in
        a cache of its own (``self._tick_graphs``), so that it never evicts
        the closed loops' graphs. A call copies in the leaves that changed
        (``graphs.Static.load``), replays, and copies the new state, u and
        diagnostics out, so that nothing a call returns is changed by a
        later call; the poses and twists it returns are the caller's own, as
        the eager function returns them. The state copied out is recorded as
        what the static state holds, so a chain of ticks copies no state in.
        The graph is made by :meth:`_make_graph` (a test substitutes it)."""
        entry = self._tick_graphs.entry((name, self.config, static), ins)
        entry.load(ins)
        st = entry.buffers
        st_state = st[0].state
        entry.holds(st_state)  # written below

        def fn():
            out_sc, u, diag = body(*st, ring_in_place=True)
            graphs.copy_into(st_state, out_sc.state)  # the ring is already there
            return u, diag

        u, diag = entry.run(1, fn, self._make_graph)
        state, u, diag = entry.clone_out("tick", (st_state, u, diag))
        entry.holds(st_state, state)
        sc = ins[0]
        return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag

    # ------------------------------------------------------------------
    # the closed loop
    # ------------------------------------------------------------------

    def _tick_batched(self, state, x, vb, phik, world, ring_in_place: bool = False):
        """One replan + one dt of real motion through the true kinematics
        (the tick's ``glue_post`` advances the poses: ``advance``)."""
        state, u, diag, x_next, vb_next = self._replan_batched(
            state, x, vb, phik, world, advance=True, ring_in_place=ring_in_place)
        return state, x_next, vb_next, u, diag

    def _outputs(self, n: int, x: torch.Tensor):
        """Empty (n, S, 3) trajectory, (n, S, nu) controls and
        StepDiagnostics of (n, S) leaves on the device of the poses ``x``."""
        S, kw = x.shape[0], dict(device=x.device)
        return (torch.empty((n, S, 3), dtype=torch.float32, **kw),
                torch.empty((n, S, self.config.nu), dtype=torch.float32, **kw),
                StepDiagnostics(*(torch.empty((n, S), dtype=dt, **kw) for dt in _DIAG_DTYPES)))

    def _ticks(self, n: int, sc: Scenarios, phik, world: World, ring_in_place: bool = False):
        """``n`` closed-loop ticks from ``sc``, the body of both loops (the
        graphs' with ``ring_in_place``: their static ring is appended in
        place). Returns (Scenarios after them, trajectory (n, S, 3),
        controls (n, S, nu), StepDiagnostics of (n, S) leaves)."""
        traj, ctrl, diags = self._outputs(n, sc.x)
        state, x, vb = sc
        for t in range(n):
            state, x, vb, u, diag = self._tick_batched(state, x, vb, phik, world, ring_in_place)
            traj[t], ctrl[t] = x, u
            for rows, leaf in zip(diags, diag):
                rows[t] = leaf
        return Scenarios(state=state, x=x, vb=vb), traj, ctrl, diags

    def _make_graph(self, fn):
        return graphs.Graph(fn, self.device)

    @property
    def graph_capture_s(self) -> float:
        """Seconds this engine has spent capturing CUDA graphs, the closed
        loops' and the single-tick entry points' (their warm-ups excluded)."""
        return self._graphs.capture_s + self._tick_graphs.capture_s

    @spanned("ee.explore")
    def explore(self, sc: Scenarios, phik, world: World, n_ticks: int) -> ExploreOutput:
        """Closed-loop batched exploration on the engine's device: each tick
        replans and applies the emitted control for one dt. On the card the
        ticks are replays of captured CUDA graphs (:meth:`_explore_graphs`),
        as the JAX package runs them in one ``lax.scan``; on the CPU they are
        the plain loop, :meth:`_explore_loop`."""
        self._check_local(sc, phik=phik, world=world)
        if self._on_graphs():
            return self._explore_graphs(sc, phik, world, n_ticks, self._make_graph)
        return self._explore_loop(sc, phik, world, n_ticks)

    def _explore_loop(self, sc: Scenarios, phik, world: World, n_ticks: int) -> ExploreOutput:
        """:meth:`explore` as a Python loop that dispatches every operation
        of every tick: what the CPU runs, and on the card the plain version
        that the graphs are held against (call it by name to debug a tick)."""
        return ExploreOutput(*self._ticks(n_ticks, sc, phik, world))

    def _explore_graphs(self, sc: Scenarios, phik, world: World, n_ticks: int,
                        make_graph) -> ExploreOutput:
        """:meth:`explore` as graph replays: ``n_ticks // GRAPH_BLOCK``
        replays of a graph of GRAPH_BLOCK ticks, then one replay of a 1-tick
        graph for each tick left. Both are captured over one set of static
        buffers per input signature (``self._graphs``): (sc, phik, world) are
        copied in on each call, each graph advances the static state in place
        (its ring appended in place, ``ring_in_place``) and returns its ticks' outputs, which are copied into the (T, S, ...)
        outputs before the next replay; the final state is copied out.
        ``make_graph(fn)`` makes the graph of ``fn`` (a
        :class:`~ergodic_exploration_tpu_torch.utils.graphs.Graph`)."""
        traj, ctrl, diags = self._outputs(n_ticks, sc.x)
        if n_ticks == 0:
            return ExploreOutput(sc, traj, ctrl, diags)
        ins = (sc, phik, world)
        entry = self._graphs.entry(("explore", self.config), ins)
        entry.load(ins)
        st_sc, st_phik, st_world = entry.buffers
        entry.holds(st_sc)  # the graphs advance it

        def block(n):
            def fn():
                out_sc, *per_tick = self._ticks(n, st_sc, st_phik, st_world, True)
                graphs.copy_into(st_sc, out_sc)
                return per_tick
            return fn

        B, t = self.GRAPH_BLOCK, 0
        for n in [B] * (n_ticks // B) + [1] * (n_ticks % B):
            got = entry.run(n, block(n), make_graph)
            rows = (traj[t:t + n], ctrl[t:t + n], StepDiagnostics(*(d[t:t + n] for d in diags)))
            entry.copy_out(n, rows, got)
            t += n
        out_sc = entry.clone_out("state", st_sc)
        entry.holds(st_sc, out_sc)
        return ExploreOutput(out_sc, traj, ctrl, diags)

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

    @spanned("ee.explore_mapping_fused")
    def explore_mapping_fused(self, sc: Scenarios, truth: GridMap, n_refreshes: int,
                              refresh_every: int = 10, sensor_range: float = 1.5,
                              sensor_radius_cells: int = 0):
        """:meth:`explore_mapping` with the ray-cast sensor and the dense MI
        refresh, for identically-shaped grids sharing one domain: each
        refresh = occlusion-aware reveal -> MI target (dense path) -> EDT
        world rebuild -> ``refresh_every`` ticks (:meth:`_mapping_refresh`).
        The JAX package runs it as one ``lax.scan``; on the card each refresh
        here is one replay of a captured CUDA graph, and the host adds three
        copies of its coverage, trajectory and metric (:meth:`_mapping_graphs`);
        on the CPU it is the plain loop, :meth:`_explore_mapping_fused_loop`.

        Returns (Scenarios, belief GridMap, coverage (n_refreshes,),
        trajectory (n_refreshes, refresh_every, S, 3), ergodic metric
        (n_refreshes, refresh_every, S): the per-tick metric against each
        refresh's CURRENT target). Under a mesh ``truth`` is this rank's rows.
        """
        args = (n_refreshes, refresh_every, sensor_range, sensor_radius_cells)
        if self._on_graphs():
            return self._mapping_graphs(sc, truth, *args, make_graph=self._make_graph)
        return self._explore_mapping_fused_loop(sc, truth, *args)

    def _mapping_setup(self, sc: Scenarios, truth: GridMap, sensor_range: float):
        """(truth on the device, the ray-cast window in cells): the host work
        ahead of either mapping loop (the window reads the resolution)."""
        from ergodic_exploration_tpu_torch.ops import sensor

        self._check_local(sc, truth=truth)
        truth = self._grids_here(truth)
        return truth, sensor.raycast_window_cells(sensor_range, float(truth.resolution.min()))

    def _mapping_refresh(self, sc: Scenarios, belief: GridMap, truth: GridMap, win: int,
                         refresh_every: int, sensor_range: float, sensor_radius_cells: int,
                         ring_in_place: bool = False, ops=None):
        """One refresh of :meth:`explore_mapping_fused`, the body of both its
        loops (the JAX ``chunk`` scan's body): ray-cast reveal -> dense MI
        target (M, on the operands ``ops``: :meth:`_dense_ops` of ``truth``
        on its scenario 0's extent when None) -> world -> ``refresh_every``
        ticks (``ring_in_place``: the graph's).
        Returns (Scenarios, belief, coverage (), trajectory (E, S, 3), metric
        (E, S))."""
        from ergodic_exploration_tpu_torch.ops import sensor

        ops = self._dense_ops(truth, None) if ops is None else ops
        belief = sensor.reveal_raycast(belief, truth, sc.x, sensor_range, win,
                                       occupied_threshold=self.config.occupied_threshold)
        phik = self._phik_grid_batch_dense_fn(belief, None, sensor_radius_cells, ops)
        world = self._world_batched(belief, belief.domain())
        sc, traj, _, diags = self._ticks(refresh_every, sc, phik, world, ring_in_place)
        return sc, belief, sensor.fraction_known(belief), traj, diags.ergodic_metric

    def _explore_mapping_fused_loop(self, sc: Scenarios, truth: GridMap, n_refreshes: int,
                                    refresh_every: int = 10, sensor_range: float = 1.5,
                                    sensor_radius_cells: int = 0):
        """:meth:`explore_mapping_fused` as a Python loop over refreshes that
        dispatches every operation: what the CPU runs, and on the card the
        plain version the graphs are held against."""
        truth, win = self._mapping_setup(sc, truth, sensor_range)
        ops = self._dense_ops(truth, None)
        belief = truth._replace(data=torch.full_like(truth.data, -1.0))
        coverage, traj, metric = [], [], []
        for _ in range(n_refreshes):
            sc, belief, cov, tr, m = self._mapping_refresh(sc, belief, truth, win, refresh_every,
                                                           sensor_range, sensor_radius_cells,
                                                           ops=ops)
            coverage.append(cov)
            traj.append(tr)
            metric.append(m)
        return sc, belief, torch.stack(coverage), torch.stack(traj), torch.stack(metric)

    def _mapping_graphs(self, sc: Scenarios, truth: GridMap, n_refreshes: int,
                        refresh_every: int, sensor_range: float, sensor_radius_cells: int,
                        make_graph):
        """:meth:`explore_mapping_fused` as one graph replay a refresh,
        captured over static (sc, belief, truth) buffers (copied in once a
        call); each replay advances the static state and belief in place,
        and its coverage, trajectory and metric are copied out before the
        next. M's operands are built outside the graph (:meth:`_dense_ops`)
        and copied in with the inputs. ``make_graph`` as for
        :meth:`_explore_graphs`."""
        truth, win = self._mapping_setup(sc, truth, sensor_range)
        ins = (sc, torch.full_like(truth.data, -1.0), truth, self._dense_ops(truth, None))
        key = ("mapping", self.config, win, refresh_every, sensor_range, sensor_radius_cells)
        entry = self._graphs.entry(key, ins)
        entry.load(ins)
        st_sc, st_belief, st_truth, st_ops = entry.buffers
        entry.holds((st_sc, st_belief))  # the graph advances them

        def refresh():
            out_sc, belief, cov, tr, m = self._mapping_refresh(
                st_sc, st_truth._replace(data=st_belief), st_truth, win, refresh_every,
                sensor_range, sensor_radius_cells, ring_in_place=True, ops=st_ops)
            graphs.copy_into((st_sc, st_belief), (out_sc, belief.data))
            return cov, tr, m

        S = sc.x.shape[0]
        kw = dict(dtype=torch.float32, device=self.device)
        coverage = torch.empty((n_refreshes,), **kw)
        traj = torch.empty((n_refreshes, refresh_every, S, 3), **kw)
        metric = torch.empty((n_refreshes, refresh_every, S), **kw)
        for i in range(n_refreshes):
            got = entry.run(refresh_every, refresh, make_graph)
            entry.copy_out("refresh", (coverage[i], traj[i], metric[i]), got)
        out_sc, belief = entry.clone_out("state", (st_sc, st_belief))
        entry.holds((st_sc, st_belief), (out_sc, belief))
        return out_sc, truth._replace(data=belief), coverage, traj, metric

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
        On a CUDA device this captures the graphs of ``replan``,
        ``replan_refresh``, ``replan_refresh_mi`` and of ``explore`` at each
        length, as the JAX package compiles them, so that the first real tick
        of those shapes does not stall; ``capture_<stage>`` is the part of
        the stage spent capturing.
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

        def timed(name, fn, captures=False):
            captured = self.graph_capture_s
            t0 = time.perf_counter()
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[name] = round(time.perf_counter() - t0, 3)
            if captures and self.device.type == "cuda":  # capturing its graphs, within the stage
                timings[f"capture_{name}"] = round(self.graph_capture_s - captured, 3)
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
                sc, self.shard_scenarios(grids), world, domain=domain), captures=True)
        else:
            world = self.empty_world(domain, S)
        phik = timed("phik_from_gmm", lambda: self.phik_from_gmm(gmm, domain, world.free_mask))
        timed("replan", lambda: self.replan(sc, phik, world), captures=True)
        timed("replan_refresh", lambda: self.replan_refresh(sc, self.shard_scenarios(gmm),
                                                            domain, world), captures=True)
        for n in n_ticks:
            timed(f"explore_{n}", lambda n=n: self.explore(sc, phik, world, n), captures=True)
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
