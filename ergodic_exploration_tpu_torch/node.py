"""Single-robot real-time loop: the reference ROS node's replacement (port of
``ergodic_exploration_tpu/node.py``).

Reference capability: the exploration node (SURVEY.md sections 2 L5, 4.1,
4.3, 4.5): take ``/map`` (nav_msgs/OccupancyGrid) and ``/odom``, replan at
``frequency`` Hz, publish ``/cmd_vel`` twists and the predicted path. This
class keeps the callback / tick shape without the ROS transport: maps and
odometry go in as arrays, body twists come out.

    node = ExplorationNode(load_yaml_config("config/cart.yaml"), target="mi")
    node.on_map(int8_map, x0, y0, resolution)   # map cadence
    node.on_odom(pose)                            # every tick
    twist, diag = node.step()                     # one replan
    path = node.predicted_path()                  # (H+1, 3)

The robot is one scenario (S = 1) of the batched controller. The tick is
``ops.solve_kernel.replan_batched_fused`` (K1 on the node's own map) under
``use_fused_solve``, else the eager ``ErgodicController.step`` (its safety
stage is the ``fused_safety`` kernel). On the card ``step`` replays a CUDA
graph of that tick, as the JAX node runs it as one jitted computation: the
graph reads buffers the node owns (the state, which it advances in place;
the pose and twist, which ``on_odom`` writes in place; the target and the
world, which a map update copies into) and packs the twist and the
diagnostics into one tensor, so that a tick is one replay and one
device-to-host copy. It is captured on the first tick and again only when
the map's shape changes. ``_eager_tick`` is its plain version, which the CPU
runs (``node._step(node._eager_tick)`` runs it on the card). A map update is
applied at the next tick: the EDT + gradient on the host through the native runtime
(``native.py``) followed by one host-to-device copy, or
``DistanceField.from_grid`` on the device without it; then the target (the
dense MI map of ``ops.target.mi_target_values``, or the GMM over the free
cells) and its coefficients.

The node runs on the CUDA device unless ``device="cpu"`` is passed, and
switches TF32 off as ``Engine`` does (it builds no ``Engine``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ergodic_exploration_tpu_torch import native
from ergodic_exploration_tpu_torch.config import EngineConfig
from ergodic_exploration_tpu_torch.controller import ErgodicController, StepDiagnostics, World
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops import target as target_ops
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.utils import graphs
from ergodic_exploration_tpu_torch.utils.device import resolve_device

# one tick's host read: the twist (3) then the seven StepDiagnostics leaves,
# all as float32 (codes and flags are small integers, exact in float32)
_PACKED = 3 + len(StepDiagnostics._fields)
_DIAG_NP = (np.float32, np.float32, np.int32, np.bool_, np.bool_, np.bool_, np.bool_)


def _unpack(v: np.ndarray):
    """(twist (3,), StepDiagnostics of numpy scalars) from a packed read."""
    return v[:3].copy(), StepDiagnostics(*(t(v[3 + i]) for i, t in enumerate(_DIAG_NP)))


def _batch1(tree):
    """A NamedTuple of tensors with a leading axis of one added to each."""
    return type(tree)(*(t[None] for t in tree))


class ExplorationNode:
    """Receding-horizon exploration for ONE robot at real-time rates.

    Args:
        config: EngineConfig.
        domain: exploration Domain. If None, taken from the first map.
        target: a ``GaussianMixture`` (unbatched leaves) for a static GMM
            target, or ``"mi"`` for the mutual-information target recomputed
            from the occupancy grid at every map update (BASELINE config 4).
        use_native: preprocess maps on the host with the C++ runtime when
            ``g++`` is available.
        pipeline: one-tick-latency mode: ``step()`` enqueues tick t and
            returns tick t-1's (twist, diagnostics).
        device: the torch device; None is the CUDA device (an error without
            one), ``"cpu"`` runs every kernel's plain version.
    """

    def __init__(self, config: EngineConfig, domain: Optional[Domain] = None, target="mi",
                 use_native: bool = True, pipeline: bool = False, device=None):
        self.device = dev = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config.validate()
        self.controller = ErgodicController(self.config)
        self.model = self.controller.model
        self.target = target if isinstance(target, str) else target_ops.GaussianMixture(
            *(torch.as_tensor(t, device=dev).to(torch.float32) for t in target))
        self.domain = None if domain is None else Domain(*(t.to(dev) for t in domain))
        self.use_native = use_native and native.available()
        # the twin of jax.random.PRNGKey(0): one scenario, key words (0, 0)
        self.state = self.controller.init_state(torch.zeros((1, 2), dtype=torch.int64,
                                                            device=dev))
        self._map = None  # (data (H, W) float32 on the host, x0, y0, resolution)
        self._world: Optional[World] = None  # leaves with a leading axis of one
        self._phik = None  # (1, K, K)
        self._stale = True
        self._pose = torch.zeros(3, dtype=torch.float32, device=dev)
        self._twist = torch.zeros(3, dtype=torch.float32, device=dev)
        self._graph = None  # the tick's graph on the card (made on the next tick when None)
        self._graph_state = None  # the state tree it advances in place
        self.ticks = 0
        # pipelining: two pinned host slots (tick t writes slot t % 2 while
        # tick t-1's is read) and an event recorded after each slot's copy
        self.pipeline = pipeline
        self._pending = None  # (slot, source tensor, event) of the last tick
        self._host = self._events = None
        if pipeline:
            cuda = dev.type == "cuda"
            self._host = torch.empty((2, _PACKED), dtype=torch.float32, pin_memory=cuda)
            self._events = [torch.cuda.Event() for _ in range(2)] if cuda else None

    # ------------------------------------------------------------------
    # host -> device
    # ------------------------------------------------------------------

    def _upload(self, *arrays):
        """numpy arrays -> float32 tensors on the node's device through ONE
        host-to-device copy, from pinned memory and without a wait on the
        CUDA device (the caching host allocator keeps the pinned block until
        the copy is done)."""
        arrays = [np.asarray(a, dtype=np.float32) for a in arrays]
        host = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
        if self.device.type == "cuda":
            buf = host.pin_memory().to(self.device, non_blocking=True)
        else:
            buf = host
        out, i = [], 0
        for a in arrays:
            out.append(buf[i:i + a.size].view(a.shape))
            i += a.size
        return out

    def _set_vec3(self, dst: torch.Tensor, v) -> None:
        """Write the 3-vector ``v`` into ``dst`` in place (the tick's graph
        reads ``dst``): a host array through one copy from pinned memory that
        does not wait for the device."""
        if isinstance(v, torch.Tensor):
            dst.copy_(v.detach().reshape(3))
            return
        host = torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(3))
        if self.device.type == "cuda":
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)

    # ------------------------------------------------------------------
    # callbacks (reference: mapCallback / odomCallback)
    # ------------------------------------------------------------------

    def on_map(self, data, x0: float = 0.0, y0: float = 0.0, resolution: float = 0.05) -> None:
        """Take an occupancy grid update: int8 in the ROS convention (-1
        unknown, 0..100) or float (-1 unknown, 0..1), shape (H, W) row-major
        like nav_msgs. The EDT and the target follow at the next tick."""
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        arr = np.asarray(data)
        if arr.dtype == np.int8:
            arr = (native.ros_ingest(arr) if self.use_native
                   else GridMap.from_ros(arr, x0, y0, resolution).data.numpy())
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        self._map = (arr, x0, y0, resolution)
        if self.domain is None:
            h, w = arr.shape
            res = torch.tensor(resolution, dtype=torch.float32)
            self.domain = Domain(torch.tensor([x0, y0], dtype=torch.float32).to(self.device),
                                 torch.stack([w * res, h * res]).to(self.device))
        self._stale = True

    def on_odom(self, pose, twist=None) -> None:
        """Cache the latest pose (x, y, yaw) and body twist (vx, vy, w)."""
        self._set_vec3(self._pose, pose)
        if twist is not None:
            self._set_vec3(self._twist, twist)

    # ------------------------------------------------------------------
    # preprocessing (reference: work triggered by mapCallback, 4.3)
    # ------------------------------------------------------------------

    def _refresh(self) -> None:
        cfg, dev = self.config, self.device
        if self.domain is None:
            raise RuntimeError("no domain: call on_map() or pass domain=")
        grid = None
        if self._map is None:
            world = World.empty(self.domain)
        else:
            data, x0, y0, resolution = self._map
            if self.use_native:
                dist, grad = native.edt2d(data, cfg.occupied_threshold,
                                          float(np.float32(resolution)))
                gdata, origin, res, dist, grad = self._upload(data, [x0, y0], resolution,
                                                              dist, grad)
                grid = GridMap(gdata, origin, res)
                df = DistanceField(dist=dist, grad=grad, origin=origin, resolution=res)
            else:
                grid = GridMap(*self._upload(data, [x0, y0], resolution))
                df = DistanceField.from_grid(grid, cfg.occupied_threshold)
            world = World(domain=self.domain, dist=df)
        world = World(domain=_batch1(world.domain), dist=_batch1(world.dist))

        pts = self.domain.sample_lattice(cfg.grid_samples)
        if isinstance(self.target, str) and self.target == "mi":
            if grid is None:
                phi = target_ops.normalize_phi(torch.ones(pts.shape[0], device=dev))
            else:
                phi = target_ops.mi_target_values(grid, pts,
                                                  frontier_cells=cfg.mi_frontier_cells,
                                                  occupied_threshold=cfg.occupied_threshold)
        else:
            free_mask = None
            if grid is not None:
                free_mask = grid.occupancy_at(pts) < cfg.occupied_threshold
            phi = target_ops.gmm_target_values(pts, self.target, free_mask=free_mask)
        self._install(self.controller.target_coefficients(phi, pts, self.domain)[None], world)
        self._stale = False

    def _install(self, phik, world: World) -> None:
        """Make (phik, world) the tick's: copied into the node's buffers,
        which the tick's graph reads, where they have the shapes of the last
        map's, else copied into new buffers (and the graph is captured anew
        at the next tick)."""
        new = (phik, world)
        if self._phik is not None and graphs.signature(new) == graphs.signature(
                (self._phik, self._world)):
            graphs.copy_into((self._phik, self._world), new)
        else:
            self._phik, self._world = graphs.clone(new)
            self._graph = None

    # ------------------------------------------------------------------
    # the tick (reference: the frequency-Hz control loop, 4.2)
    # ------------------------------------------------------------------

    def step(self):
        """One replan at the latest pose: on the card a replay of the tick's
        graph (:meth:`_graph_tick`), on the CPU the eager tick.

        Returns (twist (3,) np.ndarray, the ``cmd_vel`` body twist;
        StepDiagnostics of numpy scalars). With ``pipeline=True`` they belong
        to the PREVIOUS tick's solve (a zero twist and None on the first
        tick): the current solve is enqueued and its device-to-host copy
        drains while the plant applies the previous command.
        """
        return self._step(self._graph_tick if self.device.type == "cuda" else self._eager_tick)

    def _tick(self, state):
        """The tick, the body of both routes: (the state after it, the twist
        (3,) and the seven diagnostics packed as float32 (_PACKED,))."""
        cfg = self.config
        x, vb = self._pose[None], self._twist[None]
        if cfg.use_fused_solve:
            from ergodic_exploration_tpu_torch.ops.solve_kernel import replan_batched_fused

            state, u, diag = replan_batched_fused(cfg, self.model, state, x, vb, self._phik,
                                                  self._world)
        else:
            state, u, diag = self.controller.step(state, x, vb, self._phik, self._world)
        packed = torch.cat([self.model.twist(u)[0],
                            torch.stack([leaf[0].to(torch.float32) for leaf in diag])])
        return state, packed

    def _eager_tick(self) -> torch.Tensor:
        """The tick dispatched op by op: what the CPU runs, and on the card
        the plain version the graph is held against."""
        self.state, packed = self._tick(self.state)
        return packed

    def _graph_tick(self, make_graph=None) -> torch.Tensor:
        """The tick as a replay of its graph (made by ``make_graph(fn)``, a
        ``utils.graphs.Graph`` by default, captured on its first call),
        which advances the node's state in place. A state the node was handed
        since (an eager tick's, a caller's) is copied in first."""
        if self._graph is None:
            self._graph_state = graphs.clone(self.state)
            st = self._graph_state

            def fn():
                state, packed = self._tick(st)
                graphs.copy_into(st, state)
                return packed

            self._graph = (make_graph or (lambda f: graphs.Graph(f, self.device)))(fn)
        elif self.state is not self._graph_state:
            graphs.copy_into(self._graph_state, self.state)
        self.state = self._graph_state
        return self._graph()

    def _step(self, tick):
        """:meth:`step` through ``tick`` (:meth:`_graph_tick` or
        :meth:`_eager_tick`)."""
        if self._stale:
            self._refresh()
        packed = tick()
        self.ticks += 1
        if not self.pipeline:
            return _unpack(packed.cpu().numpy())
        slot = self.ticks % 2
        self._host[slot].copy_(packed, non_blocking=True)
        event = None
        if self._events is not None:
            event = self._events[slot]
            event.record()
        prev, self._pending = self._pending, (slot, packed, event)
        if prev is None:
            return np.zeros(3, dtype=np.float32), None
        return self._drain(prev)

    def _drain(self, pending):
        slot, _source, event = pending  # the source stays referenced until here
        if event is not None:
            event.synchronize()
        return _unpack(self._host[slot].numpy())

    def flush(self):
        """Drain the pipelined tail: the last enqueued solve's (twist, diag),
        or None if nothing is pending."""
        prev, self._pending = self._pending, None
        return None if prev is None else self._drain(prev)

    def predicted_path(self) -> np.ndarray:
        """(H+1, 3) forward-simulated path (nav_msgs/Path parity)."""
        path = self.controller.predicted_path(self.state, self._pose[None])
        return path[0].cpu().numpy()

    def run(self, rate_hz: float = 10.0, n_steps: int = 100, plant=None, on_tick=None):
        """Timer loop at ``rate_hz`` (reference: ros::Rate spin).

        ``plant(twist) -> (pose, body_twist)`` advances the robot (a
        simulator or hardware bridge) and feeds odometry back; ``on_tick``
        receives (node, twist, diag) for logging / viz.
        """
        period = 1.0 / rate_hz
        for _ in range(n_steps):
            t0 = time.perf_counter()
            tw, diag = self.step()
            if plant is not None:
                pose, vb = plant(tw)
                self.on_odom(pose, vb)
            if on_tick is not None:
                on_tick(self, tw, diag)
            sleep = period - (time.perf_counter() - t0)
            if sleep > 0 and plant is None:
                time.sleep(sleep)
        return self
