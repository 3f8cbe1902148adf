"""Frozen configuration dataclasses for the ergodic-exploration engine.

A copy of ``ergodic_exploration_tpu/config.py`` (same fields, same defaults,
same YAML names) so the PyTorch port imports no JAX package code, with two
checks the JAX package lacks: ``validate()`` refuses a ``precision`` other
than ``"fp32"``, and :func:`load_yaml_config` warns about the keys it drops.
Some field comments quote measurements or switches of the JAX package; the
port reads the same fields with the same meaning.

Replaces the reference's ROS parameter server + per-robot YAML configs
(reference: ``config/cart.yaml`` / ``config/omni.yaml`` loaded in the node
main, SURVEY.md section 4.1 — ~40 scalar params). Everything is hashable.

The YAML loader (:func:`load_yaml_config`) accepts the reference's parameter
names so a reference user can carry their config files over.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class CartParams:
    """Differential-drive ("cart") kinematic parameters.

    Reference: the ``Cart`` model functor (wheel_radius, wheel_base ctor
    args; SURVEY.md section 3, cart row). Defaults are turtlebot3-class.
    """

    wheel_radius: float = 0.033
    wheel_base: float = 0.16


@dataclass(frozen=True)
class OmniParams:
    """Mecanum ("omni") kinematic parameters.

    Reference: the ``Omni`` model functor (4 mecanum wheels -> body twist;
    SURVEY.md section 3, omni row). ``lx``/``ly`` are the half-distances from
    the body center to the wheel axles along x/y.
    """

    wheel_radius: float = 0.0505
    lx: float = 0.28
    ly: float = 0.2665


@dataclass(frozen=True)
class DwaConfig:
    """Dynamic-window-approach fallback parameters.

    Reference: ``DynamicWindow`` ctor (accel limits, sample counts, DWA
    horizon/dt; SURVEY.md sections 3 and A.6). Candidates are sampled in body
    twist space (vx, vy, omega) — a ``vy`` sample count of 1 restricts to the
    cart's non-holonomic window.
    """

    acc_lim: Tuple[float, float, float] = (1.0, 1.0, 2.0)  # (ax, ay, a_omega)
    samples: Tuple[int, int, int] = (5, 1, 11)  # (n_vx, n_vy, n_omega)
    vel_lim: Tuple[float, float, float] = (0.3, 0.3, 1.0)  # |vx|,|vy|,|omega| caps
    horizon: int = 10  # rollout steps per candidate
    dt: float = 0.1
    # Candidate-selection metric: "control" = ||u_cand - u_ergodic||^2 in
    # CONTROL (wheel-velocity) space — the reference's cost (SURVEY.md A.6);
    # "twist" = distance in realized body-twist space (weights (v, omega)
    # by different wheel-map gains, so the argmin candidate can differ).
    cost_space: str = "control"


@dataclass(frozen=True)
class EngineConfig:
    """Full controller + engine configuration.

    Mirrors (and extends, for the batched/TPU side) the reference's rosparam
    set listed in SURVEY.md section 4.1: dt, horizon, exploration weight,
    basis size, buffer sizes, control limits, R diagonal, wheel geometry,
    collision radii, DWA parameters.
    """

    # --- model (L2) ---
    model: str = "cart"  # "cart" | "omni"
    cart: CartParams = CartParams()
    omni: OmniParams = OmniParams()

    # --- horizon / integration ---
    dt: float = 0.1
    horizon: int = 20

    # --- ergodic core (L3) ---
    num_basis: int = 10  # K modes per spatial dim -> K^2 coefficients
    # gamma: weight on the ergodic gradient. Round-5 retune (20 -> 200): at
    # 20 the default closed loop explored at ~0.03 m/s — correct but far
    # below the reference demos' robot speeds; 200 gives ~0.1-0.2 m/s mean
    # exploration speed on the config-4 quality map (docs/PERFORMANCE.md
    # round 5; the exploration-rate floor is pinned by
    # tests/test_quality.py).
    ergodic_weight: float = 200.0
    barrier_weight: float = 1.0  # beta: weight on barrier gradients
    # diag of R (len = model nu). The natural scale is (wheel-map gain)^2:
    # u = -R^-1 B^T rho with B entries ~ wheel_radius/2, so R ~ 1 would make
    # the update two orders of magnitude too timid for turtlebot-class wheels.
    r_diag: Tuple[float, ...] = (0.001, 0.001)
    u_min: Tuple[float, ...] = (-6.0, -6.0)
    u_max: Tuple[float, ...] = (6.0, 6.0)
    grid_samples: Tuple[int, int] = (100, 100)  # phi sample lattice (Ns = prod)

    # --- trajectory history (replay buffer) ---
    buffer_capacity: int = 1024
    # Bounded by default: with unbounded history the ergodic gradient scales
    # as 1/M and the controls decay to zero (the robot stalls after a few
    # hundred ticks). The reference likewise samples a bounded batch.
    buffer_batch: Optional[int] = 100  # None: use all valid entries
    history: str = "ring"  # "ring" (reference parity) | "accumulate" (O(K^2) fast path)
    # ONE history-batch index draw shared by every scenario per tick (the
    # draw stays uniform per scenario — scenarios tick together, so their
    # buffer counts are equal; only CROSS-scenario sampling correlation is
    # introduced, which independent solves never observe). Lets the batched
    # compaction run as one shared-one-hot GEMM instead of per-scenario
    # one-hot machinery — measured ~1.2 ms/tick at S=4096 on v5e. Engine
    # init gives all scenarios the same RNG key under this flag, so the
    # vmapped and fused paths stay bit-identical.
    shared_history_draw: bool = False

    # --- collision / barrier (L1 world + costs) ---
    # Side length (cells) of the local distance-field window used for ALL
    # per-tick map queries (barrier knots, validation, DWA). Queries happen
    # AT trajectory positions (d_safe only thresholds the queried values),
    # so the window must cover the saturated rollout reach
    # H * dt * v_max (~0.4 m = 8 cells cart / ~0.6 m omni at defaults) plus
    # bilinear support and margin; map access outside the patch clamps to
    # its edge. See ops/patch.py. 24 cells = a +-0.6 m window (50% margin
    # over the cart's reach); extraction cost scales ~P^2 (round-3 ablation:
    # 32 -> 24 saves 0.32 ms/tick at S=4096).
    patch_cells: int = 24
    # Central sub-window of the patch used for the safety stage's queries
    # (validation + DWA). Must cover the vel-limited reachable set of one
    # validation/DWA rollout (~vel_lim * horizon * dt + a cell of rounding;
    # ~0.3 m ~ 6 cells at defaults). Queries clamp to the window edge, so an
    # undersized window degrades silently — keep a 2x margin.
    safety_patch_cells: int = 16
    boundary_radius: float = 0.2  # robot footprint radius [m]
    occupied_threshold: float = 0.65  # occupancy prob above which a cell is an obstacle
    barrier_eps: float = 0.05  # boundary-barrier activation margin [m]
    barrier_boundary_weight: float = 25.0
    barrier_obstacle_weight: float = 0.05
    # Obstacle barrier active (and validation's OBSTACLE warn code raised)
    # when clearance - boundary_radius < d_safe. Round-5 retune (0.5 ->
    # 0.2): at 0.5 the barrier band reached 0.7 m from every obstacle, so
    # on maps with ~1.3 m doorways the bands from facing walls OVERLAPPED
    # and sealed every passage — the fleet plateaued at ~35% coverage with
    # robots parked at band-edge equilibria (docs/PERFORMANCE.md round 5).
    # Hard safety is unaffected: validation/DWA reject on d <= 0 contact,
    # not on d_safe.
    d_safe: float = 0.2

    # --- validation + DWA fallback (L4) ---
    enable_safety: bool = True  # False: skip validation + DWA (pure ergodic step)
    val_horizon: int = 10
    val_dt: float = 0.1
    dwa: DwaConfig = DwaConfig()

    # --- target shaping (config 4 / MI target) ---
    # Mask the MI/entropy target to cells within this many cells of KNOWN-
    # FREE space (the reachable frontier) — SURVEY.md A.3 "masked to known-
    # free-adjacent cells". 0 = legacy all-unknown weighting, which puts
    # most phi mass on deep-unknown space behind walls and pulls robots
    # into them (measured round 5, docs/PERFORMANCE.md).
    mi_frontier_cells: int = 3

    # --- failure detection: orbit guard ---
    # The receding-horizon update map has saturated closed-orbit attractors:
    # once the warm-started control sequence curls into a loop shorter than
    # the horizon, each replan reproduces it and the robot circles one spot
    # at full speed forever (measured round 5: stalled scenarios moved at
    # the saturated 0.3 m/s with < 3 cm net displacement per 60 s). The
    # guard resets a scenario's warm start (U = 0, a fresh solve — the same
    # recovery as the divergence guard) whenever its net displacement over
    # the last `orbit_window` ticks falls below `orbit_eps` meters. Healthy
    # sweeps move >= 1 m per 64 ticks and never trigger. 0 disables.
    orbit_window: int = 64
    orbit_eps: float = 0.15

    # --- numerics / scale-out ---
    # "fp32" only in the port: every matmul runs in exact float32 (TF32 off);
    # validate() refuses the JAX package's "bf16"
    precision: str = "fp32"
    use_pallas: bool = True  # fused ergodic-reduction kernel where profitable
    # Fused Pallas descent core for the batched Engine replan (rollout ->
    # basis -> gradient -> barrier -> co-state -> update in ONE kernel;
    # ops/solve_kernel.py). Semantics match the vmapped controller to fp32
    # reassociation (~1e-6). Off by default: the interpreter path is slow on
    # CPU; bench/TPU runs enable it.
    use_fused_solve: bool = False
    # All scenarios share ONE map (fleet-on-a-shared-map batching). Lets the
    # masked target refresh fold the free-space mask into the dense basis
    # table (engine._phik_from_gmm_fn) so masking costs nothing instead of an
    # (S, N) HBM pass — measured ~1 ms/tick at S=4096 on v5e — and, on the
    # fused path, moves patch extraction INSIDE the solve kernel (the shared
    # map rides along as three exact bf16 chunks; ops/solve_kernel.py
    # section 0) so the XLA one-hot extraction and its (S, P, P) transposes
    # disappear. Semantics are identical when every scenario's map (hence
    # free mask / distance field) is the same row.
    shared_maps: bool = False
    # Scenario-tile width (lanes) of the fused Pallas kernels. Must be a
    # power of two >= 128 (Mosaic lane-dim block constraint); S not divisible
    # falls back to smaller powers of two automatically. Sweepable on
    # hardware (tools/tpu_patch_ab.py): 128 measured best at S=4096 on v5e
    # (256 exceeded scoped VMEM once the round-4 bit-packed safety planes
    # became resident; 512 OOM'd before that).
    solve_tile: int = 128
    # Validate the shared-geometry contracts (shared_maps / dense shared-
    # domain refresh) at the Python API edge: concrete operands are checked
    # host-side ONCE per distinct array object and misuse raises ValueError
    # instead of silently computing scenario 0's physics for everyone
    # (utils/validation.py). The map-data equality check reads the batch
    # back once per world object (map cadence); set False to skip entirely.
    validate_shared: bool = True
    # Unroll factor for the short sequential RK4 scans (rollout + co-state).
    # Per-step bodies are tiny (batch, 3) ops, so unrolling lets XLA fuse
    # across steps; sweepable on hardware (static -> recompiles on change).
    # Measured on v5e at S=4096 (tools/tpu_tune.py): 1 -> 15.6 ms/step,
    # 4 -> 16.1, 8 -> 15.1, 20 (full horizon) -> 14.9. Full unroll wins.
    scan_unroll: int = 20

    @property
    def nx(self) -> int:
        return 3

    @property
    def nu(self) -> int:
        return 2 if self.model == "cart" else 4

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "EngineConfig":
        if self.model not in ("cart", "omni"):
            raise ValueError(f"unknown model {self.model!r}")
        if len(self.r_diag) != self.nu or len(self.u_min) != self.nu or len(self.u_max) != self.nu:
            raise ValueError(
                f"r_diag/u_min/u_max must have length nu={self.nu} for model {self.model!r}"
            )
        if self.history not in ("ring", "accumulate"):
            raise ValueError(f"unknown history mode {self.history!r}")
        if self.dwa.cost_space not in ("control", "twist"):
            raise ValueError(f"unknown dwa cost_space {self.dwa.cost_space!r}")
        if self.horizon < 1 or self.num_basis < 1:
            raise ValueError("horizon and num_basis must be >= 1")
        if self.precision != "fp32":
            raise ValueError(
                f"precision {self.precision!r} is not supported: the port runs exact float32 "
                "matmuls (TF32 off), so only 'fp32' is accepted")
        return self


def default_config(model: str = "cart") -> EngineConfig:
    """Config with per-model defaults filled in (control dims, limits)."""
    if model == "cart":
        return EngineConfig(model="cart").validate()
    if model == "omni":
        return EngineConfig(
            model="omni",
            r_diag=(0.001,) * 4,
            u_min=(-6.0,) * 4,
            u_max=(6.0,) * 4,
            patch_cells=40,  # larger one-tick reach (~0.6 m at defaults)
        ).validate()
    raise ValueError(f"unknown model {model!r}")


# Mapping from reference-style rosparam names (SURVEY.md section 4.1) to
# EngineConfig fields. Scalars only; tuples are handled explicitly below.
_REFERENCE_PARAM_MAP = {
    "dt": "dt",
    "horizon": "horizon",
    "num_basis": "num_basis",
    "expl_weight": "ergodic_weight",
    "gamma": "ergodic_weight",
    "barrier_weight": "barrier_weight",
    "buffer_size": "buffer_capacity",
    "batch_size": "buffer_batch",
    "boundary_radius": "boundary_radius",
    "occupied_threshold": "occupied_threshold",
    "val_horizon": "val_horizon",
    "val_dt": "val_dt",
}


# Keys of ROS parameter files that configure a ROS node (frame ids, topic
# names, the loop rate), not the controller: the loader drops them without a
# warning. Any other key it cannot use is named in one warning per call.
ROS_ONLY_KEYS = frozenset({
    "frequency", "map_frame_id", "base_frame_id", "odom_frame_id", "world_frame_id",
    "global_frame", "robot_base_frame", "map_topic", "odom_topic", "cmd_vel_topic",
    "cmd_topic", "path_topic", "target_topic", "marker_topic", "scan_topic",
})


def _as_bool(val) -> bool:
    """Strict bool coercion: YAML bools, 0/1, and true/false strings only."""
    if isinstance(val, bool):
        return val
    if isinstance(val, (int, float)) and val in (0, 1):
        return bool(val)
    if isinstance(val, str) and val.strip().lower() in ("true", "false", "yes", "no", "on", "off"):
        return val.strip().lower() in ("true", "yes", "on")
    raise ValueError(f"cannot interpret {val!r} as a bool config value")


def load_yaml_config(path_or_dict) -> EngineConfig:
    """Build an :class:`EngineConfig` from a reference-style YAML file or dict.

    Accepts the reference's parameter names (``expl_weight``, ``buffer_size``,
    ``wheel_radius`` ...) as well as native field names, so reference
    ``config/*.yaml`` files carry over (SURVEY.md section 6, config row).
    Keys it cannot use, other than those of :data:`ROS_ONLY_KEYS`, are named
    in one :class:`UserWarning`.
    """
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f) or {}

    model = raw.pop("model", "cart")
    cfg = default_config(model)
    updates = {}

    # model geometry
    if model == "cart":
        cart = cfg.cart
        if "wheel_radius" in raw:
            cart = dataclasses.replace(cart, wheel_radius=float(raw.pop("wheel_radius")))
        if "wheel_base" in raw:
            cart = dataclasses.replace(cart, wheel_base=float(raw.pop("wheel_base")))
        updates["cart"] = cart
    else:
        omni = cfg.omni
        if "wheel_radius" in raw:
            omni = dataclasses.replace(omni, wheel_radius=float(raw.pop("wheel_radius")))
        if "lx" in raw:
            omni = dataclasses.replace(omni, lx=float(raw.pop("lx")))
        if "ly" in raw:
            omni = dataclasses.replace(omni, ly=float(raw.pop("ly")))
        updates["omni"] = omni

    # control limits / R: accept scalars (broadcast) or lists
    nu = cfg.nu
    for yaml_key, field in (("control_min", "u_min"), ("control_max", "u_max"),
                            ("u_min", "u_min"), ("u_max", "u_max"),
                            ("r", "r_diag"), ("r_diag", "r_diag")):
        if yaml_key in raw:
            v = raw.pop(yaml_key)
            updates[field] = tuple(float(x) for x in v) if hasattr(v, "__len__") else (float(v),) * nu

    if "grid_samples" in raw:
        v = raw.pop("grid_samples")
        updates["grid_samples"] = tuple(int(x) for x in v) if hasattr(v, "__len__") else (int(v),) * 2

    dwa_kw = {}
    for k in ("acc_lim", "samples", "vel_lim"):
        if f"dwa_{k}" in raw:
            dwa_kw[k] = tuple(raw.pop(f"dwa_{k}"))
    if "dwa_horizon" in raw:
        dwa_kw["horizon"] = int(raw.pop("dwa_horizon"))
    if "dwa_dt" in raw:
        dwa_kw["dt"] = float(raw.pop("dwa_dt"))
    if "dwa_cost_space" in raw:
        dwa_kw["cost_space"] = str(raw.pop("dwa_cost_space"))
    if dwa_kw:
        updates["dwa"] = dataclasses.replace(cfg.dwa, **dwa_kw)

    field_names = {f.name for f in dataclasses.fields(EngineConfig)}
    # Coerce by the DEFAULT VALUE's type so every scalar field round-trips
    # with its declared type (bool before int: isinstance(True, int) is True).
    defaults = EngineConfig()
    dropped = []
    for key, val in list(raw.items()):
        field = _REFERENCE_PARAM_MAP.get(key, key if key in field_names else None)
        if field is None:
            if key not in ROS_ONLY_KEYS:
                dropped.append(key)
            continue
        default = getattr(defaults, field)
        if field == "buffer_batch":
            updates[field] = None if val is None else int(val)
        elif isinstance(default, bool):
            updates[field] = _as_bool(val)
        elif isinstance(default, int):
            updates[field] = int(val)
        elif isinstance(default, float):
            updates[field] = float(val)
        elif isinstance(default, str):
            updates[field] = str(val)
        else:
            # tuple / nested-dataclass fields take the explicit spellings
            # above (grid_samples, r, control_min, dwa_*, wheel_radius, ...)
            dropped.append(key)
    if dropped:
        warnings.warn(f"load_yaml_config ignored unknown keys: {sorted(map(str, dropped))}",
                      stacklevel=2)

    return cfg.replace(**updates).validate()
