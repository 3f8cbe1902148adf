"""K1, the fused replan kernel: one whole tick per scenario on the card.

Port of ``ergodic_exploration_tpu/ops/solve_kernel.py`` (its Pallas kernels
``fused_solve_safety`` / ``fused_solve``, built by ``_fused_call`` /
``_make_kernel``, and the standalone ``fused_safety``). In one launch
sequence per tick, for every scenario:

    GMM target refresh over the sample lattice (optional, J > 0)
    -> P x P patch of the distance map (one map shared by all scenarios, or
       each scenario's own: the JAX kernel's ``map_h = 0`` variant) + the
       patch's own gradient
    -> RK4 rollout -> cos/sin basis tables -> c_k and the metric
    -> ergodic gradient -> boundary + obstacle barrier (bilinear queries)
    -> backward co-state -> u = clip(-R^-1 B^T rho) -> ck_sum append
    -> validation of u0 + the DWA sweep (nearest-cell crash probes).

The CUDA source is ``csrc/solve_kernel.cu`` (its header comment says what
bounds it on an H100 and what the design does about that). Beside it lives
the plain PyTorch version, :func:`fused_solve_safety_plain`, with the same
inputs and outputs, made from the ported basis / patch / barrier /
collision / dwa functions; the CPU tests run it, ``chip_smoke.py`` holds
the kernel against it on the card.

Dispatch: :func:`fused_solve_safety`, :func:`fused_solve` (the tick without
validation + DWA), :func:`fused_safety` (validation + DWA alone, on a crop
given as data) and :func:`fused_safety_map` (the same on the patch's central
crop read from the map, what the eager step runs) take their plain versions
only for tensors that lie on the CPU. For CUDA tensors they launch the
kernel or raise; there is no fallback. ``K1.launches`` counts the launches
of each variant.

The history term of c_k reaches K1 in one of two forms, as in the JAX
package: (K, K) sums computed ahead of the launch (shared history draw, full
ring, accumulate), or the ``nb`` positions drawn from each scenario's ring
buffer (``history="ring"`` with ``buffer_batch`` and per-scenario draws: the
JAX kernel's ``nb > 0`` variant), whose cos tables and outer-product sums are
then computed inside the kernel. Those launches count under the variant's
name with ``_nb`` appended. The shared draw's sums and the drawn positions
come from ``glue_pre`` (ops/tick_glue.py), which with ``glue_post`` carries
the rest of the tick around K1 (:func:`replan_batched_fused`).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops.patch import gather_patch
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture, gmm_eval

NUMAX = 4  # controls the CUDA kernel holds (both models have at most 4)
ROW_CHUNK = 20  # K1's refresh: points of a lattice row a lane takes at a time (LR_YC in
#                 csrc/lattice_refresh.cuh); the rows' y samples are padded to it
REFRESH_WARPS = 16  # K1's refresh: warps (one a block) refresh_plan gives every SM
FINISH_K1 = 16  # k1_finish: k1 a lane sums at a time (LF_KT); cx's columns are padded to it
LATTICE_CHUNK = 64  # K2: lattice points per step of its tile; N is padded to it
TILE_S = 64  # K2: scenarios per block of its tile (RT_S in csrc/gmm_refresh.cuh)
SLAB = 256  # K2: coefficients a block of its tile contracts in one pass (RT_SLAB)
SOLVE_WARPS = 4  # warps (scenarios) a block of k1_solve holds
HIST_CHUNK, SERIES = 32, 18  # k1_solve: drawn positions a chunk; per-step arrays of a warp
BLOCK_SERIES, TILE = 12, 4  # k1_solve_block: per-step arrays; a thread's c_k outputs, TILE^2
BLOCK_THREADS = (32, 64, 128)  # k1_solve_block's instances: threads a block (one scenario)
BLOCK_CHUNKS = (64, 32, 16)  # k1_solve_block: knots a chunk of its tables, past the whole horizon
# warps of k1_solve_block an SM holds by its registers (ptxas: 119 a thread,
# allocated in eights: 65536 // (120 * 32)); blocks an SM holds at most;
# the shared memory of an SM, of which each block's hardware reserve is 1 KB
BLOCK_REG_WARPS, SM_BLOCKS, SM_SMEM = 17, 32, 233472
MAX_SMEM = 232448  # dynamic shared memory one block can have on sm_90 (227 KB)
# what each of n blocks on one SM can have: the SM's 228 KB split n ways, less
# the 1 KB the hardware reserves for every block
QUAD_SMEM, PAIR_SMEM = (233472 // n - 1024 for n in (4, 2))
BLOCKS_PER_SM = 2  # K2: blocks of its tile that share an SM (registers and shared memory)
MAX_RUN = 32  # K2: most chunks one block of its tile adds up before its sums go to scratch
PAD_POINT = 1.0e6  # pad points sit far away: phi underflows to exactly 0


@dataclass(frozen=True)
class SolveParams:
    """Static parameters of the descent stage."""

    H: int
    K: int
    nu: int
    P: int  # patch cells
    dt: float
    gamma: float  # ergodic weight
    beta: float  # barrier weight
    b_eps: float
    b_weight: float  # boundary barrier weight
    o_weight: float  # obstacle barrier weight
    b_radius: float
    d_safe: float
    d_min: float
    r_diag: Tuple[float, ...]
    u_min: Tuple[float, ...]
    u_max: Tuple[float, ...]
    map_h: int = 0  # map rows
    map_w: int = 0
    per_scenario_maps: bool = False  # (S, mh, mw) maps instead of one (mh, mw)
    J: int = 0  # GMM components refreshed in-kernel (0: phik is an input)
    masked_refresh: bool = False  # free mask folded into the basis table


@dataclass(frozen=True)
class SafetyParams:
    """Static parameters of the validation + DWA stage."""

    nu: int
    Pc: int  # cropped patch cells
    b_radius: float
    d_safe: float
    val_dt: float
    val_horizon: int
    dwa_dt: float
    dwa_horizon: int
    samples: Tuple[int, int, int]
    acc_lim: Tuple[float, float, float]
    vel_lim: Tuple[float, float, float]
    model: str  # "cart" | "omni": which twist / inverse-twist formulas
    twist_k: Tuple[float, float]  # cart (r/2, r/b); omni (r/4, r/(4L))
    finv: Tuple[float, float]  # inverse twist: cart (b/2, r); omni (L, r)
    cost_space: str = "control"


def _model_finv(model):
    """Static constants of the models' twist, from_twist and B, as those
    methods round them: K1 evaluates the models' own formulas so that its
    rollout knots and safety probes match the plain version bit for bit."""
    from ergodic_exploration_tpu_torch.models.cart import Cart
    from ergodic_exploration_tpu_torch.models.omni import Omni

    if isinstance(model, Cart):
        r, b = model.wheel_radius, model.wheel_base
        return "cart", (0.5 * r, r / b), (0.5 * b, r)
    if isinstance(model, Omni):
        r = model.wheel_radius
        L = model.lx + model.ly
        return "omni", (0.25 * r, 0.25 * r / L), (L, r)
    raise TypeError(f"fused safety supports cart/omni, got {type(model)!r}")


def params_from_config(cfg, P: int, map_hw=(0, 0), J: int = 0,
                       masked: bool = False, per_scenario_maps: bool = False) -> SolveParams:
    return SolveParams(
        H=cfg.horizon, K=cfg.num_basis, nu=cfg.nu, P=P, dt=cfg.dt,
        gamma=cfg.ergodic_weight, beta=cfg.barrier_weight, b_eps=cfg.barrier_eps,
        b_weight=cfg.barrier_boundary_weight, o_weight=cfg.barrier_obstacle_weight,
        b_radius=cfg.boundary_radius, d_safe=cfg.d_safe, d_min=0.03,
        r_diag=tuple(cfg.r_diag), u_min=tuple(cfg.u_min), u_max=tuple(cfg.u_max),
        map_h=map_hw[0], map_w=map_hw[1], per_scenario_maps=per_scenario_maps, J=J,
        masked_refresh=masked,
    )


def safety_params_from_config(cfg, crop_cells: int) -> SafetyParams:
    from ergodic_exploration_tpu_torch.models import make_model

    kind, twist_k, finv = _model_finv(make_model(cfg))
    return SafetyParams(
        nu=cfg.nu, Pc=crop_cells, b_radius=cfg.boundary_radius, d_safe=cfg.d_safe,
        val_dt=cfg.val_dt, val_horizon=cfg.val_horizon, dwa_dt=cfg.dwa.dt,
        dwa_horizon=cfg.dwa.horizon, samples=tuple(cfg.dwa.samples),
        acc_lim=tuple(cfg.dwa.acc_lim), vel_lim=tuple(cfg.dwa.vel_lim),
        model=kind, twist_k=twist_k, finv=finv, cost_space=cfg.dwa.cost_space,
    )


class Refresh(NamedTuple):
    """Operands of the in-kernel GMM target refresh (J > 0): the mixtures
    and the :class:`Lattice`'s fields. The kernel reads the separable ones
    (xs to mask); the plain version reads pts and D."""

    gmm: GaussianMixture  # means (S, J, 2), covs (S, J, 2, 2), weights (S, J)
    pts: torch.Tensor  # (Npad, 2) shared lattice, padded with PAD_POINT
    D: torch.Tensor  # (Npad, K^2) dense basis table, mask folded, pad rows 0
    mask_ck: torch.Tensor  # (K^2,) degenerate-target fallback
    xs: torch.Tensor  # (nsx,) x samples: the lattice's rows
    ys: torch.Tensor  # (nsy,) y samples padded to ROW_CHUNK with PAD_POINT
    cx: torch.Tensor  # (nsx, finish_cx_cols(K)) x cosines, pad columns 0
    cy: torch.Tensor  # (K rounded up to 2, nsy) y cosines by coefficient, pads 0
    hk: torch.Tensor  # (K^2,) h_k
    mask: Optional[torch.Tensor]  # (nsx, nsy) shared free mask, pad columns 0; or None
    masked: bool  # free mask folded into D (renormalize by k = (0, 0))


class K1Inputs(NamedTuple):
    """Scenario-first operands of K1 (all float32 unless noted)."""

    x: torch.Tensor  # (S, 3) poses
    U: torch.Tensor  # (S, H, nu) warm-started controls
    hist: torch.Tensor  # (S, K^2) history sums of F_k (divided by h_k), or the
    #                     (S, nb, 2) drawn positions they are to be summed over
    nh: torch.Tensor  # (S,) history state count
    phik: Optional[torch.Tensor]  # (S, K^2) targets, or None with ``refresh``
    refresh: Optional[Refresh]
    dist: torch.Tensor  # (mh, mw) shared distance map (or (S, H, W) maps)
    pstart: torch.Tensor  # (S, 2) int (ix, iy) global cell of patch cell (0, 0)
    porigin: torch.Tensor  # (S, 2) map origin
    pres: torch.Tensor  # (S,) map resolution
    dorigin: torch.Tensor  # (S, 2) domain origin
    dlen: torch.Tensor  # (S, 2) domain lengths
    cks: torch.Tensor  # (S, K^2) running basis sum
    vb: torch.Tensor  # (S, 3) body twists (DWA window centres)


class K1Outputs(NamedTuple):
    U_new: torch.Tensor  # (S, H, nu)
    metric: torch.Tensor  # (S,)
    barrier: torch.Tensor  # (S,) mean barrier value along the horizon
    ck_sum: torch.Tensor  # (S, K^2)
    code: Optional[torch.Tensor]  # (S,) int32 validation code of u0
    u_dwa: Optional[torch.Tensor]  # (S, nu)
    feasible: Optional[torch.Tensor]  # (S,) int32


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def refresh_plain(r: Refresh, dlen: torch.Tensor) -> torch.Tensor:
    """phi_k (S, K^2) from the GMM over the lattice: acc = phi @ D and
    tot = sum(phi), then (masked) ck = acc / (h00 acc_00) or (unmasked)
    ck = acc / tot, falling back to ``mask_ck`` for a target with no mass
    (engine._phik_from_gmm_fn's shared-map fold, tot cancelled)."""
    phi = gmm_eval(r.pts, r.gmm)  # (S, Npad)
    tot = phi.sum(dim=-1, keepdim=True)
    acc = torch.matmul(phi, r.D)
    if r.masked:
        h00 = torch.sqrt(dlen[:, 0:1] * dlen[:, 1:2])
        a00 = h00 * acc[:, 0:1]
        ok = (tot > 1e-12) & (a00 / torch.clamp(tot, min=1e-12) > 1e-12)
        ck = acc / torch.clamp(a00, min=1e-30)
    else:
        ok = tot > 1e-12
        ck = acc / torch.clamp(tot, min=1e-12)
    return torch.where(ok, ck, r.mask_ck)


def fused_solve_safety_plain(cfg, inp: K1Inputs, enable_safety: bool = True) -> K1Outputs:
    """K1's plain PyTorch version (same inputs and outputs as the kernel)."""
    from ergodic_exploration_tpu_torch.controller import descent, drawn_history_sums, safety
    from ergodic_exploration_tpu_torch.models import make_model

    model = make_model(cfg)
    S = inp.x.shape[0]
    K = cfg.num_basis
    mh, mw = inp.dist.shape[-2:]
    P = min(cfg.patch_cells, mh, mw)
    phik = inp.phik if inp.refresh is None else refresh_plain(inp.refresh, inp.dlen)
    patch = gather_patch(inp.dist, inp.pstart.to(torch.int64), P, inp.porigin, inp.pres)
    domain = Domain(inp.dorigin, inp.dlen)
    lam = basis.lambda_weights(K, device=inp.x.device)
    hk = basis.hk_norm(K, inp.dlen)
    hist = inp.hist.view(S, K, K) if inp.hist.dim() == 2 else drawn_history_sums(
        inp.hist, inp.nh, K, domain, hk)
    U_new, metric, bcost = descent(cfg, model, inp.x, inp.U, hist, inp.nh,
                                   phik.view(S, K, K), domain, patch, lam, hk)
    Cnx, Cny = basis.cos_tables(inp.x[:, None, :2], K, domain)
    ck_sum = inp.cks + basis.coefficients_cos(Cnx, Cny, torch.ones_like(inp.x[:, :1]),
                                              hk).view(S, K * K)
    code = u_dwa = feasible = None
    if enable_safety:
        code, u_dwa, feas = safety(cfg, model, inp.x, inp.vb, U_new[:, 0], domain, patch)
        feasible = feas.to(torch.int32)
    return K1Outputs(U_new, metric, bcost, ck_sum, code, u_dwa, feasible)


def crop_geometry(cfg, dist: torch.Tensor):
    """(P, Pc): the patch's cells on maps ``dist`` (..., mh, mw) and its
    central safety crop's."""
    P = min(cfg.patch_cells, *dist.shape[-2:])
    return P, min(cfg.safety_patch_cells, P)


def fused_safety_map_plain(cfg, x, vb, U_new, dist, pstart, porigin, pres, dorigin, dlen):
    """The safety stage on the central crop of each scenario's patch, its
    plain version: the crop gathered from the maps ``dist`` ((mh, mw) shared
    or (S, mh, mw)) at ``pstart + (P - Pc) // 2`` (``patch.gather_window``,
    cells past the edge clamped) and :func:`fused_safety_plain` on it, for
    u0 = ``U_new[:, 0]`` of the descent's (S, H, nu) controls."""
    from ergodic_exploration_tpu_torch.ops.patch import gather_window

    P, Pc = crop_geometry(cfg, dist)
    cstart = pstart + (P - Pc) // 2
    return fused_safety_plain(cfg, x, vb, U_new[:, 0].contiguous(),
                              gather_window(dist, cstart, Pc), cstart, porigin, pres, dorigin,
                              dlen)


def fused_safety_plain(cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen):
    """The standalone safety stage's plain version: ``controller.safety_on_crop``
    on a :class:`PatchField` of the crop (S, Pc, Pc) given as data. Returns
    (code (S,) int32, u_dwa (S, nu), feasible (S,) int32)."""
    from ergodic_exploration_tpu_torch.controller import safety_on_crop
    from ergodic_exploration_tpu_torch.models import make_model
    from ergodic_exploration_tpu_torch.ops.patch import PatchField

    field = PatchField(dist=crop, grad=None, start=pstart.to(torch.int64), origin=porigin,
                       resolution=pres)
    code, u_dwa, feas = safety_on_crop(cfg, make_model(cfg), x, vb, u0, Domain(dorigin, dlen),
                                       field)
    return code, u_dwa, feas.to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel: parameter block, buffers, build and launch
# ---------------------------------------------------------------------------

_F4 = ctypes.c_float * 4
_F3 = ctypes.c_float * 3


class _Params(ctypes.Structure):
    """Mirror of ``struct K1Params`` in csrc/solve_kernel.cu. Float fields
    hold the Python (double) constants rounded to float32, as PyTorch's
    scalar ops round them."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "H", "K", "nu", "P", "Pc", "J", "nsx", "nsy", "map_h", "map_w", "masked", "model",
        "cost_twist", "val_horizon", "dwa_horizon", "nvx", "nvy", "nw", "map_stride",
        "safety", "nb", "nband", "band_rows", "global_tables", "block_threads",
        "chunk", "crop_from_map", "crop_offset")] + [
        (n, ctypes.c_float) for n in (
            "dt", "half_dt", "dt6", "gamma", "beta", "b_eps", "b_weight", "b_weight2",
            "o_weight", "o_weight_m2", "b_radius", "d_safe", "inv_d_safe", "d_min",
            "patch_hi", "crop_hi", "tw_a", "tw_b", "inv_a", "inv_r", "val_dt", "dwa_dt",
            "two_pi")] + [
        ("r_inv", _F4), ("u_min", _F4), ("u_max", _F4), ("acc_dt", _F3), ("vel_lim", _F3)]


_BUFFERS = ("x", "U", "hist", "nh", "phik", "means", "covs", "weights", "xs", "ys", "cx",
            "cy", "hk", "mask", "mask_ck", "dist", "pstart", "porigin", "pres", "dorigin",
            "dlen", "cks", "vb", "U_new", "metric", "bcost", "ck_out", "code", "u_dwa",
            "feasible", "phik_buf", "row_sums", "solve_ws")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct K1Buffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


def lattice_split(S: int, n_chunks: int, sm_count: int, slabs: int = 1):
    """(number of lattice splits, chunks per split) of K2's grid (it lives
    here beside K1's :func:`refresh_plan`). The grid is ceil(S / TILE_S) scenario tiles x
    splits x ``slabs`` blocks, of which BLOCKS_PER_SM * sm_count run at a
    time: the splits fill whole rounds of those (one scenario would otherwise
    be one block walking every chunk, and a round that is partly filled costs
    a whole one), with at most MAX_RUN chunks a split and one split per
    chunk."""
    tiles = -(-S // TILE_S) * slabs
    slots = BLOCKS_PER_SM * sm_count
    least = -(-n_chunks // MAX_RUN)  # splits that MAX_RUN asks for
    rounds = max(1, -(-least * tiles // slots))
    want = max(1, min(n_chunks, max(least, rounds * slots // tiles)))
    per = -(-n_chunks // want)
    return -(-n_chunks // per), per


def slab_blocks(KK: int) -> int:
    """Blocks on the z axis of K2's grid for K^2 = KK: one per slab of SLAB
    coefficients (``refresh_slabs`` in csrc/gmm_refresh.cuh)."""
    return -(-KK // SLAB)


def finish_cx_cols(K: int) -> int:
    """Columns of the refresh's cx table: K rounded up to the FINISH_K1 k1
    that a lane of k1_finish sums at a time (``lf_cx_cols`` in
    csrc/lattice_refresh.cuh)."""
    return -(-K // FINISH_K1) * FINISH_K1


class RefreshPlan(NamedTuple):
    """How K1's refresh shares out its work: ``nband`` bands of
    ``band_rows`` of the lattice's rows (the last may be shorter), a warp of
    ``k1_refresh`` a band of 32 scenarios. (``k1_finish`` takes its 4
    parts of the rows a warp each, whatever S is.)"""

    nband: int
    band_rows: int


def refresh_plan(S: int, nsx: int, sm_count: int) -> RefreshPlan:
    """How K1's refresh shares out S scenarios on a lattice of ``nsx`` rows
    on a card of ``sm_count`` SMs: the fewest row bands that give every SM
    ``REFRESH_WARPS`` warps, cut into near-equal parts, and at most a band a
    row (S = 4096 on 100 rows takes 17 bands of 6, S = 1 a band a row). It
    moves no bit of the result: a row's sums have one order whatever band
    takes it."""
    groups = -(-S // 32)
    nband = min(nsx, -(-REFRESH_WARPS * sm_count // groups))
    rows = -(-nsx // nband)
    return RefreshPlan(-(-nsx // rows), rows)


def solve_warp_floats(K: int, H: int, nb: int) -> int:
    """Floats of one warp's tables of k1_solve (``solve_warp_floats`` in
    csrc/solve_kernel.cu): Wh and the history sums (K^2 each), the four
    cos / sin tables of the knots (H K each), a scratch of the largest of
    the two gradient contractions, the metric terms and a chunk of history
    tables, SERIES arrays of H and the first controls."""
    scratch = max(2 * H * K, K * K, 2 * K * HIST_CHUNK if nb > 0 else 0)
    return K * K * (2 if nb > 0 else 1) + 4 * H * K + scratch + SERIES * H + NUMAX


def block_row_stride(n: int) -> int:
    """Row stride of k1_solve_block's tables of n values (``block_row_stride``
    in csrc/solve_kernel.cu): a multiple of 4 whose quarter is odd."""
    s = -(-n // 4) * 4
    return s if (s // 4) % 2 else s + 4


def block_floats(K: int, H: int, nb: int, chunk: int) -> int:
    """Floats of one block's shared memory of k1_solve_block (``block_floats``
    in csrc/solve_kernel.cu): the x and y cos tables of ``chunk`` knots (or
    of a chunk of drawn positions, in the same place), Wh and its transpose
    (rows of K rounded up to 8), BLOCK_SERIES arrays of H, the first controls,
    the history sums / metric terms (K^2) and the knot-0 tables."""
    ts = block_row_stride(chunk)
    if nb > 0:
        ts = max(ts, block_row_stride(HIST_CHUNK))
    return 2 * K * ts + 2 * K * (-(-K // 8) * 8) + BLOCK_SERIES * H + NUMAX + K * K + 2 * K


class SolveLayout(NamedTuple):
    """Where k1_solve holds a scenario's tables: ``"warp"``, a warp a
    scenario with its tables in shared memory (``k1_solve<false>``);
    ``"block"``, a block of ``threads`` a scenario with the cos tables of
    ``chunk`` knots at a time in shared memory (``k1_solve_block``);
    ``"global"``, a warp a scenario with its tables in a global workspace
    (``k1_solve<true>``)."""

    form: str
    threads: int = 0
    chunk: int = 0


def block_threads(K: int, S: int, sm_count: int) -> int:
    """Threads of k1_solve_block's block for K coefficients a side and S
    scenarios: the fewest of BLOCK_THREADS that give every tile of c_k's
    outputs a thread and the card 16 warps an SM."""
    want = max((-(-K // TILE)) ** 2, 16 * 32 * sm_count // max(S, 1))
    return next((n for n in BLOCK_THREADS if n >= want), BLOCK_THREADS[-1])


def block_occupancy(threads: int, nbytes: int) -> int:
    """Blocks of k1_solve_block an SM holds: by registers, by shared memory
    (``nbytes`` a block) and by the hardware's limit."""
    return min(SM_BLOCKS, BLOCK_REG_WARPS // (threads // 32), SM_SMEM // (nbytes + 1024))


def block_layout(K: int, H: int, nb: int, max_smem: int, S: int,
                 sm_count: int) -> Optional[SolveLayout]:
    """The block form within ``max_smem`` bytes a block: of the whole
    horizon and the BLOCK_CHUNKS that give every thread a job of the
    gradient (two a knot), the largest chunk of knots whose tables let an SM
    hold as many blocks as any of them (a chunk short of the horizon builds
    the tables again for the gradient; a block more an SM hides more of the
    serial stretches); None where no chunk fits."""
    threads = block_threads(K, S, sm_count)
    fits = [(c, block_occupancy(threads, 4 * block_floats(K, H, nb, c)))
            for c in dict.fromkeys(min(c, H) for c in (H,) + BLOCK_CHUNKS)
            if (c == H or 2 * c >= threads) and 4 * block_floats(K, H, nb, c) <= max_smem]
    if not fits:
        return None
    most = max(n for _, n in fits)
    return SolveLayout("block", threads, next(c for c, n in fits if n == most))


def solve_layout(K: int, H: int, nb: int, max_smem: int = MAX_SMEM, S: int = 4096,
                 sm_count: int = 132) -> SolveLayout:
    """k1_solve's layout for (K, H, nb) and S scenarios on a device of
    ``sm_count`` SMs whose blocks may opt in to ``max_smem`` bytes of shared
    memory. The warp form where the tables of a block of SOLVE_WARPS fit four
    such blocks on an SM (QUAD_SMEM); past that the block form
    (:func:`block_layout`); past a block's shared memory the global tables.
    Phase 21 of chip_smoke.py times the three on an H100 (PERF.md section
    6): at every shape past the warp form that it drives, the block form
    was the fastest."""
    if SOLVE_WARPS * 4 * solve_warp_floats(K, H, nb) <= min(max_smem, QUAD_SMEM):
        return SolveLayout("warp")
    return block_layout(K, H, nb, max_smem, S, sm_count) or SolveLayout("global")


def _c_params(sp: SolveParams, sps: SafetyParams, S: int, lattice=(0, 0),
              safety: bool = True, nb: int = 0, plan=RefreshPlan(1, 0),
              tables_global: bool = False, block=(0, 0)) -> _Params:
    """``lattice``: (rows, padded columns) of the refresh's lattice; ``plan``:
    its :class:`RefreshPlan`; ``tables_global``: k1_solve's tables in the
    global workspace; ``block``: (threads, chunk) of k1_solve_block, (0, 0)
    for the warp forms."""
    p = _Params()
    ints = dict(S=S, H=sp.H, K=sp.K, nu=sp.nu, P=sp.P, Pc=sps.Pc, J=sp.J, nsx=lattice[0],
                nsy=lattice[1],
                map_h=sp.map_h, map_w=sp.map_w, masked=int(sp.masked_refresh),
                model=0 if sps.model == "cart" else 1,
                cost_twist=int(sps.cost_space == "twist"), val_horizon=sps.val_horizon,
                dwa_horizon=sps.dwa_horizon, nvx=sps.samples[0], nvy=sps.samples[1],
                nw=sps.samples[2],
                map_stride=sp.map_h * sp.map_w if sp.per_scenario_maps else 0,
                safety=int(safety), nb=nb, **plan._asdict(), global_tables=int(tables_global),
                block_threads=block[0], chunk=block[1])
    floats = dict(
        dt=sp.dt, half_dt=0.5 * sp.dt, dt6=sp.dt / 6.0, gamma=sp.gamma, beta=sp.beta,
        b_eps=sp.b_eps, b_weight=sp.b_weight, b_weight2=2.0 * sp.b_weight,
        o_weight=sp.o_weight, o_weight_m2=-2.0 * sp.o_weight, b_radius=sp.b_radius,
        d_safe=sp.d_safe, inv_d_safe=1.0 / sp.d_safe, d_min=sp.d_min,
        patch_hi=sp.P - 1.001, crop_hi=sps.Pc - 1.001, tw_a=sps.twist_k[0],
        tw_b=sps.twist_k[1], inv_a=sps.finv[0], inv_r=sps.finv[1], val_dt=sps.val_dt,
        dwa_dt=sps.dwa_dt, two_pi=2.0 * math.pi)
    for k, v in {**ints, **floats}.items():
        setattr(p, k, v)
    pad = (0.0,) * (NUMAX - sp.nu)
    # 1 / float32(r), as ``1.0 / torch.tensor(cfg.r_diag)`` rounds it
    p.r_inv = _F4(*(1.0 / float(ctypes.c_float(r).value) for r in sp.r_diag), *pad)
    p.u_min = _F4(*sp.u_min, *pad)
    p.u_max = _F4(*sp.u_max, *pad)
    p.acc_dt = _F3(*(a * sps.dwa_dt for a in sps.acc_lim))
    p.vel_lim = _F3(*sps.vel_lim)
    return p


def _check_operands(what: str, ops: dict, shapes: dict, dev, ints=("pstart",)) -> None:
    """Raise unless every operand is a contiguous tensor of its shape and
    type (int32 for those named in ``ints``, float32 otherwise) on ``dev``."""
    for n, shape in shapes.items():
        t = ops[n]
        want = torch.int32 if n in ints else torch.float32
        if (t.device != dev or t.dtype != want or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{what} operand {n}: need contiguous {want} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _require_cuda(dev, what: str) -> None:
    """Raise unless ``dev`` is a CUDA device: a kernel launches nowhere else."""
    if dev.type != "cuda":
        raise ValueError(f"the {what} takes CUDA tensors, got {dev}")


def _sm_count(dev) -> int:
    """Streaming multiprocessors of the CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream_of(dev) -> int:
    """Handle of PyTorch's current stream on the CUDA device ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


def launch_on(dev, fn, params, bufs) -> int:
    """Call the library's launcher ``fn(params, buffers, stream)`` with
    ``dev`` the current CUDA device for the call, and return its CUDA error
    code. The runtime launches on its current device whatever device the
    pointers and the stream belong to, so a process whose tensors live on
    ``cuda:1`` while its current device is 0 would launch into the wrong
    context. Every wrapper of the three libraries launches through here."""
    with torch.cuda.device(dev):
        return fn(ctypes.byref(params), ctypes.byref(bufs), _stream_of(dev))


class SubLaunches:
    """Launches of a part of K1 by kind (``launches[kind]``), kept apart from
    the counts by variant, which stay as they were; graph replays add to
    them as to those (``utils/graphs.kernel_wrappers``)."""

    def __init__(self, kinds):
        self.kinds = tuple(kinds)
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {k: 0 for k in self.kinds}


class FusedSolveSafety:
    """The K1 wrapper: builds ``csrc/solve_kernel.cu`` on first use and
    counts its launches per variant (``launches[variant]`` grows by one per
    launch of that variant, nowhere else)."""

    SOLVE_VARIANTS = ("fused_solve_safety", "fused_solve_safety_map_h0", "fused_solve",
                      "fused_solve_map_h0")
    VARIANTS = SOLVE_VARIANTS + tuple(v + "_nb" for v in SOLVE_VARIANTS) + (
        "fused_safety", "fused_safety_map")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.launches = {}
        self.forms = SubLaunches(("warp", "block", "global"))  # k1_solve's by layout
        # the refresh's (k1_refresh + k1_finish), in a tick (J > 0) or alone (refresh())
        self.refreshes = SubLaunches(("tick", "alone"))
        self._scratch = {}  # (device, nsx, K, S) -> the refresh's scratch
        self._workspace = {}  # (device, floats) -> k1_solve's global tables
        self._optin = {}  # device -> bytes of shared memory a block may opt in to
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}
        self.forms.reset_launches()
        self.refreshes.reset_launches()

    def refresh_scratch(self, dev, nsx: int, K: int, S: int) -> torch.Tensor:
        """The refresh's scratch, (groups of 32 scenarios, nsx, K + 1, 32):
        the K y sums and the tot of every row, a column a scenario
        (csrc/lattice_refresh.cuh), allocated once per shape and reused by
        every later launch (launches on one stream run in order; callers that
        launch K1 from several streams at once need a wrapper each)."""
        key = (dev, nsx, K, S)
        if key not in self._scratch:
            self._scratch[key] = torch.empty((-(-S // 32), nsx, K + 1, 32), dtype=torch.float32,
                                             device=dev)
        return self._scratch[key]

    def solve_workspace(self, dev, n: int) -> torch.Tensor:
        """``n`` floats for k1_solve's tables in global memory (where
        :func:`solve_layout` says so), allocated once per size and reused by every later launch,
        as the refresh's scratch is (a captured graph keeps its pointer)."""
        key = (dev, n)
        if key not in self._workspace:
            self._workspace[key] = torch.empty((n,), dtype=torch.float32, device=dev)
        return self._workspace[key]

    def smem_optin(self, dev) -> int:
        """Bytes of dynamic shared memory a block may opt in to on ``dev``,
        as the library reads it from the device (once per device)."""
        if dev not in self._optin:
            with torch.cuda.device(dev):
                self._optin[dev] = int(self.build().lib.k1_smem_optin())
        return self._optin[dev]

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("solve_kernel", LIBRARIES["solve_kernel"])
            for fn in (built.lib.k1_fused_solve_safety, built.lib.k1_fused_safety,
                       built.lib.k1_refresh_phik):
                fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers),
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            built.lib.k1_smem_optin.argtypes = []
            built.lib.k1_smem_optin.restype = ctypes.c_int
            self.built = built
        return self.built

    def _launch(self, fn_name: str, variant: Optional[str], params: _Params, ops: dict,
                dev) -> None:
        """Call the library's ``fn_name``; a launch of a variant is counted."""
        bufs = _Buffers(**{n: (t.data_ptr() if t is not None else None)
                           for n, t in ops.items()})
        err = launch_on(dev, getattr(self.build().lib, fn_name), params, bufs)
        if err != 0:
            raise RuntimeError(f"K1 {variant or fn_name} launch failed: CUDA error {err}")
        if variant is not None:
            self.launches[variant] += 1

    def _refresh_operands(self, r: Refresh, dlen, K: int, dev):
        """Checked operands of the refresh with its scratch, the lattice's
        (rows, padded columns) and its :class:`RefreshPlan`."""
        S, J = r.gmm.weights.shape
        nsx, nsy = r.xs.shape[0], r.ys.shape[0]
        if nsy % ROW_CHUNK:
            raise ValueError(f"lattice rows of {nsy} points are not padded to {ROW_CHUNK}")
        if r.masked != (r.mask is not None):
            raise ValueError("the refresh is masked exactly where it has a mask")
        ops = dict(means=r.gmm.means, covs=r.gmm.covs, weights=r.gmm.weights, xs=r.xs, ys=r.ys,
                   cx=r.cx, cy=r.cy, hk=r.hk, mask_ck=r.mask_ck, dlen=dlen)
        shapes = dict(means=(S, J, 2), covs=(S, J, 2, 2), weights=(S, J), xs=(nsx,), ys=(nsy,),
                      cx=(nsx, finish_cx_cols(K)), cy=(-(-K // 2) * 2, nsy), hk=(K * K,),
                      mask_ck=(K * K,), dlen=(S, 2))
        if r.mask is not None:
            ops["mask"], shapes["mask"] = r.mask, (nsx, nsy)
        _check_operands("K1", ops, shapes, dev)
        plan = refresh_plan(S, nsx, _sm_count(dev))
        ops["row_sums"] = self.refresh_scratch(dev, nsx, K, S)
        return ops, (nsx, nsy), plan

    def refresh(self, r: Refresh, dlen: torch.Tensor) -> torch.Tensor:
        """The in-kernel refresh alone (``k1_refresh`` + ``k1_finish``):
        phi_k (S, K^2) as :func:`refresh_plain` defines it. Not a variant of
        the tick: it exists to time and check the refresh apart from the
        solve, and is counted apart (``refreshes.launches["alone"]``)."""
        dev = dlen.device
        _require_cuda(dev, "K1 refresh")
        KK = r.hk.shape[0]
        K = math.isqrt(KK)
        ops, (nsx, nsy), plan = self._refresh_operands(r, dlen, K, dev)
        S, J = r.gmm.weights.shape
        ops["phik_buf"] = out = torch.empty((S, KK), dtype=torch.float32, device=dev)
        p = _Params(S=S, K=K, J=J, nsx=nsx, nsy=nsy, masked=int(r.masked), **plan._asdict())
        self._launch("k1_refresh_phik", None, p, ops, dev)
        self.refreshes.launches["alone"] += 1
        return out

    def __call__(self, cfg, inp: K1Inputs, enable_safety: bool = True) -> K1Outputs:
        dev = inp.x.device
        _require_cuda(dev, "K1 kernel")
        S, H, nu = inp.U.shape
        K = cfg.num_basis
        if nu > NUMAX:
            raise ValueError(f"K1 supports nu <= {NUMAX}")
        per_scenario = inp.dist.dim() == 3
        if inp.dist.dim() not in (2, 3):
            raise ValueError(f"K1 dist: need (mh, mw) or (S, mh, mw), got "
                             f"{tuple(inp.dist.shape)}")
        if inp.hist.dim() not in (2, 3):
            raise ValueError(f"K1 hist: need (S, K^2) sums or (S, nb, 2) drawn positions, got "
                             f"{tuple(inp.hist.shape)}")
        nb = inp.hist.shape[1] if inp.hist.dim() == 3 else 0
        mh, mw = inp.dist.shape[-2:]
        P = min(cfg.patch_cells, mh, mw)
        r = inp.refresh
        J = 0 if r is None else r.gmm.means.shape[1]
        sp = params_from_config(cfg, P, (mh, mw), J, bool(r is not None and r.masked),
                                per_scenario)
        sps = safety_params_from_config(cfg, min(cfg.safety_patch_cells, P))

        f32, i32 = torch.float32, torch.int32
        kw = dict(device=dev)
        out = K1Outputs(
            U_new=torch.empty((S, H, nu), dtype=f32, **kw),
            metric=torch.empty((S,), dtype=f32, **kw),
            barrier=torch.empty((S,), dtype=f32, **kw),
            ck_sum=torch.empty((S, K * K), dtype=f32, **kw),
            code=torch.empty((S,), dtype=i32, **kw) if enable_safety else None,
            u_dwa=torch.empty((S, nu), dtype=f32, **kw) if enable_safety else None,
            feasible=torch.empty((S,), dtype=i32, **kw) if enable_safety else None,
        )
        phik_buf = torch.empty((S, K * K), dtype=f32, **kw) if r is not None else None
        shapes = dict(x=(S, 3), U=(S, H, nu), hist=(S, nb, 2) if nb else (S, K * K), nh=(S,),
                      dist=(S, mh, mw) if per_scenario else (mh, mw),
                      pstart=(S, 2), porigin=(S, 2), pres=(S,), dorigin=(S, 2),
                      dlen=(S, 2), cks=(S, K * K), vb=(S, 3))
        ops = {n: getattr(inp, n) for n in shapes}
        lattice, plan = (0, 0), RefreshPlan(1, 0)
        if r is None:
            shapes["phik"], ops["phik"] = (S, K * K), inp.phik
        _check_operands("K1", ops, shapes, dev)
        if r is not None:
            r_ops, lattice, plan = self._refresh_operands(r, inp.dlen, K, dev)
            ops.update(r_ops)
        layout = solve_layout(K, H, nb, self.smem_optin(dev), S, _sm_count(dev))
        if layout.form == "global":
            ops["solve_ws"] = self.solve_workspace(dev, S * solve_warp_floats(K, H, nb))
        ops.update(U_new=out.U_new, metric=out.metric, bcost=out.barrier, ck_out=out.ck_sum,
                   code=out.code, u_dwa=out.u_dwa, feasible=out.feasible, phik_buf=phik_buf)
        self._launch("k1_fused_solve_safety", k1_variant(enable_safety, per_scenario, nb > 0),
                     _c_params(sp, sps, S, lattice, enable_safety, nb, plan,
                               layout.form == "global", (layout.threads, layout.chunk)), ops,
                     dev)
        self.forms.launches[layout.form] += 1
        if r is not None:
            self.refreshes.launches["tick"] += 1
        return out

    def safety(self, cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen):
        """Launch the standalone safety kernel (``fused_safety``)."""
        dev = x.device
        _require_cuda(dev, "fused_safety kernel")
        S, nu = u0.shape
        Pc = crop.shape[-1]
        if nu > NUMAX:
            raise ValueError(f"fused_safety supports nu <= {NUMAX}")
        shapes = dict(x=(S, 3), vb=(S, 3), U=(S, nu), dist=(S, Pc, Pc), pstart=(S, 2),
                      porigin=(S, 2), pres=(S,), dorigin=(S, 2), dlen=(S, 2))
        ops = dict(x=x, vb=vb, U=u0, dist=crop, pstart=pstart, porigin=porigin, pres=pres,
                   dorigin=dorigin, dlen=dlen)
        _check_operands("fused_safety", ops, shapes, dev)
        code = torch.empty((S,), dtype=torch.int32, device=dev)
        u_dwa = torch.empty((S, nu), dtype=torch.float32, device=dev)
        feasible = torch.empty((S,), dtype=torch.int32, device=dev)
        ops.update(code=code, u_dwa=u_dwa, feasible=feasible)
        sp = params_from_config(cfg, Pc, (Pc, Pc), per_scenario_maps=True)
        self._launch("k1_fused_safety", "fused_safety",
                     _c_params(sp, safety_params_from_config(cfg, Pc), S), ops, dev)
        return code, u_dwa, feasible

    def safety_map(self, cfg, x, vb, U_new, dist, pstart, porigin, pres, dorigin, dlen):
        """Launch the safety stage on the patch's central crop read from the
        map (``fused_safety_map``; see :func:`fused_safety_map_plain`)."""
        dev = x.device
        _require_cuda(dev, "fused_safety_map kernel")
        S, H, nu = U_new.shape
        if nu > NUMAX:
            raise ValueError(f"fused_safety_map supports nu <= {NUMAX}")
        per_scenario = dist.dim() == 3
        if dist.dim() not in (2, 3):
            raise ValueError(f"fused_safety_map dist: need (mh, mw) or (S, mh, mw), got "
                             f"{tuple(dist.shape)}")
        mh, mw = dist.shape[-2:]
        P, Pc = crop_geometry(cfg, dist)
        shapes = dict(x=(S, 3), vb=(S, 3), U=(S, H, nu),
                      dist=(S, mh, mw) if per_scenario else (mh, mw), pstart=(S, 2),
                      porigin=(S, 2), pres=(S,), dorigin=(S, 2), dlen=(S, 2))
        ops = dict(x=x, vb=vb, U=U_new, dist=dist, pstart=pstart, porigin=porigin, pres=pres,
                   dorigin=dorigin, dlen=dlen)
        _check_operands("fused_safety_map", ops, shapes, dev)
        code = torch.empty((S,), dtype=torch.int32, device=dev)
        u_dwa = torch.empty((S, nu), dtype=torch.float32, device=dev)
        feasible = torch.empty((S,), dtype=torch.int32, device=dev)
        ops.update(code=code, u_dwa=u_dwa, feasible=feasible)
        params = _c_params(params_from_config(cfg, P, (mh, mw), per_scenario_maps=per_scenario),
                           safety_params_from_config(cfg, Pc), S)
        params.H, params.crop_from_map, params.crop_offset = H, 1, (P - Pc) // 2
        self._launch("k1_fused_safety", "fused_safety_map", params, ops, dev)
        return code, u_dwa, feasible


K1 = FusedSolveSafety()


def k1_variant(safety: bool, per_scenario_maps: bool, drawn: bool) -> str:
    """The name a K1 launch counts under: ``fused_solve_safety`` or, without
    the safety stage, ``fused_solve``; ``_map_h0`` on per-scenario maps;
    ``_nb`` with the drawn history positions summed in the kernel."""
    return (("fused_solve_safety" if safety else "fused_solve")
            + ("_map_h0" if per_scenario_maps else "") + ("_nb" if drawn else ""))


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {t.device}")
    return t.device.type == "cpu"


def fused_solve_safety(cfg, inp: K1Inputs) -> K1Outputs:
    """K1: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (raises for anything else)."""
    if _on_cpu(inp.x, "K1"):
        return fused_solve_safety_plain(cfg, inp)
    return K1(cfg, inp)


def fused_solve(cfg, inp: K1Inputs) -> K1Outputs:
    """K1 without the safety stage (``enable_safety=False``): ``code``,
    ``u_dwa`` and ``feasible`` come back as None."""
    if _on_cpu(inp.x, "K1 (fused_solve)"):
        return fused_solve_safety_plain(cfg, inp, enable_safety=False)
    return K1(cfg, inp, enable_safety=False)


def fused_safety(cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen):
    """Validation of u0 + the DWA sweep on a crop given as data: x, vb
    (S, 3), u0 (S, nu), crop (S, Pc, Pc) clearance, pstart (S, 2) int32
    global (ix, iy) of crop cell (0, 0), porigin / dorigin / dlen (S, 2),
    pres (S,). Returns (code (S,) int32, u_dwa (S, nu), feasible (S,) int32).
    The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if _on_cpu(x, "fused_safety"):
        return fused_safety_plain(cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen)
    return K1.safety(cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen)


def fused_safety_map(cfg, x, vb, U_new, dist, pstart, porigin, pres, dorigin, dlen):
    """Validation of u0 = ``U_new[:, 0]`` + the DWA sweep on the central
    ``safety_patch_cells`` crop of each scenario's patch, read from the maps
    ``dist`` ((mh, mw) shared or (S, mh, mw)) by the patch starts ``pstart``
    (S, 2) int32: the eager step's safety stage. x, vb (S, 3), U_new (S, H,
    nu), porigin / dorigin / dlen (S, 2), pres (S,). Returns (code (S,)
    int32, u_dwa (S, nu), feasible (S,) int32). The plain version (the crop
    gathered, then :func:`fused_safety_plain`) for CPU tensors, the CUDA
    kernel for CUDA tensors; both read the same cells, so their outputs are
    the same bits."""
    if _on_cpu(x, "fused_safety_map"):
        return fused_safety_map_plain(cfg, x, vb, U_new, dist, pstart, porigin, pres, dorigin,
                                      dlen)
    return K1.safety_map(cfg, x, vb, U_new, dist, pstart, porigin, pres, dorigin, dlen)


# ---------------------------------------------------------------------------
# the batched tick around K1
# ---------------------------------------------------------------------------


def pad_lattice(pts: torch.Tensor, D: torch.Tensor):
    """The lattice (N, 2) and its table (N, K^2) padded to LATTICE_CHUNK with
    far-away points (phi underflows to exactly 0 there) and zero rows."""
    pad = (-pts.shape[0]) % LATTICE_CHUNK
    if pad:
        pts = torch.cat([pts, torch.full((pad, 2), PAD_POINT, dtype=pts.dtype,
                                         device=pts.device)])
        D = torch.cat([D, D.new_zeros((pad, D.shape[1]))])
    return pts.contiguous(), D.contiguous()


class Lattice(NamedTuple):
    """The refresh's operands that depend on the geometry alone (the fields
    of :class:`Refresh` after its mixture): the shared lattice, the
    mask-folded dense basis table and the degenerate-target fallback, which
    the plain version reads, and the separable ones the kernel reads: the
    lattice's x and y samples, the per-axis cosines and h_k, the mask by
    rows."""

    pts: torch.Tensor  # (Npad, 2)
    D: torch.Tensor  # (Npad, K^2)
    mask_ck: torch.Tensor  # (K^2,)
    xs: torch.Tensor  # (nsx,)
    ys: torch.Tensor  # (nsy,) padded to ROW_CHUNK
    cx: torch.Tensor  # (nsx, finish_cx_cols(K))
    cy: torch.Tensor  # (K rounded up to 2, nsy)
    hk: torch.Tensor  # (K^2,)
    mask: Optional[torch.Tensor]  # (nsx, nsy) or None


def lattice_operands(cfg, domain: Domain, free_mask) -> Lattice:
    """The shared lattice, the mask-folded dense basis table and the fallback
    of the in-kernel refresh on the unbatched ``domain`` (with row 0 of
    ``free_mask`` folded in, or none); the lattice is padded to LATTICE_CHUNK
    with far-away points whose D rows are zero. Beside them the separable
    form the kernel reads: the x samples and the y samples (padded to
    ROW_CHUNK with far-away points), as ``pts`` holds them; the x and y
    cosines (D's own values: D is their outer product over h_k, times the
    mask), zero past K; h_k; the mask as (rows, padded columns). They depend
    on (domain, free mask, K, grid_samples) alone: the engine builds them
    once for those, outside any graph (``Engine._lattice_ops``), as the JAX
    package's jit builds them inside its trace."""
    K = cfg.num_basis
    nsx, nsy = cfg.grid_samples
    pts = domain.sample_lattice(cfg.grid_samples)  # (N, 2), x-major
    N = pts.shape[0]
    tbl = basis.tables(pts, K, domain)
    hk = basis.hk_norm(K, domain.lengths)
    D = basis.dense_table(tbl, hk)
    m1 = None
    if free_mask is not None:
        m1 = (free_mask[0] if free_mask.dim() == 2 else free_mask).to(D.dtype)  # one shared mask
        D = D * m1[:, None]
        mask_ck = D.sum(dim=0) / torch.clamp(m1.sum(), min=1.0)
    else:
        mask_ck = D.sum(dim=0) / float(N)
    pad = (-nsy) % ROW_CHUNK
    xs = pts.view(nsx, nsy, 2)[:, 0, 0]
    ys = F.pad(pts.view(nsx, nsy, 2)[0, :, 1], (0, pad), value=PAD_POINT)
    cx = F.pad(tbl.Cx.view(nsx, nsy, K)[:, 0], (0, finish_cx_cols(K) - K))
    cy = F.pad(tbl.Cy.view(nsx, nsy, K)[0].T, (0, pad, 0, K % 2))
    mask = None if m1 is None else F.pad(m1.view(nsx, nsy), (0, pad)).contiguous()
    pts, D = pad_lattice(pts, D)
    return Lattice(pts, D, mask_ck.contiguous(), xs.contiguous(), ys.contiguous(),
                   cx.contiguous(), cy.contiguous(), hk.reshape(K * K).contiguous(), mask)


def refresh_operands(cfg, gmm: GaussianMixture, domain: Domain, free_mask,
                     lattice: Optional[Lattice] = None) -> Refresh:
    """Operands of the in-kernel refresh: the mixtures with the
    :class:`Lattice` (:func:`lattice_operands`, built here when None)."""
    lat = lattice_operands(cfg, domain, free_mask) if lattice is None else lattice
    g = GaussianMixture(*(t.contiguous() for t in gmm))
    return Refresh(g, *lat, free_mask is not None)


def fused_tick_inputs(cfg, state, x, vb, phik, world, gmm=None, domain=None, lattice=None,
                      fused: bool = True):
    """The batched glue ahead of K1 (``glue_pre``: the draw key of the RNG
    split, the history draw, the orbit guard, the warm-start reset and the
    patch starts; a kernel on the card). The history reaches K1 as the sums
    of one shared draw (``shared_history_draw``, fused tick only), as each
    scenario's drawn positions (K1 sums them), as the sums over the full ring
    (``buffer_batch`` None; glue_pre sums them too) or as ``ck_sum`` itself
    (the accumulate mode, whose state count glue_pre writes). ``fused=False``:
    the inputs of the eager step (``controller.ErgodicController.step``),
    whose draws are per scenario whatever ``shared_history_draw`` says (the
    JAX step draws under ``vmap``). Returns (K1Inputs, orbiting (S,))."""
    from ergodic_exploration_tpu_torch.ops.tick_glue import PatchGeometry, glue_pre, history_mode

    S = x.shape[0]
    K = cfg.num_basis
    bdom = Domain(world.domain.origin.contiguous(), world.domain.lengths.contiguous())
    dist = world.dist
    d = dist.dist[0] if cfg.shared_maps else dist.dist
    P = min(cfg.patch_cells, *d.shape[-2:])
    x = x.contiguous()
    mode = history_mode(cfg, fused=fused)
    pre = glue_pre(cfg, mode, state.rng, state.buffer, state.U, x, bdom,
                   PatchGeometry(dist.origin.contiguous(), dist.resolution.contiguous(), P),
                   state.hist_count, state.ck_sum)
    refresh = None
    if gmm is not None:
        if not cfg.shared_maps or domain is None or domain.origin.dim() != 1:
            raise ValueError("in-kernel refresh needs cfg.shared_maps and an unbatched domain")
        refresh = refresh_operands(cfg, gmm, domain, world.free_mask, lattice)
    inp = K1Inputs(
        x=x, U=pre.U, hist=pre.hist.contiguous(), nh=pre.nh.contiguous(),
        phik=None if refresh is not None else phik.reshape(S, K * K).contiguous(),
        refresh=refresh, dist=d.contiguous(), pstart=pre.pstart,
        porigin=dist.origin.contiguous(), pres=dist.resolution.contiguous(),
        dorigin=bdom.origin, dlen=bdom.lengths,
        cks=state.ck_sum.reshape(S, K * K).contiguous(), vb=vb.contiguous(),
    )
    return inp, pre.orbiting


def replan_batched_fused(cfg, model, state, x, vb, phik, world, gmm=None, domain=None,
                         lattice=None, advance: bool = False, ring_in_place: bool = False):
    """One batched replan tick with K1 as its core — the counterpart of the
    JAX ``replan_batched_fused`` (same signature, scenario axis leading).

    With ``gmm`` + an unbatched ``domain`` in place of ``phik`` (pass
    phik=None; needs cfg.shared_maps) the GMM target refresh runs inside K1
    too, on the ``lattice`` operands (:func:`lattice_operands`, built here
    when None). Around the kernel: ``glue_pre`` before it
    (:func:`fused_tick_inputs`) and ``glue_post`` after it (the DWA select,
    the divergence guard, the warm-start shift, the ring append, the next
    keys; ``controller.finish_tick``). Returns (state, u, diag), and with
    ``advance`` also the poses one dt on and their twists (the closed loops'
    plant step, inside ``glue_post``). ``ring_in_place``: the pose is
    appended into ``state``'s ring itself (a graph's static state; see
    ``controller.finish_tick``).
    """
    from ergodic_exploration_tpu_torch.controller import finish_tick

    S, K = x.shape[0], cfg.num_basis
    inp, orbiting = fused_tick_inputs(cfg, state, x, vb, phik, world, gmm, domain, lattice)
    if cfg.enable_safety:
        out = fused_solve_safety(cfg, inp)
        safety_out = (out.code, out.u_dwa, out.feasible)
    else:
        out = fused_solve(cfg, inp)
        safety_out = None
    return finish_tick(cfg, state, inp.x, out.U_new, safety_out, out.ck_sum.view(S, K, K),
                       out.metric, out.barrier, orbiting, cfg.shared_history_draw, advance,
                       ring_in_place)
