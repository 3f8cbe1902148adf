"""G, the glue of a tick around K1: two kernels for what XLA fuses around
the JAX package's one ``pallas_call``.

The JAX package runs a tick as one ``jax.jit`` program, and XLA fuses the
work around its Pallas core (``ergodic_exploration_tpu/ops/
solve_kernel.py::replan_batched_fused``, :664-870 and the tail after the
kernel; ``controller.py::ErgodicController.step``) into a handful of
fusions. Here that work is two launches:

``glue_pre``  the RNG split's draw key, the history draw and its gather
              (mode ``"sums"``: the shared draw of the fused tick, reduced to
              the (S, K^2) sums K1 takes; ``"nb"``: each scenario's own draw,
              handed on as (S, nb, 2) positions; ``"full"``: the full ring,
              ``buffer_batch`` None, reduced to the (S, K^2) sums over each
              scenario's valid entries; ``"accumulate"``: the accumulate
              mode's state count, K1 reading ``ck_sum`` as its sums; None:
              no history), the orbit guard, the warm-start reset of U and the
              patch start;
``glue_post`` the DWA select, the divergence guard, the warm-start shift,
              the ring append, ``hist_count + 1``, the next keys and, with
              ``advance`` (the closed loops), one RK4 step of ``dt`` of the
              poses through the model's kinematics and their body twists.
              The append copies the ring, or with ``ring_in_place`` writes
              the pose into the cursor's slot of the ring itself: what the
              graph bodies pass, whose ring is a static buffer the graph
              advances (the twin of the JAX engine's donated state). Every
              other caller keeps its state: an eager call changes none of
              its inputs.

The CUDA source is ``csrc/tick_glue.cu`` (its header says what bounds it on
an H100 and its rounding contract). Beside it live the plain PyTorch
versions, :func:`glue_pre_plain` and :func:`glue_post_plain`, with the
kernels' inputs and outputs: the CPU tests run them, ``chip_smoke.py`` holds
the kernels against them on the card.

Dispatch: :func:`glue_pre` and :func:`glue_post` take their plain versions
only for tensors that lie on the CPU. For CUDA tensors they launch the kernel
or raise; there is no fallback. ``G.launches`` counts the launches of each
variant.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ergodic_exploration_tpu_torch.grid import Domain
from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.ops.collision import CRASH
from ergodic_exploration_tpu_torch.ops.patch import patch_start
from ergodic_exploration_tpu_torch.ops.solve_kernel import _on_cpu, _require_cuda, launch_on
from ergodic_exploration_tpu_torch.utils import prng

# glue_pre's history modes (``Mode`` in the source)
MODES = {None: 0, "sums": 1, "nb": 2, "full": 3, "accumulate": 4}


class PatchGeometry(NamedTuple):
    """What the patch start needs: the distance field's origin (S, 2) and
    resolution (S,), and the patch's cells."""

    origin: torch.Tensor
    resolution: torch.Tensor
    P: int


class GluePre(NamedTuple):
    # (S, K^2) sums ("sums", "full"; "accumulate": ck_sum itself) or (S, nb, 2)
    # positions ("nb")
    hist: Optional[torch.Tensor]
    nh: Optional[torch.Tensor]  # (S,) float32 history state count (None without history)
    orbiting: torch.Tensor  # (S,) bool: the orbit guard reset the warm start
    U: torch.Tensor  # (S, H, nu) warm start
    pstart: Optional[torch.Tensor]  # (S, 2) int32 patch starts (with a PatchGeometry)


class GluePost(NamedTuple):
    U: torch.Tensor  # (S, H, nu) shifted warm start
    buffer: RingBuffer  # the ring after the append (its states the input's with ring_in_place)
    hist_count: torch.Tensor  # (S,) int32
    rng: torch.Tensor  # (S, 2) int64 next keys
    u: torch.Tensor  # (S, nu) emitted controls
    code: torch.Tensor  # (S,) int32 validation codes (0 with safety off)
    dwa_active: torch.Tensor  # (S,) bool
    feasible: torch.Tensor  # (S,) bool
    diverged: torch.Tensor  # (S,) bool
    x: Optional[torch.Tensor]  # (S, 3) poses one dt on (``advance``)
    vb: Optional[torch.Tensor]  # (S, 3) body twists of ``u`` (``advance``)


def history_mode(cfg, fused: bool) -> str:
    """glue_pre's history mode for ``cfg``: ``"sums"`` for the fused tick's
    shared draw, ``"nb"`` for per-scenario draws (the fused tick without the
    shared draw, and the eager step), ``"full"`` for the full ring
    (``buffer_batch`` None) and ``"accumulate"`` for the accumulate mode."""
    if cfg.history != "ring":
        return "accumulate"
    if not cfg.buffer_batch:
        return "full"
    return "sums" if fused and cfg.shared_history_draw else "nb"


def orbit_window(cfg, capacity: int) -> int:
    """The orbit guard's window clamped to the ring (0: the guard is off)."""
    return 0 if cfg.orbit_window <= 0 else min(cfg.orbit_window, capacity)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def shared_draw_sums(cfg, buffer: RingBuffer, sub0: torch.Tensor, domain: Domain):
    """The shared draw's history (the JAX tick's compaction): ONE index draw
    under the key ``sub0`` (2,) over row 0's count (the scenarios share the
    key and tick together, so their counts are equal), gathered from every
    ring; the reduction is one batched (K, nb) @ (nb, K) product. Returns
    (sums (S, K^2), n_hist (S,))."""
    nb, K = cfg.buffer_batch, cfg.num_basis
    S = buffer.states.shape[0]
    u = prng.uniform01(sub0, nb)  # (nb,)
    n0 = torch.clamp(buffer.count[0], min=1).to(u.dtype)
    idx = torch.floor(u * n0).to(torch.int64)
    s_buf = buffer.states.index_select(2, idx).transpose(1, 2)  # (S, nb, 2)
    n_hist = torch.where(buffer.count > 0, float(nb), 0.0)
    Cbx, Cby = basis.cos_tables(s_buf, K, domain)
    w = (n_hist > 0).to(torch.float32)[:, None, None]
    hk = basis.hk_norm(K, domain.lengths)
    return (torch.bmm(Cbx.transpose(1, 2), Cby) * (w / hk)).reshape(S, K * K), n_hist


def glue_pre_plain(cfg, mode: Optional[str], rng, buffer: RingBuffer, U, x, domain: Domain,
                   patch: Optional[PatchGeometry] = None, hist_count=None,
                   ck_sum=None) -> GluePre:
    """glue_pre's plain version: keys ``rng`` (S, 2), the ring, the warm
    start U (S, H, nu), poses x (S, 3), the per-scenario ``domain`` ((S, 2)
    leaves), for the patch starts a :class:`PatchGeometry` and, for the
    accumulate mode, ``hist_count`` (S,) and ``ck_sum`` (S, K, K). The full
    ring and the accumulate mode take ``controller.history_sums``."""
    from ergodic_exploration_tpu_torch.controller import (
        ControllerState, history_sums, orbit_guard)

    hist = nh = pstart = None
    if mode == "sums":
        hist, nh = shared_draw_sums(cfg, buffer, prng.split(rng[0])[1], domain)
    elif mode == "nb":
        hist, nh = buffer.sample_states(cfg.buffer_batch, prng.split(rng)[:, 1])
    elif mode in ("full", "accumulate"):
        K = cfg.num_basis
        hist, nh = history_sums(cfg, ControllerState(U, buffer, ck_sum, hist_count, rng), domain,
                                basis.hk_norm(K, domain.lengths))
        hist = hist.reshape(x.shape[0], K * K)
    orbiting = orbit_guard(cfg, buffer, x[:, :2])
    U_warm = torch.where(orbiting[:, None, None], torch.zeros_like(U), U)
    if patch is not None:
        pstart = patch_start(patch, x[:, :2], patch.P).to(torch.int32)
    return GluePre(hist, nh, orbiting, U_warm, pstart)


def glue_post_plain(cfg, shared_key: bool, U_new, safety, buffer: RingBuffer, hist_count, rng,
                    x, advance: bool = False, ring_in_place: bool = False) -> GluePost:
    """glue_post's plain version: U_new (S, H, nu) from the descent,
    ``safety`` (code (S,) int32, u_dwa (S, nu), feasible (S,) int32) or None
    (safety off), the ring, ``hist_count``, the keys ``rng`` (S, 2) (with
    ``shared_key`` every row's next key is row 0's), poses x (S, 3). With
    ``ring_in_place`` the pose is written into ``buffer.states`` itself
    (:meth:`RingBuffer.append_`), else into a new ring."""
    S = x.shape[0]
    u0 = U_new[:, 0]
    if safety is not None:
        code, u_dwa, feasible = safety
        use_dwa = code >= CRASH
        u_cmd = torch.where(use_dwa[:, None], u_dwa, u0)
        feasible = feasible.to(torch.bool)
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
    if shared_key:
        nxt = prng.split(rng[0])[0].expand(S, 2).clone()
    else:
        nxt = prng.split(rng)[:, 0]
    x_next = vb_next = None
    if advance:
        from ergodic_exploration_tpu_torch.models import make_model
        from ergodic_exploration_tpu_torch.ops.integrator import rollout

        model = make_model(cfg)
        x_next = rollout(model, x, u_cmd[:, None, :], cfg.dt)[:, -1]
        vb_next = model.twist(u_cmd)
    ring = buffer.append_(x[:, :2]) if ring_in_place else buffer.append(x[:, :2])
    return GluePost(U_next, ring, hist_count + 1, nxt, u_cmd, code, use_dwa, feasible, diverged,
                    x_next, vb_next)


# ---------------------------------------------------------------------------
# the CUDA kernels: parameter block, buffers, build and launch
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``struct GlueParams`` in csrc/tick_glue.cu. Float fields hold
    the Python (double) constants rounded to float32, as PyTorch's scalar
    ops round them."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "H", "nu", "K", "nb", "cap", "mode", "W", "P", "safety", "shared_key", "advance",
        "model", "in_place", "block")] + [(n, ctypes.c_float) for n in (
            "orbit_eps2", "dt", "half_dt", "dt6", "tw_a", "tw_b", "two_pi")]


_PRE = ("rng", "states", "cursor", "count", "U", "x", "dorigin", "dlen", "porigin", "pres",
        "hist_count", "hist", "nh", "orbiting", "U_warm", "pstart")
_POST = ("U_new", "code", "u_dwa", "feasible", "states", "cursor", "count", "hist_count", "rng",
         "x", "U_next", "states_out", "cursor_out", "count_out", "hist_count_out", "rng_out",
         "u_cmd", "code_out", "use_dwa", "feasible_out", "diverged", "x_next", "vb_next")


class _PreBuffers(ctypes.Structure):
    """Mirror of ``struct PreBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _PRE]


class _PostBuffers(ctypes.Structure):
    """Mirror of ``struct PostBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _POST]


_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64


def _check(what: str, ops: dict, want: dict, dev) -> None:
    """Make every operand named in ``want`` (name -> (shape, dtype))
    contiguous in ``ops`` (a copy only where it is not), and raise unless it
    has that shape and dtype on ``dev``."""
    for n, (shape, dtype) in want.items():
        t = ops[n] = ops[n].contiguous()
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what} operand {n}: need {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _c_params(cfg, S: int, H: int, nu: int, cap: int, **ints) -> _Params:
    from ergodic_exploration_tpu_torch.ops.solve_kernel import _model_finv
    from ergodic_exploration_tpu_torch.models import make_model

    kind, (tw_a, tw_b), _ = _model_finv(make_model(cfg))
    p = _Params(S=S, H=H, nu=nu, K=cfg.num_basis, cap=cap, model=0 if kind == "cart" else 1,
                **ints)
    for k, v in dict(orbit_eps2=cfg.orbit_eps * cfg.orbit_eps, dt=cfg.dt, half_dt=0.5 * cfg.dt,
                     dt6=cfg.dt / 6.0, tw_a=tw_a, tw_b=tw_b, two_pi=2.0 * math.pi).items():
        setattr(p, k, v)
    return p


class TickGlue:
    """The G wrapper: builds ``csrc/tick_glue.cu`` on first use and counts
    its launches per variant (``launches[variant]`` grows by one per launch
    of that variant, nowhere else): ``glue_pre_sums``, ``glue_pre_nb``,
    ``glue_pre_full``, ``glue_pre_accumulate``, ``glue_pre_nohist`` by
    history mode; ``glue_post``,
    ``glue_post_advance``, ``glue_post_inplace`` and
    ``glue_post_advance_inplace`` by ``advance`` and ``ring_in_place``.

    Layout: a warp per scenario, four a block; up to ``block_max_s``
    scenarios, a block of four warps per scenario (a small batch's work
    spread over the block; the host tests lower it to reach the warp layout
    at small S)."""

    PRE_VARIANTS = {"sums": "glue_pre_sums", "nb": "glue_pre_nb", "full": "glue_pre_full",
                    "accumulate": "glue_pre_accumulate", None: "glue_pre_nohist"}
    POST_VARIANTS = {(False, False): "glue_post", (True, False): "glue_post_advance",
                     (False, True): "glue_post_inplace", (True, True): "glue_post_advance_inplace"}
    VARIANTS = tuple(PRE_VARIANTS.values()) + tuple(POST_VARIANTS.values())
    BLOCK_MAX_S = 512

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.block_max_s = self.BLOCK_MAX_S
        self.launches = {}
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("tick_glue", LIBRARIES["tick_glue"])
            for fn, bufs in ((built.lib.glue_pre, _PreBuffers), (built.lib.glue_post,
                                                                 _PostBuffers)):
                fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(bufs), ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def _launch(self, fn_name: str, variant: str, params, bufs, dev) -> None:
        err = launch_on(dev, getattr(self.build().lib, fn_name), params, bufs)
        if err != 0:
            raise RuntimeError(f"G {variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1

    def pre(self, cfg, mode: Optional[str], rng, buffer: RingBuffer, U, x, domain: Domain,
            patch: Optional[PatchGeometry] = None, hist_count=None, ck_sum=None) -> GluePre:
        """Launch glue_pre (see :func:`glue_pre_plain` for the operands). In
        the accumulate mode its ``hist`` is ``ck_sum`` itself, as (S, K^2)."""
        dev = x.device
        _require_cuda(dev, "glue_pre kernel")
        if mode not in MODES:
            raise ValueError(f"glue_pre: unknown history mode {mode!r}")
        S, H, nu = U.shape
        cap, K, nb = buffer.capacity, cfg.num_basis, cfg.buffer_batch or 0
        ops = dict(rng=rng, states=buffer.states, cursor=buffer.cursor, count=buffer.count, U=U,
                   x=x, dorigin=domain.origin, dlen=domain.lengths)
        want = dict(rng=((S, 2), _I64), states=((S, 2, cap), _F32), cursor=((S,), _I32),
                    count=((S,), _I32), U=((S, H, nu), _F32), x=((S, 3), _F32),
                    dorigin=((S, 2), _F32), dlen=((S, 2), _F32))
        if patch is not None:
            ops.update(porigin=patch.origin, pres=patch.resolution)
            want.update(porigin=((S, 2), _F32), pres=((S,), _F32))
        if mode == "accumulate":
            ops.update(hist_count=hist_count, ck_sum=ck_sum)
            want.update(hist_count=((S,), _I32), ck_sum=((S, K, K), _F32))
        _check("glue_pre", ops, want, dev)
        kw = dict(device=dev)
        out = GluePre(
            hist=(torch.empty((S, K * K), dtype=_F32, **kw) if mode in ("sums", "full") else
                  torch.empty((S, nb, 2), dtype=_F32, **kw) if mode == "nb" else
                  ops["ck_sum"].view(S, K * K) if mode == "accumulate" else None),
            nh=torch.empty((S,), dtype=_F32, **kw) if mode is not None else None,
            orbiting=torch.empty((S,), dtype=torch.bool, **kw),
            U=torch.empty((S, H, nu), dtype=_F32, **kw),
            pstart=torch.empty((S, 2), dtype=_I32, **kw) if patch is not None else None)
        ops.update(hist=out.hist if mode != "accumulate" else None, nh=out.nh,
                   orbiting=out.orbiting, U_warm=out.U, pstart=out.pstart)
        params = _c_params(cfg, S, H, nu, cap, nb=nb, mode=MODES[mode],
                           W=orbit_window(cfg, cap), P=patch.P if patch is not None else 0,
                           block=int(S <= self.block_max_s))
        bufs = _PreBuffers(**{n: (ops[n].data_ptr() if ops.get(n) is not None else None)
                              for n in _PRE})
        self._launch("glue_pre", self.PRE_VARIANTS[mode], params, bufs, dev)
        return out

    def post(self, cfg, shared_key: bool, U_new, safety, buffer: RingBuffer, hist_count, rng,
             x, advance: bool = False, ring_in_place: bool = False) -> GluePost:
        """Launch glue_post (see :func:`glue_post_plain` for the operands)."""
        dev = x.device
        _require_cuda(dev, "glue_post kernel")
        S, H, nu = U_new.shape
        cap = buffer.capacity
        if nu > 4:
            raise ValueError("glue_post supports nu <= 4")
        if ring_in_place and not buffer.states.is_contiguous():
            raise ValueError("glue_post: an in-place append needs a contiguous ring")
        ops = dict(U_new=U_new, states=buffer.states, cursor=buffer.cursor, count=buffer.count,
                   hist_count=hist_count, rng=rng, x=x)
        want = dict(U_new=((S, H, nu), _F32), states=((S, 2, cap), _F32), cursor=((S,), _I32),
                    count=((S,), _I32), hist_count=((S,), _I32), rng=((S, 2), _I64),
                    x=((S, 3), _F32))
        if safety is not None:
            ops.update(zip(("code", "u_dwa", "feasible"), safety))
            want.update(code=((S,), _I32), u_dwa=((S, nu), _F32), feasible=((S,), _I32))
        _check("glue_post", ops, want, dev)
        kw = dict(device=dev)
        f32 = dict(dtype=_F32, **kw)
        out = GluePost(
            U=torch.empty((S, H, nu), **f32),
            buffer=RingBuffer(buffer.states if ring_in_place else torch.empty((S, 2, cap), **f32),
                              torch.empty((S,), dtype=_I32, **kw),
                              torch.empty((S,), dtype=_I32, **kw)),
            hist_count=torch.empty((S,), dtype=_I32, **kw),
            rng=torch.empty((S, 2), dtype=_I64, **kw), u=torch.empty((S, nu), **f32),
            code=torch.empty((S,), dtype=_I32, **kw),
            dwa_active=torch.empty((S,), dtype=torch.bool, **kw),
            feasible=torch.empty((S,), dtype=torch.bool, **kw),
            diverged=torch.empty((S,), dtype=torch.bool, **kw),
            x=torch.empty((S, 3), **f32) if advance else None,
            vb=torch.empty((S, 3), **f32) if advance else None)
        ops.update(U_next=out.U, states_out=out.buffer.states, cursor_out=out.buffer.cursor,
                   count_out=out.buffer.count, hist_count_out=out.hist_count, rng_out=out.rng,
                   u_cmd=out.u, code_out=out.code, use_dwa=out.dwa_active,
                   feasible_out=out.feasible, diverged=out.diverged, x_next=out.x,
                   vb_next=out.vb)
        params = _c_params(cfg, S, H, nu, cap, safety=int(safety is not None),
                           shared_key=int(shared_key), advance=int(advance),
                           in_place=int(ring_in_place), block=int(S <= self.block_max_s))
        bufs = _PostBuffers(**{n: (ops[n].data_ptr() if ops.get(n) is not None else None)
                               for n in _POST})
        self._launch("glue_post", self.POST_VARIANTS[advance, ring_in_place], params, bufs, dev)
        return out


G = TickGlue()


def glue_pre(cfg, mode: Optional[str], rng, buffer: RingBuffer, U, x, domain: Domain,
             patch: Optional[PatchGeometry] = None, hist_count=None, ck_sum=None) -> GluePre:
    """glue_pre: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (raises for anything else)."""
    if _on_cpu(x, "glue_pre"):
        return glue_pre_plain(cfg, mode, rng, buffer, U, x, domain, patch, hist_count, ck_sum)
    return G.pre(cfg, mode, rng, buffer, U, x, domain, patch, hist_count, ck_sum)


def glue_post(cfg, shared_key: bool, U_new, safety, buffer: RingBuffer, hist_count, rng, x,
              advance: bool = False, ring_in_place: bool = False) -> GluePost:
    """glue_post: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (raises for anything else). ``ring_in_place`` only where the
    ring is a buffer the caller owns and advances (a graph's static state)."""
    if _on_cpu(x, "glue_post"):
        return glue_post_plain(cfg, shared_key, U_new, safety, buffer, hist_count, rng, x,
                               advance, ring_in_place)
    return G.post(cfg, shared_key, U_new, safety, buffer, hist_count, rng, x, advance,
                  ring_in_place)
