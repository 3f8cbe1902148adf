"""Frozen from ``ergodic_exploration_tpu_torch/ops/solve_kernel.py`` at commit e20fa1114c5b:
K1's plain version and the tick around it; the dispatchers call the plain version on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eebench.reference.grid import Domain
from eebench.reference.ops import basis
from eebench.reference.ops.patch import gather_patch
from eebench.reference.ops.target import GaussianMixture, gmm_eval

LATTICE_CHUNK = 64  # lattice points per refresh step; N is padded to it
PAD_POINT = 1.0e6  # pad points sit far away: phi underflows to exactly 0


class Refresh(NamedTuple):
    """Operands of the in-kernel GMM target refresh (J > 0)."""

    gmm: GaussianMixture  # means (S, J, 2), covs (S, J, 2, 2), weights (S, J)
    pts: torch.Tensor  # (Npad, 2) shared lattice, padded with PAD_POINT
    D: torch.Tensor  # (Npad, K^2) dense basis table, mask folded, pad rows 0
    mask_ck: torch.Tensor  # (K^2,) degenerate-target fallback
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
    from eebench.reference.controller import descent, drawn_history_sums, safety
    from eebench.reference.models import make_model

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
    from eebench.reference.ops.patch import gather_window

    P, Pc = crop_geometry(cfg, dist)
    cstart = pstart + (P - Pc) // 2
    return fused_safety_plain(cfg, x, vb, U_new[:, 0].contiguous(),
                              gather_window(dist, cstart, Pc), cstart, porigin, pres, dorigin,
                              dlen)


def fused_safety_plain(cfg, x, vb, u0, crop, pstart, porigin, pres, dorigin, dlen):
    """The standalone safety stage's plain version: ``controller.safety_on_crop``
    on a :class:`PatchField` of the crop (S, Pc, Pc) given as data. Returns
    (code (S,) int32, u_dwa (S, nu), feasible (S,) int32)."""
    from eebench.reference.controller import safety_on_crop
    from eebench.reference.models import make_model
    from eebench.reference.ops.patch import PatchField

    field = PatchField(dist=crop, grad=None, start=pstart.to(torch.int64), origin=porigin,
                       resolution=pres)
    code, u_dwa, feas = safety_on_crop(cfg, make_model(cfg), x, vb, u0, Domain(dorigin, dlen),
                                       field)
    return code, u_dwa, feas.to(torch.int32)


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
    """The refresh's operands that depend on the geometry alone: the shared
    lattice, the mask-folded dense basis table and the degenerate-target
    fallback (the fields of :class:`Refresh` after its mixture)."""

    pts: torch.Tensor  # (Npad, 2)
    D: torch.Tensor  # (Npad, K^2)
    mask_ck: torch.Tensor  # (K^2,)


def lattice_operands(cfg, domain: Domain, free_mask) -> Lattice:
    """The shared lattice, the mask-folded dense basis table and the fallback
    of the in-kernel refresh on the unbatched ``domain`` (with row 0 of
    ``free_mask`` folded in, or none); the lattice is padded to LATTICE_CHUNK
    with far-away points whose D rows are zero. They depend on (domain, free
    mask, K, grid_samples) alone: the engine builds them once for those,
    outside any graph (``Engine._lattice_ops``), as the JAX package's jit
    builds them inside its trace."""
    K = cfg.num_basis
    pts = domain.sample_lattice(cfg.grid_samples)  # (N, 2)
    N = pts.shape[0]
    D = basis.dense_table(basis.tables(pts, K, domain), basis.hk_norm(K, domain.lengths))
    if free_mask is not None:
        m1 = free_mask[0] if free_mask.dim() == 2 else free_mask  # one shared mask
        D = D * m1.to(D.dtype)[:, None]
        mask_ck = D.sum(dim=0) / torch.clamp(m1.sum(), min=1.0)
    else:
        mask_ck = D.sum(dim=0) / float(N)
    pts, D = pad_lattice(pts, D)
    return Lattice(pts, D, mask_ck.contiguous())


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
    from eebench.reference.ops.tick_glue import PatchGeometry, glue_pre, history_mode

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
    from eebench.reference.controller import finish_tick

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


def fused_solve_safety(cfg, inp: K1Inputs) -> K1Outputs:
    return fused_solve_safety_plain(cfg, inp)


def fused_solve(cfg, inp: K1Inputs) -> K1Outputs:
    return fused_solve_safety_plain(cfg, inp, enable_safety=False)


fused_safety_map = fused_safety_map_plain
