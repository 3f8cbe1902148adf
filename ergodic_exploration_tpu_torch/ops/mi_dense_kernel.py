"""M, the dense mutual-information target kernel: phi_k from the beliefs on a
shared domain and grid geometry.

Counterpart of the XLA program that the JAX package compiles for
``ergodic_exploration_tpu/engine.py::_phik_grid_batch_dense_fn`` (no Pallas
kernel there): for a batch of belief maps (S, h, w) that share one grid
geometry and one exploration domain, in LATTICE space,

    e    = entropy(clip(unknown -> 0.5, eps, 1 - eps))
    t    = edge-clamped (2r+1)^2 box sum of e at each lattice point's
           nearest cell (cy[iy], cx[ix])                (unscaled)
    vals = max(t * [b < thr] * [some known-free cell in the (2fc+1)^2 box], 0)
    raw  = vals (S, N) @ D (N, K^2)
    phik = raw / max(total, 1e-12) where total = raw[0] hk[0, 0] > 1e-12,
           else the column means of D

:func:`dense_operands` builds ``cx``, ``cy``, ``D``, the fallback and
``hk`` once per (grid geometry, domain, K, lattice) with the plain
version's own expressions, and the per-axis cosine tables D is the
product of (D is separable: D[ix nsy + iy, k1 K + k2] = cosx[ix, k1]
cosy[iy, k2] / h_k). The CUDA source is ``csrc/mi_dense_kernel.cu`` (its
header says what bounds it on an H100 and what the design does about that):
a block per 16 scenarios, a tile of the coefficients and a run of lattice
rows (:func:`runs`), walked G rows a step (:func:`plan`); each lattice row's
values projected on cosx, then accumulated against cosy (no D read); the
map rows around a step in rings, at the columns the lattice's windows reach
only where those are fewer than the map's (:func:`table_width`); the rings,
and past them the y sums and frontier words and the index tables, in shared
memory or, as far as its room needs, in a workspace, the Cx table whole or
a pass's rows at a time (the placements of :data:`SPILLS`,
:func:`smem_bytes`, :func:`work_bytes`); past one tile of coefficients
(K > 11) the lattice values computed once into device memory and
contracted by a kernel per tile; a finishing kernel adds the runs' partial
sums in order and normalizes. It takes what the JAX function takes: any K,
any r, fc >= 0, any lattice and any map that fit the card. Beside it lives the plain PyTorch
version, :func:`phik_dense_plain`, the JAX function's body (one-hot and
count-matrix matmuls in place of the gathers, then the contraction); the CPU
tests run it, ``chip_smoke.py`` holds the kernel against it on the card.

Dispatch: :func:`phik_dense` takes the plain version only for tensors that
lie on the CPU. For CUDA tensors it launches the kernel or raises; there is
no fallback. ``M.launches`` counts the launches with and without the
frontier mask, of one tile or of the values once (``_tiles``), in each
placement (the suffixes of :data:`SPILLS`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops import target as target_ops
from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    MAX_SMEM, _check_operands, _on_cpu, _require_cuda, _sm_count, launch_on)

# constants of csrc/mi_dense_kernel.cu that its memory layout and grid depend on
_TS, _KC, _NV = 16, 128, 128  # scenarios, coefficients a block; lattice columns a pass of vals
BLOCKS_PER_SM = 4  # blocks of M in flight on an SM (M_BLOCKS_PER_SM): Z aims to fill them
# the placements of a block's tables (``m_layout``), each a variant's suffix:
# all in shared memory; the rings in the workspace; also the y sums and
# frontier words; also the tile's Cx table reduced to a pass's rows, staged
# from the cosines at each pass; also the lattice cells and the rings' row
# offsets and tags (only a pass's Cx, R and vals stay: every shape fits)
SPILLS = ("", "_global", "_global_sums", "_global_cx", "_global_tables")
WORK_BUDGET = 2**30  # bytes of workspace the runs may take together (Z is cut to fit)
# a launch's kernel (the source's modes): one tile's whole target; the values
# once, into device memory; a tile's contraction of those values
FUSED, VALUES, CONTRACT = 0, 1, 2


class DenseOperands(NamedTuple):
    """What M and its plain version need beside the beliefs; shared by every
    scenario."""

    cx: torch.Tensor  # (nsx,) int32 nearest map column of each lattice column
    cy: torch.Tensor  # (nsy,) int32 nearest row of each lattice row
    D: torch.Tensor  # (nsx * nsy, K^2) dense basis table of the lattice, x-major (plain version)
    fallback: torch.Tensor  # (K, K) the uniform target over the lattice
    cosx: torch.Tensor  # (nsx, K) the lattice's x cosines: D[ix nsy + iy] = cosx[ix] cosy[iy] / hk
    cosy: torch.Tensor  # (nsy, K) its y cosines
    hk: torch.Tensor  # (K, K) the basis normalization h_k: raw[0] hk[0, 0] is the target's mass


def dense_operands(g0, domain, K: int, grid_samples) -> DenseOperands:
    """Operands of M for maps of ``g0``'s geometry (an unbatched GridMap;
    only its shape, origin and resolution are read) on the unbatched
    ``domain``: D and the per-axis tables D is the product of (the same
    floats)."""
    nsy = grid_samples[1]
    pts = domain.sample_lattice(grid_samples)
    hk = basis.hk_norm(K, domain.lengths)
    tbl = basis.tables(pts, K, domain)
    D = basis.dense_table(tbl, hk)
    _, _, cx, cy = target_ops._lattice_cells(g0, grid_samples, domain)
    fallback = (D.sum(dim=0) / float(pts.shape[0])).view(K, K)
    return DenseOperands(cx.to(torch.int32).contiguous(), cy.to(torch.int32).contiguous(),
                         D.contiguous(), fallback.contiguous(), tbl.Cx[::nsy].contiguous(),
                         tbl.Cy[:nsy].contiguous(), hk.contiguous())


def dense_values_plain(data, ops: DenseOperands, sensor_radius_cells: int = 0,
                       frontier_cells: int = 0, occupied_threshold: float = 0.65):
    """(S, nsx * nsy) lattice values of the beliefs ``data`` (S, h, w), x-major:
    the per-scenario entropy map resampled with the sensor-footprint blur
    folded into the sampling matrices (the box blur is linear, so
    blur-then-sample is one small-integer count matrix per axis and the
    (2r+1)^2 scale cancels in the normalization). The free mask and the
    frontier count are sampled the same way and applied at the lattice:
    nearest-cell sampling commutes with elementwise products and monotone
    thresholds. Float32 matmuls with TF32 off throughout."""
    r, fc = sensor_radius_cells, frontier_cells
    nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
    h, w = data.shape[-2:]
    dev = data.device
    Ax, Ay = target_ops._one_hot(ops.cx, w), target_ops._one_hot(ops.cy, h)
    Axb = torch.matmul(Ax, target_ops.blur_count_matrix(w, r, device=dev))  # (nsx, w)
    Ayb = torch.matmul(Ay, target_ops.blur_count_matrix(h, r, device=dev))  # (nsy, h)

    def sampled(field, Mx, My):
        """(S, h, w) cell field -> (S, nsx, nsy): Mx field^T My^T."""
        t1 = torch.matmul(field, Mx.T)  # (S, h, nsx)
        return torch.matmul(t1.transpose(1, 2), My.T)

    occupied = data >= occupied_threshold
    prob = torch.where(data < 0.0, torch.full_like(data, 0.5), data)
    vals = sampled(target_ops.entropy(prob), Axb, Ayb)
    zs = sampled((~occupied).to(torch.float32), Ax, Ay)
    if fc > 0:
        kf = ((data >= 0.0) & ~occupied).to(torch.float32)
        Axf = torch.matmul(Ax, target_ops.blur_count_matrix(w, fc, device=dev))
        Ayf = torch.matmul(Ay, target_ops.blur_count_matrix(h, fc, device=dev))
        zs = zs * (sampled(kf, Axf, Ayf) > 0.5).to(zs.dtype)
    return torch.clamp((vals * zs).reshape(-1, nsx * nsy), min=0.0)  # (S, N)


def phik_dense_plain(data, ops: DenseOperands, sensor_radius_cells: int = 0,
                     frontier_cells: int = 0, occupied_threshold: float = 0.65) -> torch.Tensor:
    """M's plain PyTorch version: beliefs ``data`` (S, h, w) -> (S, K, K),
    :func:`dense_values_plain` then one (S, N) @ (N, K^2) contraction."""
    K = ops.fallback.shape[-1]
    vals = dense_values_plain(data, ops, sensor_radius_cells, frontier_cells,
                              occupied_threshold)
    ck_raw = basis.coefficients_dense(vals, ops.D, K)
    total = (ck_raw[:, 0, 0] * ops.hk[0, 0])[:, None, None]  # scaled sum: the scale cancels
    return torch.where(total > 1e-12, ck_raw / torch.clamp(total, min=1e-12), ops.fallback)


class _Params(ctypes.Structure):
    """Mirror of ``struct MParams`` in csrc/mi_dense_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "h", "w", "nsx", "nsy", "K", "r", "fc", "Z", "G",
                                            "spill", "Zc", "Gc", "spillc", "wc")] + [
        (n, ctypes.c_float) for n in ("thr", "lo", "hi")]


_BUFFERS = ("data", "cx", "cy", "cosx", "cosy", "hk", "fallback", "out", "part", "work", "vals",
            "cols")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct MBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


def tile_k1(K: int) -> int:
    """T1, the k1 of a block's tile (``m_t1``): T1 K <= 128 coefficients,
    one k1 past K = 128."""
    return K if K <= 11 else _KC // K if K <= _KC else 1


def tiles(K: int) -> int:
    """Tiles of the coefficients (``m_tiles``): of T1 k1 and every k2, or
    past K = 128 of one k1 and at most 128 k2."""
    return -(-K // tile_k1(K)) * -(-K // min(K, _KC))


def table_width(w: int, nsx: int, r: int, fc: int) -> int:
    """Columns a block's rings, y sums and frontier words hold
    (``m_table_width``): the map's w, or nsx (2m + 1) (m = max(r, fc)) where
    that is fewer, room for the union of the lattice's edge-clipped windows
    [cx - m, cx + m], which ``m_columns`` lists."""
    m = max(r, fc)
    return nsx * (2 * m + 1) if m > 0 and nsx * (2 * m + 1) < w else w


def sampling_mode(K: int) -> int:
    """The kernel that samples the beliefs: :data:`FUSED` (one tile, K <= 11)
    or :data:`VALUES` (the values once, then :data:`CONTRACT` per tile)."""
    return FUSED if tiles(K) == 1 else VALUES


def _words(h: int, w: int, nsx: int, nsy: int, K: int, r: int, fc: int, G: int, spill: int,
           mode=None, wc=None):
    """(words of shared memory, words of workspace) of a block in placement
    ``spill`` (``m_layout``'s tables in its order, each with whether the
    placement moves it to the workspace)."""
    mode = sampling_mode(K) if mode is None else mode
    wc = table_width(w, nsx, r, fc) if wc is None else wc
    samples, projects = mode != CONTRACT, mode != VALUES
    t1p = -(-tile_k1(K) // 4) * 4
    vc = -(-nsx // -(-nsx // _NV))
    erow, wrow = _TS * (wc | 1), _TS * -(-wc // 32)
    re, rw = ((min(2 * rad + G, h) if samples and rad > 0 else 0) for rad in (r, fc))
    parts = (((vc if spill >= 3 else nsx) * t1p * projects, False),  # Cx: a pass's past 3
             (G * t1p * _TS * projects, False), (G * _TS * (vc | 1) * projects, False),
             (G * erow if samples and r > 0 else 0, spill >= 2),
             (G * wrow if samples and fc > 0 else 0, spill >= 2),
             ((nsx + nsy + 2 * h) * samples + re + rw, spill >= 4),
             (re * erow + rw * wrow, spill >= 1))
    work = sum(n for n, out in parts if out)
    return sum(n for n, out in parts if not out), 4 * -(-work // 4)


def smem_bytes(h: int, w: int, nsx: int, nsy: int, K: int, r: int, fc: int, G: int,
               spill: int = 0, mode=None, wc=None) -> int:
    """Dynamic shared memory of a block of M for (h, w) maps, an nsx x nsy
    lattice and steps of G lattice rows in placement ``spill`` (``m_layout``
    in the source), for the kernel ``mode`` (the sampling kernel of K when
    None) and tables ``wc`` columns wide (:func:`table_width` when None): the
    tile's Cx table (nsx rows of T1 padded to 4; from placement 3 a pass's
    rows), R (G rows, 16 scenarios), the vals of a pass of at most 128
    columns (an odd stride), the y sums (r > 0) and the frontier words
    (fc > 0) of G rows, the lattice columns and rows, the rings' row offsets
    and tags and the rings, less what the placement moves to the workspace
    (:data:`VALUES` keeps no Cx, R or vals, :data:`CONTRACT` only those)."""
    return 4 * _words(h, w, nsx, nsy, K, r, fc, G, spill, mode, wc)[0]


def work_bytes(h: int, w: int, nsx: int, nsy: int, K: int, r: int, fc: int, G: int,
               spill: int, mode=None, wc=None) -> int:
    """Bytes of a block's workspace in placement ``spill`` (``m_work_bytes``):
    what it moves out of shared memory, rounded up to 16 bytes."""
    return 4 * _words(h, w, nsx, nsy, K, r, fc, G, spill, mode, wc)[1]


def cols_words(w: int, nsx: int, wc: int) -> int:
    """Words of ``m_columns``' list (``m_cols_words``): its count, an offset
    a lattice column, wc columns, a bit and a rank a map column's word."""
    return 1 + nsx + wc + 2 * -(-w // 32)


def blocks_per_sm(smem: int) -> int:
    """Blocks of M an SM holds by their shared memory (228 KB, less 1 KB a
    block) and their registers (at most ``BLOCKS_PER_SM``)."""
    return min(BLOCKS_PER_SM, 233472 // (smem + 1024))


def plan(h: int, w: int, nsx: int, nsy: int, K: int, r: int, fc: int, mode=None, wc=None):
    """(G, the placement, bytes of shared memory a block takes) of the kernel
    ``mode`` (the sampling kernel of K when None) with tables ``wc`` columns
    wide (:func:`table_width` when None): the first placement of
    :data:`SPILLS` in which some G fits a block, and there the lattice rows a
    step walks (4, 2 or 1), the most that keeps the most blocks an SM. The
    last placement keeps at most 42 KB in shared memory, so every shape has a
    plan."""
    for spill in range(len(SPILLS)):
        best = None
        for G in (4, 2, 1):
            smem = smem_bytes(h, w, nsx, nsy, K, r, fc, G, spill, mode, wc)
            if smem <= MAX_SMEM and (best is None or blocks_per_sm(smem) > best[0]):
                best = (blocks_per_sm(smem), G, smem)
        if best is not None:
            return best[1], spill, best[2]
    raise AssertionError("the last placement fits every shape")


def runs(S: int, K: int, nsy: int, sm_count: int, smem: int, m: int = 0, work: int = 0,
         n_tiles=None) -> int:
    """Z, the runs the nsy lattice rows are cut into (a block each per 16
    scenarios and coefficient tile: ``n_tiles`` tiles, :func:`tiles` of K
    when None), in runs of equal length, none empty:
    the Z that takes the fewest waves of blocks (as many at a time as the
    SMs hold by their shared memory and registers) times a block's rows, its
    run and the 2 m + 2 rows' worth a block spends before its first (its
    tables, its rings' first rows: m = max(r, fc)); the smallest such Z,
    among those whose blocks' workspaces (``work`` bytes each) take at most
    :data:`WORK_BUDGET` together (Z = 1 always)."""
    blocks = -(-S // _TS) * (tiles(K) if n_tiles is None else n_tiles)
    slots = max(1, sm_count * blocks_per_sm(smem))
    most = max(1, WORK_BUDGET // (blocks * work)) if work else nsy
    best = None
    for z in range(1, nsy + 1):
        per_run = -(-nsy // z)
        z = -(-nsy // per_run)
        if z > most:
            break
        cost = -(-blocks * z // slots) * (per_run + 2 * m + 2)
        if best is None or cost < best[0]:
            best = (cost, z)
    return best[1]


class PhikDense:
    """The M wrapper: builds ``csrc/mi_dense_kernel.cu`` on first use and
    counts its launches per variant (``launches[variant]`` grows by one per
    launch of that variant, nowhere else)."""

    VARIANTS = tuple(f"phik_dense_{m}{t}{sp}" for t in ("", "_tiles") for sp in SPILLS
                     for m in ("fc", "nofc"))

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        # bytes a block may take; the placement moves tables out of shared memory until it fits
        self.smem_limit = MAX_SMEM
        # list the columns the lattice reads where they are fewer than the
        # map's (table_width); False keeps every map column (the same bits)
        self.compact = True
        self.launches = {}
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("mi_dense_kernel", LIBRARIES["mi_dense_kernel"])
            fn = built.lib.m_phik_dense_launch
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def __call__(self, data, ops: DenseOperands, sensor_radius_cells: int = 0,
                 frontier_cells: int = 0, occupied_threshold: float = 0.65,
                 eps: float = 1e-6) -> torch.Tensor:
        dev = data.device
        if data.dim() != 3:
            raise ValueError(f"M takes beliefs (S, h, w), got {tuple(data.shape)}")
        S, h, w = data.shape
        K = ops.fallback.shape[-1]
        nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
        r, fc = int(sensor_radius_cells), int(frontier_cells)
        if K < 1 or r < 0 or fc < 0:
            raise ValueError(f"M takes K >= 1, r >= 0 and fc >= 0, got K={K}, r={r}, fc={fc}")
        wc = table_width(w, nsx, r, fc) if self.compact else w
        once = tiles(K) > 1  # the values once, then a contraction per tile
        shape = (h, w, nsx, nsy, K, r, fc)

        def placed(mode):
            """(G, placement, Z) of the kernel ``mode``: Z from the plan's
            placement (every placement sums in the same runs), the placement
            moved on past ``smem_limit``."""
            G, spill, smem = plan(*shape, mode, wc)
            sampling = mode != CONTRACT
            Z = runs(S, K, nsy, _sm_count(dev), smem, max(r, fc) if sampling else 0,
                     work_bytes(*shape, G, spill, mode, wc), 1 if sampling else None)
            while spill < len(SPILLS) - 1 and smem_bytes(*shape, G, spill, mode,
                                                         wc) > self.smem_limit:
                spill += 1
            return G, spill, Z

        G, spill, Z = placed(sampling_mode(K))
        Gc, spillc, Zc = placed(CONTRACT) if once else (1, 0, 1)
        _require_cuda(dev, "M kernel")
        tensors = dict(data=data, cx=ops.cx, cy=ops.cy, cosx=ops.cosx, cosy=ops.cosy, hk=ops.hk,
                       fallback=ops.fallback)
        _check_operands("M", tensors, dict(data=(S, h, w), cx=(nsx,), cy=(nsy,), cosx=(nsx, K),
                                           cosy=(nsy, K), hk=(K, K), fallback=(K, K)),
                        dev, ints=("cx", "cy"))
        tensors["out"] = out = torch.empty((S, K, K), dtype=torch.float32, device=dev)
        tensors["part"] = torch.empty((S, Zc if once else Z, K * K), dtype=torch.float32,
                                      device=dev)
        # the tables of each block that the placements move out
        work = max(-(-S // _TS) * Z * work_bytes(*shape, G, spill, None, wc),
                   -(-S // _TS) * tiles(K) * Zc * work_bytes(*shape, Gc, spillc, CONTRACT, wc)
                   if once else 0)
        if work:
            tensors["work"] = torch.empty((work,), dtype=torch.uint8, device=dev)
        if once:
            tensors["vals"] = torch.empty((S, nsy, nsx), dtype=torch.float32, device=dev)
        if wc < w:
            tensors["cols"] = torch.empty((cols_words(w, nsx, wc),), dtype=torch.int32,
                                          device=dev)
        params = _Params(S=S, h=h, w=w, nsx=nsx, nsy=nsy, K=K, r=r, fc=fc, Z=Z, G=G, spill=spill,
                         Zc=Zc, Gc=Gc, spillc=spillc, wc=wc, thr=occupied_threshold, lo=eps,
                         hi=1.0 - eps)
        bufs = _Buffers(**{n: t.data_ptr() for n, t in tensors.items()})
        err = launch_on(dev, self.build().lib.m_phik_dense_launch, params, bufs)
        variant = (("phik_dense_fc" if fc > 0 else "phik_dense_nofc") + ("_tiles" if once else "")
                   + SPILLS[spill])
        if err != 0:
            raise RuntimeError(f"M {variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return out


M = PhikDense()


def phik_dense(data, ops: DenseOperands, sensor_radius_cells: int = 0,
               frontier_cells: int = 0, occupied_threshold: float = 0.65) -> torch.Tensor:
    """M: (S, K, K) normalized MI target coefficients from the beliefs
    ``data`` (S, h, w) and :func:`dense_operands`. The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (raises for anything else)."""
    if _on_cpu(data, "M"):
        return phik_dense_plain(data, ops, sensor_radius_cells, frontier_cells,
                                occupied_threshold)
    return M(data.to(torch.float32).contiguous(), ops, sensor_radius_cells, frontier_cells,
             occupied_threshold)
