"""K3, the mutual-information target kernel: phi_k straight from the beliefs.

Counterpart of ``ergodic_exploration_tpu/ops/mi_kernel.py``
(``phik_from_grid_pallas``): for a batch of belief maps (S, h, w) that share
one grid geometry and one exploration domain, in CELL space,

    e    = entropy(clip(unknown -> 0.5, eps, 1 - eps))
    t2   = edge-clamped (2r+1)^2 box sum of e                (unscaled)
    vals = max(t2 * [b < thr] * [known-free count in the (2fc+1)^2 box > 0], 0)
    raw  = sum_ij vals[i, j] cxA[j, k1] cyA[k2, i]
    phik = raw / max(total, 1e-12) where total = raw[0, 0] hk[0, 0] > 1e-12,
           else the uniform target over the lattice

``cxA = Ax^T (cosx sx)`` (w, K) and ``cyA = (cosy sy)^T Ay`` (K, h) fold the
nearest-cell sampling of the separable lattice (one-hot per axis, so it
commutes with the elementwise masks) into the cosine tables: exact for any
lattice, duplicate or skipped cells included. :func:`mi_operands` builds them
once per (grid geometry, domain, K, lattice).

The CUDA source is ``csrc/mi_kernel.cu`` (its header says what bounds it on
an H100 and what the design does about that): one block per scenario, the
whole pipeline in shared memory; a map too large for one block is cut into
row bands with a halo (:func:`band_plan`), one block per band, and a
finishing kernel adds the bands' partial contractions in order. Beside it
lives the plain PyTorch version,
:func:`phik_from_grid_plain`, with the same inputs and outputs; the CPU tests
run it, ``chip_smoke.py`` holds the kernel against it on the card.

Dispatch: :func:`phik_from_grid` takes the plain version only for tensors
that lie on the CPU. For CUDA tensors it launches the kernel or raises; there
is no fallback. ``K3.launches`` counts the launches with and without the
frontier mask, whole-map and row-band form apart.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from ergodic_exploration_tpu_torch.ops import basis
from ergodic_exploration_tpu_torch.ops import target as target_ops
from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    _check_operands, _on_cpu, _require_cuda, _stream_of)

MAX_SMEM = 232448  # dynamic shared memory one block can have on sm_90 (227 KB)
PAIR_SMEM = 115712  # what each of two blocks on one SM can have (228 KB, 1 KB reserved a block)


class MiOperands(NamedTuple):
    """What K3 needs beside the beliefs; shared by every scenario."""

    cxA: torch.Tensor  # (w, K) cosine table along x, lattice sampling folded in
    cyA: torch.Tensor  # (K, h) cosine table along y, lattice sampling folded in
    fallback: torch.Tensor  # (K, K) uniform target over the lattice
    hk00: torch.Tensor  # (1,) h_k at k = (0, 0): raw[0, 0] * hk00 is the target's mass


def mi_operands(g0, domain, K: int, grid_samples) -> MiOperands:
    """Operands of K3 for maps of ``g0``'s geometry (an unbatched GridMap;
    only its shape, origin and resolution are read) on the unbatched
    ``domain``."""
    nsx, nsy = grid_samples
    Ax, Ay = target_ops.sampling_one_hots(g0, grid_samples, domain)  # (ns, w), (ns, h)
    cosx, cosy = basis.axis_cos_tables(K, grid_samples, domain)
    ck = torch.full((K,), 0.5, dtype=torch.float32, device=cosx.device)
    ck[0] = 1.0
    sx = 1.0 / torch.sqrt(domain.lengths[0] * ck)
    sy = 1.0 / torch.sqrt(domain.lengths[1] * ck)
    cxA = torch.matmul(Ax.T, cosx * sx[None, :])  # (w, K)
    cyA = torch.matmul((cosy * sy[None, :]).T, Ay)  # (K, h)
    hk = basis.hk_norm(K, domain.lengths)
    fallback = (cosx.sum(dim=0)[:, None] * cosy.sum(dim=0)[None, :]) / (float(nsx * nsy) * hk)
    return MiOperands(cxA.contiguous(), cyA.contiguous(), fallback.contiguous(),
                      hk[0, 0].reshape(1).contiguous())


def _clamped_sum(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """out[i] = sum_{k=i-r..i+r} x[clip(k, 0, n-1)] along ``dim``, the terms
    added in ascending k (``blur_count_matrix``'s semantics as shifted adds)."""
    if radius <= 0:
        return x
    n = x.shape[dim]
    i = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    for d in range(-radius, radius + 1):
        out += x.index_select(dim, torch.clamp(i + d, 0, n - 1))
    return out


def phik_from_grid_plain(data, ops: MiOperands, sensor_radius_cells: int = 0,
                         frontier_cells: int = 0, occupied_threshold: float = 0.65,
                         eps: float = 1e-6) -> torch.Tensor:
    """K3's plain PyTorch version: beliefs ``data`` (S, h, w) -> (S, K, K)."""
    r, fc = sensor_radius_cells, frontier_cells
    p = torch.where(data < 0.0, torch.full_like(data, 0.5), data)
    e = target_ops.entropy(p, eps)
    t2 = _clamped_sum(_clamped_sum(e, r, -1), r, -2)
    keep = data < occupied_threshold
    if fc > 0:
        kf = ((data >= 0.0) & keep).to(torch.int32)
        keep = keep & (_clamped_sum(_clamped_sum(kf, fc, -1), fc, -2) > 0)
    vals = torch.clamp(torch.where(keep, t2, torch.zeros_like(t2)), min=0.0)
    w1 = torch.matmul(vals, ops.cxA)  # (S, h, K1)
    raw = torch.matmul(ops.cyA, w1).transpose(-1, -2)  # (S, K1, K2)
    total = (raw[:, 0, 0] * ops.hk00)[:, None, None]
    return torch.where(total > 1e-12, raw / torch.clamp(total, min=1e-12), ops.fallback)


class _Params(ctypes.Structure):
    """Mirror of ``struct K3Params`` in csrc/mi_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "h", "w", "K", "r", "fc", "bh", "n_bands")] + [
        (n, ctypes.c_float) for n in ("thr", "eps")]


_BUFFERS = ("data", "cxA", "cyA", "fallback", "hk00", "out", "part")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct K3Buffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


def smem_bytes(rows: int, w: int, K: int, band_rows: int = None) -> int:
    """Dynamic shared memory of a block that holds ``rows`` rows of a w-wide
    map and contracts ``band_rows`` of them (all of them when None: the whole
    map); ``k3_smem_bytes`` in the source: two float planes, the two tables,
    two byte planes."""
    bh = rows if band_rows is None else band_rows
    return 4 * (2 * rows * w + w * K + K * bh) + 2 * rows * w


@lru_cache(maxsize=None)
def band_plan(h: int, w: int, K: int, r: int, fc: int,
              max_smem: int = MAX_SMEM) -> Tuple[int, int]:
    """(band height, number of bands) of K3's launch for an (h, w) map:
    ``(h, 0)`` when the whole map fits one block (the single launch), else
    row bands of equal height (the last may be shorter) that cover [0, h)
    once. A band's block holds its rows and a halo of max(r, fc) rows on each
    side. Bands are sized so that two blocks share an SM unless the halo
    would then be over half of a band; raises ``ValueError`` when not even
    one row with its halo fits ``max_smem``."""
    if smem_bytes(h, w, K) <= max_smem:
        return h, 0
    m = max(r, fc)
    for limit in (min(PAIR_SMEM, max_smem), max_smem):
        # bytes of a band: 10 w (bh + 2 m) + 4 w K + 4 K bh  <=  limit
        bh = min(h, (limit - 20 * m * w - 4 * w * K) // (10 * w + 4 * K))
        if bh >= max(1, 4 * m) or (limit == max_smem and bh >= 1):
            n_bands = -(-h // bh)
            return -(-h // n_bands), n_bands
    raise ValueError(
        f"K3 keeps a row band of the ({h}, {w}) map with a halo of max(r, fc) = {m} rows on "
        f"each side in a block's shared memory: one row needs "
        f"{smem_bytes(min(h, 1 + 2 * m), w, K, 1)} bytes, over the {max_smem}-byte limit of a "
        f"block on this architecture")


class PhikFromGrid:
    """The K3 wrapper: builds ``csrc/mi_kernel.cu`` on first use and counts
    its launches per variant (``launches[variant]`` grows by one per launch
    of that variant, nowhere else; the row-band form counts under the
    variant's name with ``_banded`` appended)."""

    VARIANTS = ("phik_from_grid_fc", "phik_from_grid_nofc", "phik_from_grid_fc_banded",
                "phik_from_grid_nofc_banded")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.launches = {}
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("mi_kernel", LIBRARIES["mi_kernel"])
            fn = built.lib.k3_phik_from_grid
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def __call__(self, data, ops: MiOperands, sensor_radius_cells: int = 0,
                 frontier_cells: int = 0, occupied_threshold: float = 0.65,
                 eps: float = 1e-6) -> torch.Tensor:
        dev = data.device
        if data.dim() != 3:
            raise ValueError(f"K3 takes beliefs (S, h, w), got {tuple(data.shape)}")
        S, h, w = data.shape
        K = ops.cxA.shape[-1]
        r, fc = int(sensor_radius_cells), int(frontier_cells)
        if not 1 <= K <= min(h, w) or r < 0 or not 0 <= fc <= 127:
            raise ValueError(f"K3 supports 1 <= K <= min(h, w), r >= 0 and 0 <= fc <= 127, got "
                             f"K={K}, (h, w)=({h}, {w}), r={r}, fc={fc}")
        bh, n_bands = band_plan(h, w, K, r, fc)
        tensors = dict(data=data, cxA=ops.cxA, cyA=ops.cyA, fallback=ops.fallback,
                       hk00=ops.hk00)
        _check_operands("K3", tensors, dict(data=(S, h, w), cxA=(w, K), cyA=(K, h),
                                            fallback=(K, K), hk00=(1,)), dev)
        _require_cuda(dev, "K3 kernel")
        tensors["out"] = out = torch.empty((S, K, K), dtype=torch.float32, device=dev)
        tensors["part"] = torch.empty((S, n_bands, K, K), dtype=torch.float32, device=dev)
        params = _Params(S=S, h=h, w=w, K=K, r=r, fc=fc, bh=bh, n_bands=n_bands,
                         thr=occupied_threshold, eps=eps)
        bufs = _Buffers(**{n: t.data_ptr() for n, t in tensors.items()})
        err = self.build().lib.k3_phik_from_grid(ctypes.byref(params), ctypes.byref(bufs),
                                                 _stream_of(dev))
        variant = ("phik_from_grid_fc" if fc > 0 else "phik_from_grid_nofc") + (
            "_banded" if n_bands else "")
        if err != 0:
            raise RuntimeError(f"K3 {variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return out


K3 = PhikFromGrid()


def phik_from_grid(data, ops: MiOperands, sensor_radius_cells: int = 0,
                   frontier_cells: int = 0, occupied_threshold: float = 0.65,
                   eps: float = 1e-6) -> torch.Tensor:
    """K3: (S, K, K) normalized MI target coefficients from the float32
    beliefs ``data`` (S, h, w) and :func:`mi_operands`. The plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (raises for anything else)."""
    if _on_cpu(data, "K3"):
        return phik_from_grid_plain(data, ops, sensor_radius_cells, frontier_cells,
                                    occupied_threshold, eps)
    return K3(data, ops, sensor_radius_cells, frontier_cells, occupied_threshold, eps)
