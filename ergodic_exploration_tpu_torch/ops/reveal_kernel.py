"""R, the ray-cast reveal kernel of the mapping loop.

Counterpart of the XLA program that the JAX package compiles for
``ergodic_exploration_tpu/ops/sensor.py::reveal_raycast`` (no Pallas kernel
there): the occlusion-aware reveal of every scenario's belief from its
hidden truth around its pose, in one launch for the whole batch. The CUDA
source is ``csrc/reveal_kernel.cu`` (its header says what bounds it on an
H100 and what the design does about that). Its plain version is
:func:`ergodic_exploration_tpu_torch.ops.sensor.reveal_raycast_plain`, with
the same inputs and outputs; the CPU tests run it, ``chip_smoke.py`` holds
the kernel against it on the card cell for cell.

Beside it, in the same source, the coverage of the mapping loops
(:meth:`RevealRaycast.coverage`): the share of the beliefs' cells that are
not UNKNOWN, counted in integers, one launch (the twin of the mean of
``ergodic_exploration_tpu/ops/sensor.py::fraction_known``); its plain version
is :func:`ergodic_exploration_tpu_torch.ops.sensor.fraction_known_plain`, the
same bits.

Dispatch: :func:`ergodic_exploration_tpu_torch.ops.sensor.reveal_raycast`
and :func:`~ergodic_exploration_tpu_torch.ops.sensor.fraction_known` take
the plain versions only for tensors that lie on the CPU. For CUDA tensors
they launch the kernel or raise; there is no fallback. ``R.launches`` counts
the launches of each variant: ``reveal_raycast`` (the bin table and the
window's cell words in shared memory), ``reveal_raycast_global`` (past
``smem_limit`` bytes of them, in a global workspace) and ``coverage``.
"""

from __future__ import annotations

import ctypes

import torch

from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    MAX_SMEM, _check_operands, _require_cuda, launch_on)


class _Params(ctypes.Structure):
    """Mirror of ``struct RevealParams`` in csrc/reveal_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "h", "w", "P", "n_bins", "n_r", "pose_stride", "table_global")] + [
        ("sensor_range", ctypes.c_float), ("thr", ctypes.c_float)]


_BUFFERS = ("belief", "truth", "origin", "res", "pose", "centers", "tables", "out")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct RevealBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


class _CoverParams(ctypes.Structure):
    """Mirror of ``struct CoverParams`` in csrc/reveal_kernel.cu."""

    _fields_ = [("n", ctypes.c_longlong)]


class _CoverBuffers(ctypes.Structure):
    """Mirror of ``struct CoverBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("data", "work", "out")]


class RevealRaycast:
    """The R wrapper: builds ``csrc/reveal_kernel.cu`` on first use and
    counts its launches per variant (``launches[variant]`` grows by one per
    launch of that variant, nowhere else)."""

    VARIANTS = ("reveal_raycast", "reveal_raycast_global", "coverage")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.smem_limit = MAX_SMEM  # bytes of tables a block keeps in shared memory
        self.launches = {}
        self._work = {}  # device -> the coverage's running count and ticket (zero between launches)
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("reveal_kernel", LIBRARIES["reveal_kernel"])
            fn = built.lib.reveal_raycast
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = built.lib.reveal_coverage
            fn.argtypes = [ctypes.POINTER(_CoverParams), ctypes.POINTER(_CoverBuffers),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def smem_bytes(self, P: int, n_bins: int, table_global: bool) -> int:
        """Bytes of shared memory a block takes (the source's
        ``reveal_smem_bytes``): the warps' blocker lists, and the bin table
        and cell words unless ``table_global``."""
        fn = self.build().lib.reveal_smem_bytes
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
        return fn(P, n_bins, int(table_global))

    def __call__(self, belief, truth, origin, res, pose, centers, sensor_range: float,
                 P: int, n_bins: int, occupied_threshold: float) -> torch.Tensor:
        """The revealed beliefs (S, h, w) from beliefs and truths (S, h, w),
        origins (S, 2), resolutions (S,), poses (S, >= 2) and the bin centres
        (n_bins,); the inputs are not changed."""
        dev = belief.device
        _require_cuda(dev, "reveal kernel")
        if belief.dim() != 3 or pose.dim() != 2 or pose.shape[1] < 2:
            raise ValueError(f"the reveal kernel takes beliefs (S, h, w) and poses (S, >= 2), "
                             f"got {tuple(belief.shape)} and {tuple(pose.shape)}")
        S, h, w = belief.shape
        if not (1 <= P <= min(h, w) and 1 <= n_bins <= 65536 and P // 2 + 2 <= 32768):
            raise ValueError(f"the reveal kernel needs 1 <= P <= min(h, w), P <= 65533 and "
                             f"1 <= n_bins <= 65536, got P={P}, n_bins={n_bins} on ({h}, {w}) "
                             f"maps")
        ops = dict(belief=belief, truth=truth, origin=origin, res=res, pose=pose,
                   centers=centers)
        _check_operands("reveal kernel", ops, dict(
            belief=(S, h, w), truth=(S, h, w), origin=(S, 2), res=(S,),
            pose=(S, pose.shape[1]), centers=(n_bins,)), dev)
        table_global = self.smem_bytes(P, n_bins, False) > self.smem_limit
        ops["tables"] = torch.empty((S, n_bins + P * P) if table_global else (0,),
                                    dtype=torch.int32, device=dev)
        ops["out"] = out = torch.empty_like(belief)
        params = _Params(S=S, h=h, w=w, P=P, n_bins=n_bins, n_r=P // 2 + 2,
                         pose_stride=pose.shape[1], table_global=int(table_global),
                         sensor_range=sensor_range, thr=occupied_threshold)
        bufs = _Buffers(**{n: t.data_ptr() for n, t in ops.items()})
        err = launch_on(dev, self.build().lib.reveal_raycast, params, bufs)
        variant = "reveal_raycast_global" if table_global else "reveal_raycast"
        if err != 0:
            raise RuntimeError(f"{variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return out

    def coverage(self, data: torch.Tensor) -> torch.Tensor:
        """The share of the cells of ``data`` (beliefs of any shape, float32)
        that are not UNKNOWN, as a 0-dim float32 tensor on their device:
        float32(count / numel) with the count in integers and one float64
        division. The running count lives in a workspace of this wrapper's,
        made (zeroed) once per device and left zeroed by every launch."""
        dev = data.device
        _require_cuda(dev, "coverage kernel")
        if data.dtype != torch.float32 or data.numel() < 1:
            raise ValueError(f"the coverage kernel takes float32 beliefs with cells, got "
                             f"{data.dtype} {tuple(data.shape)}")
        data = data.contiguous()
        if dev not in self._work:
            self._work[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
        out = torch.empty((), dtype=torch.float32, device=dev)
        bufs = _CoverBuffers(data=data.data_ptr(), work=self._work[dev].data_ptr(),
                             out=out.data_ptr())
        err = launch_on(dev, self.build().lib.reveal_coverage, _CoverParams(n=data.numel()), bufs)
        if err != 0:
            raise RuntimeError(f"coverage launch failed: CUDA error {err}")
        self.launches["coverage"] += 1
        return out


R = RevealRaycast()
