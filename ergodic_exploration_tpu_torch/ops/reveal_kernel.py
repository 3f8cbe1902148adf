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

Dispatch: :func:`ergodic_exploration_tpu_torch.ops.sensor.reveal_raycast`
takes the plain version only for tensors that lie on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fallback.
``R.launches`` counts the launches of each variant: ``reveal_raycast`` (the
bin table and the window's cell words in shared memory) and
``reveal_raycast_global`` (past ``smem_limit`` bytes of them, in a global
workspace).
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


class RevealRaycast:
    """The R wrapper: builds ``csrc/reveal_kernel.cu`` on first use and
    counts its launches per variant (``launches[variant]`` grows by one per
    launch of that variant, nowhere else)."""

    VARIANTS = ("reveal_raycast", "reveal_raycast_global")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.smem_limit = MAX_SMEM  # bytes of tables a block keeps in shared memory
        self.launches = {}
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


R = RevealRaycast()
