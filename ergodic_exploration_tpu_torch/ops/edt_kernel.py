"""E, the distance-field kernel of the world rebuild.

Counterpart of the XLA program that the JAX package compiles for
``ergodic_exploration_tpu/ops/distance.py`` (``edt`` and the gradient of
``DistanceField.from_grid``; no Pallas kernel there): for every map, the
exact Euclidean distance transform of its occupied cells and the
central-difference gradient, in one launch for the batch. The CUDA source is
``csrc/edt_kernel.cu`` (its header says what bounds it on an H100 and what
the design does about that). Its plain version is :func:`edt_field_plain`
(``ops/distance.py``'s ``edt`` then ``central_gradient``); the CPU tests run
it, ``chip_smoke.py`` holds the kernel against it on the card bit for bit.

Dispatch: ``DistanceField.from_grid`` takes the plain version only for
tensors that lie on the CPU. For CUDA tensors it launches the kernel or
raises; there is no fallback. ``E.launches`` counts the launches of each
variant: ``edt`` (a map's working plane in shared memory) and
``edt_global`` (maps over ``smem_limit`` bytes, the plane in the output).
"""

from __future__ import annotations

import ctypes

import torch

from ergodic_exploration_tpu_torch.ops.distance import FAR, central_gradient, edt
from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    MAX_SMEM, _check_operands, _require_cuda, launch_on)


def edt_field_plain(data: torch.Tensor, resolution: torch.Tensor, occupied_threshold: float):
    """E's plain version: (dist (..., h, w), grad (..., h, w, 2)) of the
    occupancy ``data`` (..., h, w) with ``resolution`` (...) or scalar."""
    d = edt(data >= occupied_threshold, resolution)
    gx, gy = central_gradient(d, resolution)
    return d, torch.stack([gx, gy], dim=-1)


class _Params(ctypes.Structure):
    """Mirror of ``struct EdtParams`` in csrc/edt_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "h", "w", "plane_global")] + [
        (n, ctypes.c_float) for n in ("thr", "big", "far")]


_BUFFERS = ("data", "res", "dist", "grad")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct EdtBuffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


class EdtField:
    """The E wrapper: builds ``csrc/edt_kernel.cu`` on first use and counts
    its launches per variant (``launches[variant]`` grows by one per launch
    of that variant, nowhere else)."""

    VARIANTS = ("edt", "edt_global")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.smem_limit = MAX_SMEM  # bytes of plane a block keeps in shared memory
        self.launches = {}
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("edt_kernel", LIBRARIES["edt_kernel"])
            fn = built.lib.edt_field
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def __call__(self, data, res, occupied_threshold: float):
        """(dist (S, h, w), grad (S, h, w, 2)) of the maps ``data`` (S, h, w)
        with resolutions ``res`` (S,)."""
        dev = data.device
        _require_cuda(dev, "EDT kernel")
        if data.dim() != 3 or min(data.shape[1:]) < 2:
            raise ValueError(f"the EDT kernel takes maps (S, h, w) with h, w >= 2 (the "
                             f"gradient's one-sided borders), got {tuple(data.shape)}")
        S, h, w = data.shape
        _check_operands("EDT kernel", dict(data=data, res=res), dict(data=(S, h, w), res=(S,)),
                        dev)
        plane_global = 4 * h * w > self.smem_limit
        dist = torch.empty_like(data)
        grad = torch.empty((S, h, w, 2), dtype=torch.float32, device=dev)
        params = _Params(S=S, h=h, w=w, plane_global=int(plane_global), thr=occupied_threshold,
                         big=float(max(h, w) ** 2 * 4), far=FAR)
        bufs = _Buffers(data=data.data_ptr(), res=res.data_ptr(), dist=dist.data_ptr(),
                        grad=grad.data_ptr())
        err = launch_on(dev, self.build().lib.edt_field, params, bufs)
        variant = "edt_global" if plane_global else "edt"
        if err != 0:
            raise RuntimeError(f"{variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return dist, grad


E = EdtField()
