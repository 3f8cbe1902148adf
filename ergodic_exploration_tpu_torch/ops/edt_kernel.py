"""E, the world-rebuild kernel: the distance field and the free mask.

Counterpart of the XLA program that the JAX package compiles for
``ergodic_exploration_tpu/engine.py::_world_one`` (no Pallas kernel there):
for every map, the exact Euclidean distance transform of its occupied cells
and its central-difference gradient (``ops/distance.py``'s ``edt`` and
``DistanceField.from_grid``) and, with the mask, the free-space mask at the
phi lattice (``_free_mask_one``), in one launch for the batch. The CUDA
source is ``csrc/edt_kernel.cu`` (its header says what bounds it on an H100
and what the design does about that). Its plain versions are
:func:`edt_field_plain` (``edt`` then ``central_gradient``) and
:func:`world_plain` (that and ``GridMap.occupancy_at`` of
``Domain.sample_lattice``); the CPU tests run them, ``chip_smoke.py`` holds
the kernel against them on the card bit for bit.

Dispatch: ``DistanceField.from_grid`` (the field alone) and
:func:`world_fields` (field and mask: ``Engine._world_batched``) take the
plain versions only for tensors that lie on the CPU. For CUDA tensors they
launch the kernel or raise; there is no fallback. ``E.launches`` counts the
launches of each variant: ``edt`` and ``world`` (without and with the mask;
a map's working plane in shared memory) and ``edt_global`` and
``world_global`` (maps over ``smem_limit`` bytes of plane: the many-block
form, three kernels over many blocks a map, the plane in a workspace; one
launch of the wrapper all the same).
"""

from __future__ import annotations

import ctypes

import torch

from ergodic_exploration_tpu_torch.grid import Domain, GridMap, lattice_fractions
from ergodic_exploration_tpu_torch.ops.distance import FAR, central_gradient, edt
from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    MAX_SMEM, _check_operands, _on_cpu, _require_cuda, launch_on)
from ergodic_exploration_tpu_torch.utils.device import constant


def edt_field_plain(data: torch.Tensor, resolution: torch.Tensor, occupied_threshold: float):
    """E's plain version: (dist (..., h, w), grad (..., h, w, 2)) of the
    occupancy ``data`` (..., h, w) with ``resolution`` (...) or scalar."""
    d = edt(data >= occupied_threshold, resolution)
    gx, gy = central_gradient(d, resolution)
    return d, torch.stack([gx, gy], dim=-1)


def world_plain(grids: GridMap, dom: Domain, occupied_threshold: float, grid_samples):
    """E's plain version with the mask, the JAX ``_world_one`` of every map:
    (dist (S, h, w), grad (S, h, w, 2), free (S, nsx * nsy)), free 1.0 where
    the map's value at a lattice point of ``dom`` is under the threshold."""
    d, g = edt_field_plain(grids.data, grids.resolution, occupied_threshold)
    pts = dom.sample_lattice(grid_samples)
    return d, g, (grids.occupancy_at(pts) < occupied_threshold).to(torch.float32)


def world_fields(grids: GridMap, dom: Domain, occupied_threshold: float, grid_samples):
    """:func:`world_plain` for CPU tensors, one launch of E with the mask for
    CUDA tensors (it raises on a failed build or launch). ``grids`` and
    ``dom`` lead with the scenario axis: data (S, h, w), origins and lengths
    (S, 2), resolutions (S,)."""
    if _on_cpu(grids.data, "the world rebuild"):
        return world_plain(grids, dom, occupied_threshold, grid_samples)
    dev = grids.data.device
    nsx, nsy = grid_samples
    fx = constant(("lattice_fractions", nsx), dev, lambda: lattice_fractions(nsx, dev))
    fy = constant(("lattice_fractions", nsy), dev, lambda: lattice_fractions(nsy, dev))

    def f32(t):
        return t.to(torch.float32).contiguous()

    return E.world(f32(grids.data), f32(grids.resolution), occupied_threshold,
                   f32(grids.origin), f32(dom.origin), f32(dom.lengths), fx, fy)


class _Params(ctypes.Structure):
    """Mirror of ``struct EdtParams`` in csrc/edt_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "h", "w", "many_blocks", "nsx", "nsy")] + [
        (n, ctypes.c_float) for n in ("thr", "far")]


_BUFFERS = ("data", "res", "map_origin", "dom_origin", "dom_lengths", "fx", "fy", "dist", "grad",
            "free", "work")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct EdtBuffers``: device pointers (None where unused)."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


class EdtField:
    """The E wrapper: builds ``csrc/edt_kernel.cu`` on first use and counts
    its launches per variant (``launches[variant]`` grows by one per launch
    of that variant, nowhere else)."""

    VARIANTS = ("edt", "edt_global", "world", "world_global")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        # bytes of plane and stack a block may keep in shared memory; past
        # them a map takes the many-block form
        self.smem_limit = MAX_SMEM
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

    def smem_bytes(self, h: int, w: int, nsx: int, nsy: int, plane_shared: bool) -> int:
        """Bytes of shared memory a block takes for (h, w) maps and an nsx x
        nsy mask (0 x 0 without): the one-block form's, the plane and stack
        in shared memory, where ``plane_shared``; else the many-block form's,
        none (the source's ``edt_smem_bytes``)."""
        fn = self.build().lib.edt_smem_bytes
        fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        return fn(h, w, nsx, nsy, int(plane_shared))

    def work_bytes(self, h: int, w: int) -> int:
        """Bytes of workspace an (h, w) map takes in the many-block form: its
        plane and its stacks (the source's ``edt_work_bytes``)."""
        fn = self.build().lib.edt_work_bytes
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        return fn(h, w)

    def __call__(self, data, res, occupied_threshold: float):
        """(dist (S, h, w), grad (S, h, w, 2)) of the maps ``data`` (S, h, w)
        with resolutions ``res`` (S,)."""
        return self._launch(data, res, occupied_threshold, None)

    def world(self, data, res, occupied_threshold: float, map_origin, dom_origin, dom_lengths,
              fx, fy):
        """(dist, grad, free (S, nsx * nsy)): the field of :meth:`__call__`
        and the free mask at the lattice of the domains ``dom_origin``,
        ``dom_lengths`` (S, 2) with the axis fractions ``fx`` (nsx,) and ``fy``
        (nsy,) (``grid.lattice_fractions``), sampled from the maps of origins
        ``map_origin`` (S, 2)."""
        return self._launch(data, res, occupied_threshold,
                            dict(map_origin=map_origin, dom_origin=dom_origin,
                                 dom_lengths=dom_lengths, fx=fx, fy=fy))

    def _launch(self, data, res, occupied_threshold, mask):
        dev = data.device
        _require_cuda(dev, "EDT kernel")
        if data.dim() != 3 or min(data.shape[1:]) < 2:
            raise ValueError(f"the EDT kernel takes maps (S, h, w) with h, w >= 2 (the "
                             f"gradient's one-sided borders), got {tuple(data.shape)}")
        S, h, w = data.shape
        ops, shapes = dict(data=data, res=res), dict(data=(S, h, w), res=(S,))
        nsx = nsy = 0
        if mask is not None:
            nsx, nsy = mask["fx"].shape[0], mask["fy"].shape[0]
            ops.update(mask)
            shapes.update(map_origin=(S, 2), dom_origin=(S, 2), dom_lengths=(S, 2), fx=(nsx,),
                          fy=(nsy,))
        _check_operands("EDT kernel", ops, shapes, dev)
        many_blocks = self.smem_bytes(h, w, nsx, nsy, True) > self.smem_limit
        if many_blocks:  # the many-block form: a map's plane and stacks in a workspace
            ops["work"] = torch.empty((S, self.work_bytes(h, w)), dtype=torch.uint8, device=dev)
        ops["dist"] = dist = torch.empty_like(data)
        ops["grad"] = grad = torch.empty((S, h, w, 2), dtype=torch.float32, device=dev)
        if mask is not None:
            ops["free"] = torch.empty((S, nsx * nsy), dtype=torch.float32, device=dev)
        params = _Params(S=S, h=h, w=w, many_blocks=int(many_blocks), nsx=nsx, nsy=nsy,
                         thr=occupied_threshold, far=FAR)
        bufs = _Buffers(**{n: t.data_ptr() for n, t in ops.items()})
        err = launch_on(dev, self.build().lib.edt_field, params, bufs)
        variant = ("edt" if mask is None else "world") + ("_global" if many_blocks else "")
        if err != 0:
            raise RuntimeError(f"{variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return (dist, grad) if mask is None else (dist, grad, ops["free"])


E = EdtField()
