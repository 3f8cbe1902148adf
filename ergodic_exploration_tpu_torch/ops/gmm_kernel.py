"""K2, the batched GMM target-coefficient kernel.

Counterpart of ``ergodic_exploration_tpu/ops/pallas_kernels.py``
(``phik_from_gmm_pallas`` with its unmasked and masked Pallas bodies): for
every scenario, evaluate its Gaussian mixture on the shared sample lattice,
multiply by an optional per-scenario (S, N) free mask BEFORE the normalizer,
contract with the dense basis table D (N, K^2), divide by the mixture's
mass, and fall back to a uniform target where the mass underflows:

    ck = acc / max(tot, 1e-12)            acc = (phi * mask) @ D, tot = sum
    tot <= 1e-12, masked    -> (mask @ D) / max(sum(mask), 1)
    tot <= 1e-12, unmasked  -> colsum(D) / N

The CUDA source is ``csrc/gmm_kernel.cu`` (its header says what bounds it on
an H100 and what the design does about that); the device code of its
mixture-times-table reduction is ``csrc/gmm_refresh.cuh`` (K1's in-kernel
refresh takes the separable form of ``csrc/lattice_refresh.cuh`` instead,
which would serve K2's per-scenario masks too). Beside it lives the plain
PyTorch version, :func:`phik_from_gmm_plain`, with the same inputs and outputs; the CPU tests
run it, ``chip_smoke.py`` holds the kernel against it on the card.

Dispatch: :func:`phik_from_gmm` takes the plain version only for tensors
that lie on the CPU. For CUDA tensors it launches the kernel or raises;
there is no fallback. It runs for every S (the ragged last tile of
scenarios is masked in the kernel). ``K2.launches`` counts the launches of
the unmasked and the masked variant.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ergodic_exploration_tpu_torch.ops.solve_kernel import (
    LATTICE_CHUNK, _check_operands, _on_cpu, _require_cuda, _sm_count, lattice_split, launch_on,
    pad_lattice, slab_blocks)
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture, gmm_eval


def phik_from_gmm_plain(means, covs, weights, pts, D, free_mask=None) -> torch.Tensor:
    """K2's plain PyTorch version: means (S, J, 2), covs (S, J, 2, 2),
    weights (S, J), pts (N, 2), D (N, K^2), free_mask (S, N) or None ->
    (S, K^2)."""
    phi = gmm_eval(pts, GaussianMixture(means, covs, weights))  # (S, N)
    if free_mask is not None:
        m = free_mask.to(phi.dtype)
        phi = phi * m
        fallback = torch.matmul(m, D) / torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    else:
        fallback = (D.sum(dim=0) / float(D.shape[0]))[None, :]
    tot = phi.sum(dim=-1, keepdim=True)
    ck = torch.matmul(phi, D) / torch.clamp(tot, min=1e-12)
    return torch.where(tot > 1e-12, ck, fallback)


class _Params(ctypes.Structure):
    """Mirror of ``struct K2Params`` in csrc/gmm_kernel.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "J", "KK", "Npad", "n_real", "nsplit", "chunks_per_split", "masked")]


_BUFFERS = ("means", "covs", "weights", "pts", "D", "mask", "part_acc", "part_tot", "out")


class _Buffers(ctypes.Structure):
    """Mirror of ``struct K2Buffers``: device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in _BUFFERS]


class PhikFromGmm:
    """The K2 wrapper: builds ``csrc/gmm_kernel.cu`` on first use and counts
    its launches per variant (``launches[variant]`` grows by one per launch
    of that variant, nowhere else)."""

    VARIANTS = ("phik_from_gmm", "phik_from_gmm_masked")

    def __init__(self):
        self.built = None  # utils.cuda_build.Built once compiled
        self.launches = {}
        self.reset_launches()

    def reset_launches(self) -> None:
        self.launches = {v: 0 for v in self.VARIANTS}

    def build(self):
        if self.built is None:
            from ergodic_exploration_tpu_torch.utils.cuda_build import LIBRARIES, build

            built = build("gmm_kernel", LIBRARIES["gmm_kernel"])
            fn = built.lib.k2_phik_from_gmm
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def __call__(self, means, covs, weights, pts, D, free_mask=None) -> torch.Tensor:
        dev = means.device
        _require_cuda(dev, "K2 kernel")
        S, J = weights.shape
        N, KK = D.shape
        if J < 1:
            raise ValueError(f"K2 needs a mixture of J >= 1 components, got J={J}")
        shapes = dict(means=(S, J, 2), covs=(S, J, 2, 2), weights=(S, J), pts=(N, 2),
                      D=(N, KK))
        ops = dict(means=means, covs=covs, weights=weights, pts=pts, D=D)
        if free_mask is not None:
            shapes["mask"], ops["mask"] = (S, N), free_mask
        _check_operands("K2", ops, shapes, dev)
        # the mask is not padded: the kernel treats points >= N as masked out
        ops["pts"], ops["D"] = pad_lattice(pts, D)
        Npad = ops["pts"].shape[0]
        nsplit, per = lattice_split(S, Npad // LATTICE_CHUNK, _sm_count(dev), slab_blocks(KK))
        out = torch.empty((S, KK), dtype=torch.float32, device=dev)
        ops.update(part_acc=torch.empty((nsplit, S, KK), dtype=torch.float32, device=dev),
                   part_tot=torch.empty((nsplit, S), dtype=torch.float32, device=dev), out=out)
        params = _Params(S=S, J=J, KK=KK, Npad=Npad, n_real=N, nsplit=nsplit,
                         chunks_per_split=per, masked=int(free_mask is not None))
        bufs = _Buffers(**{n: t.data_ptr() for n, t in ops.items()})
        err = launch_on(dev, self.build().lib.k2_phik_from_gmm, params, bufs)
        variant = "phik_from_gmm_masked" if free_mask is not None else "phik_from_gmm"
        if err != 0:
            raise RuntimeError(f"K2 {variant} launch failed: CUDA error {err}")
        self.launches[variant] += 1
        return out


K2 = PhikFromGmm()


def phik_from_gmm(means, covs, weights, pts, D,
                  free_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: (S, K^2) normalized GMM target coefficients over the unpadded
    lattice ``pts`` (N, 2) and table ``D`` (N, K^2), with an optional (S, N)
    float32 free mask. The plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (raises for anything else)."""
    if _on_cpu(means, "K2"):
        return phik_from_gmm_plain(means, covs, weights, pts, D, free_mask)
    return K2(means, covs, weights, pts, D, free_mask)
