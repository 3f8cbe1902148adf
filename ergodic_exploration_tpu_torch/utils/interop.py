"""Carry state between the JAX package and the port, through numpy.

The JAX package's pytrees (``Scenarios``, ``World``, ``GaussianMixture``,
``GridMap``)
converted leaf by leaf to numpy arrays (``jax.tree.map(np.asarray, tree)``)
have the same field names as the port's NamedTuples, so these functions
read them by attribute and need no JAX import. JAX keys are uint32 words;
the port holds them as int64 (see utils/prng.py). Tensors are made on
the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ergodic_exploration_tpu_torch.controller import ControllerState, World
from ergodic_exploration_tpu_torch.grid import Domain, GridMap
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.ops.distance import DistanceField
from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
from ergodic_exploration_tpu_torch.utils.device import resolve_device


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def scenarios_from_numpy(sc, device=None):
    """JAX ``Scenarios`` (numpy leaves) -> the port's ``Scenarios``."""
    from ergodic_exploration_tpu_torch.engine import Scenarios

    device = resolve_device(device)
    st = sc.state
    buf = st.buffer
    return Scenarios(
        state=ControllerState(
            U=_t(st.U, device, torch.float32),
            buffer=RingBuffer(_t(buf.states, device, torch.float32),
                              _t(buf.cursor, device, torch.int32),
                              _t(buf.count, device, torch.int32)),
            ck_sum=_t(st.ck_sum, device, torch.float32),
            hist_count=_t(st.hist_count, device, torch.int32),
            rng=_t(np.asarray(st.rng).astype(np.int64), device, torch.int64),
        ),
        x=_t(sc.x, device, torch.float32),
        vb=_t(sc.vb, device, torch.float32),
    )


def world_from_numpy(world, device=None) -> World:
    """JAX ``World`` (numpy leaves) -> the port's ``World``."""
    device = resolve_device(device)
    f = lambda a: _t(a, device, torch.float32)  # noqa: E731
    d = world.dist
    return World(
        domain=Domain(f(world.domain.origin), f(world.domain.lengths)),
        dist=DistanceField(f(d.dist), f(d.grad), f(d.origin), f(d.resolution)),
        free_mask=None if world.free_mask is None else f(world.free_mask),
    )


def gmm_from_numpy(gmm, device=None) -> GaussianMixture:
    """JAX ``GaussianMixture`` (numpy leaves) -> the port's."""
    device = resolve_device(device)
    return GaussianMixture(*(_t(a, device, torch.float32) for a in gmm))


def grids_from_numpy(grids, device=None) -> GridMap:
    """JAX ``GridMap`` (numpy leaves: data, origin, resolution) -> the port's."""
    device = resolve_device(device)
    return GridMap(*(_t(a, device, torch.float32) for a in grids))


def to_numpy(tree):
    """The port's NamedTuples (nested) with every tensor copied to numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
