"""Scale-out over ``torch.distributed`` (port of
``ergodic_exploration_tpu/parallel/__init__.py``).

One process per device, as ``torchrun`` launches it. The engine's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named as the JAX
mesh axes are:

- ``scenario``: independent (map, pose) solves. Each rank holds the rows
  ``[lo, hi)`` of its scenario coordinate (:func:`process_scenario_slice`);
  a tick needs no communication between ranks.
- ``sample``: the 10k-sample target reduction split within a solve. The
  ranks of one ``sample`` group hold the same scenarios and each evaluates a
  contiguous block of the lattice; two ``all_reduce`` combine the blocks
  (``Engine.phik_from_gmm_sample_sharded``).

There is deliberately no pipeline, tensor or expert parallelism: the
workload has no deep network to split.

    initialize_multihost()                 # under torchrun: NCCL, one card a rank
    engine = Engine(cfg, mesh=global_scenario_mesh())
    sc = engine.init_scenarios(x0)         # the global batch in, this rank's rows out
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ergodic_exploration_tpu_torch.engine import Engine, make_mesh, make_scenario_mesh
from ergodic_exploration_tpu_torch.utils.device import resolve_device

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "make_scenario_mesh",
    "global_scenario_mesh",
    "process_scenario_slice",
    "process_allgather",
]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         backend: Optional[str] = None) -> None:
    """Join this process to the process group (``init_process_group``).

    ``coordinator_address``: ``"host:port"`` of rank 0 (``tcp://``), or a
    whole ``init_method`` URL such as ``"file:///path/store"``; None reads
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` from the
    environment (``env://``, what ``torchrun`` sets). ``num_processes`` and
    ``process_id`` are the world size and this rank (None: from the
    environment). ``device``: None (the default) is the card, and raises
    when there is none; ``"cpu"`` asks for the CPU. ``backend``: None is
    NCCL on the card and gloo on the CPU; ``"gloo"`` on the card lets
    several ranks share one card, which NCCL refuses.

    On the card the rank's device (the index in ``device``, else
    ``LOCAL_RANK``, else ``process_id`` modulo the cards of the host) is made
    current before anything touches CUDA.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            index = dev.index
        elif "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        else:
            index = (process_id or 0) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


def global_scenario_mesh():
    """1-D scenario mesh over every rank of the process group."""
    return make_scenario_mesh()


def process_scenario_slice(n_scenarios: int, mesh=None):
    """(start, stop) of the scenario rows the calling rank holds: the slice
    of its coordinate on ``mesh``'s ``scenario`` dim (None: the 1-D mesh
    over every rank, where the coordinate is the rank). Without a process
    group the one process holds them all, (0, n)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, n_scenarios
    if mesh is None:
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        d = mesh.mesh_dim_names.index(Engine.SCENARIO_AXIS)
        p, n = mesh.get_coordinate()[d], mesh.size(d)
    if n_scenarios % n:
        raise ValueError(f"scenario count {n_scenarios} not divisible by {n} hosts")
    per = n_scenarios // n
    return p * per, (p + 1) * per


def map_tree(fn, tree):
    """``fn`` applied to every tensor or array leaf of a tree of NamedTuples,
    tuples and lists; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def process_allgather(tree, mesh):
    """Every rank's leaves concatenated along axis 0 over ``mesh``'s
    ``scenario`` group, in coordinate order: the global batch on every member
    (``multihost_utils.process_allgather(tiled=True)`` in the JAX package).
    Collective: every rank of the group calls it. Boolean leaves travel as
    uint8."""
    group = mesh.get_group(Engine.SCENARIO_AXIS)
    n = dist.get_world_size(group)

    def one(t):
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        return torch.cat(parts).to(t.dtype)

    return map_tree(one, tree)
