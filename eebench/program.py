"""What the harness runs in a cell: the program (the port's ``Engine``), or
the plain reference in its place (the control, or the check's own runs).

The port is imported here and nowhere else in the harness, and only when a
run asks for it, so the reference and the tests on the CPU can run without
it. The program's outputs are handed to the reference through
:func:`to_ref`, which rebuilds them as the reference's own tuples.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = ROOT / "build" / "kernels"  # the port's compile cache, inside the checkout


class Program(NamedTuple):
    name: str  # "port", "reference" or "control"
    make_engine: Callable[[Any, Any], Any]  # (config dict, device) -> engine
    GridMap: type
    Domain: type
    GaussianMixture: type


def make_config(config_mod, d: dict):
    """``config_mod.EngineConfig`` from a configuration file's ``engine``
    object (nested ``cart``, ``omni`` and ``dwa`` objects, lists for
    tuples); the port and the reference have the same dataclasses."""
    nested = {"cart": config_mod.CartParams, "omni": config_mod.OmniParams,
              "dwa": config_mod.DwaConfig}
    kw = {}
    for f in dataclasses.fields(config_mod.EngineConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in nested:
            v = nested[f.name](**{k: tuple(x) if isinstance(x, list) else x
                                  for k, x in v.items()})
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    unknown = set(d) - set(kw)
    if unknown:
        raise ValueError(f"unknown engine keys {sorted(unknown)}")
    return config_mod.EngineConfig(**kw).validate()


def port() -> Program:
    """The program: ``ergodic_exploration_tpu_torch.engine.Engine``, its
    kernel libraries built (or loaded) in the checkout's ``build/kernels``."""
    from ergodic_exploration_tpu_torch import config as config_mod
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    def make(d, device):
        if str(device).startswith("cuda"):
            from ergodic_exploration_tpu_torch.utils import cuda_build

            cuda_build.set_build_dir(BUILD_DIR)
            cuda_build.build_all()
        return Engine(make_config(config_mod, d), device=device)

    return Program("port", make, GridMap, Domain, GaussianMixture)


def reference(tf32: bool = False) -> Program:
    """The plain reference (``tf32``: the control) in the program's place."""
    from eebench.reference import config as config_mod
    from eebench.reference.engine import RefEngine
    from eebench.reference.grid import Domain, GridMap
    from eebench.reference.ops.target import GaussianMixture

    def make(d, device):
        return RefEngine(make_config(config_mod, d), device, tf32=tf32)

    return Program("control" if tf32 else "reference", make, GridMap, Domain, GaussianMixture)


def _ref_types() -> dict:
    from eebench.reference import controller, engine, grid
    from eebench.reference.ops import buffer, distance, target

    return {"Scenarios": engine.Scenarios, "ExploreOutput": engine.ExploreOutput,
            "ControllerState": controller.ControllerState,
            "StepDiagnostics": controller.StepDiagnostics, "World": controller.World,
            "RingBuffer": buffer.RingBuffer, "GridMap": grid.GridMap, "Domain": grid.Domain,
            "DistanceField": distance.DistanceField, "GaussianMixture": target.GaussianMixture}


def to_ref(tree):
    """``tree`` (tuples of tensors made by either side) as the reference's
    own NamedTuples, field for field; tensors are shared, not copied."""
    types = _ref_types()

    def one(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return types[type(t).__name__](*(one(f) for f in t))
        if isinstance(t, (tuple, list)):
            return type(t)(one(f) for f in t)
        return t

    return one(tree)
