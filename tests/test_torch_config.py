"""The port's configuration equals the JAX package's, field by field."""

import dataclasses
from pathlib import Path

import pytest

from ergodic_exploration_tpu import config as jconfig
from ergodic_exploration_tpu_torch import config as tconfig

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"


def _fields(cfg):
    """Nested field dict (dataclasses of the two packages are distinct types)."""
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v := getattr(cfg, f.name)) else v)
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_default_config_matches_jax(model):
    assert _fields(tconfig.default_config(model)) == _fields(jconfig.default_config(model))
    assert tconfig.default_config(model).nu == jconfig.default_config(model).nu


@pytest.mark.parametrize("name", ["cart.yaml", "omni.yaml"])
def test_yaml_loader_matches_jax(name):
    path = CONFIG_DIR / name
    assert _fields(tconfig.load_yaml_config(path)) == _fields(jconfig.load_yaml_config(path))
