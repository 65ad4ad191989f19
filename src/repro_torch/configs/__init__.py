"""Architecture registry of the port. ``get_config(name)`` returns the
full-size config, ``get_reduced_config(name)`` the shrunken one the CPU
tests use. Only smollm-360m is ported so far; the JAX package's other
architectures join as their model families are ported."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ParallelConfig,  # noqa: F401
                                      ServeConfig, TrainConfig)

ALL_ARCHS = ("smollm-360m",)

_MODULES = {
    "smollm-360m": "smollm_360m",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _module(name).REDUCED
