"""Architecture registry of the port. ``get_config(name)`` returns the
full-size config, ``get_reduced_config(name)`` the shrunken one the CPU
tests use. Ported so far: smollm-360m and the paper's own CLIP ViT-H/14;
the JAX package's other architectures join as their model families are
ported."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CLIPConfig, ModelConfig,  # noqa: F401
                                      ParallelConfig, ServeConfig, TrainConfig)

PAPER_ARCH = "clip-vit-huge"
ALL_ARCHS = ("smollm-360m", PAPER_ARCH)

_MODULES = {
    "smollm-360m": "smollm_360m",
    "clip-vit-huge": "clip_vit_huge",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced_config(name: str):
    return _module(name).REDUCED
