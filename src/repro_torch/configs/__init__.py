"""Architecture registry of the port. ``get_config(name)`` returns the
full-size config, ``get_reduced_config(name)`` the shrunken one the CPU
tests use. Ported so far: the dense smollm-360m and minitron-8b, the
mixture-of-experts qwen3-moe-30b-a3b and arctic-480b, the attention-free
RWKV-6 rwkv6-1.6b, the Mamba + attention hybrid jamba-v0.1-52b, and the
paper's own CLIP ViT-H/14; the JAX package's other architectures join as
their model families are ported."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CLIPConfig, MambaConfig, ModelConfig,  # noqa: F401
                                      MoEConfig, ParallelConfig, RWKVConfig, ServeConfig,
                                      TrainConfig)

PAPER_ARCH = "clip-vit-huge"
ALL_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-1.6b", "smollm-360m", "minitron-8b",
             "jamba-v0.1-52b", PAPER_ARCH)

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "arctic-480b": "arctic_480b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "smollm-360m": "smollm_360m",
    "minitron-8b": "minitron_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
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
