"""Architecture registry of the port. ``get_config(name)`` returns the
full-size config, ``get_reduced_config(name)`` the shrunken one the CPU
tests use. Ported so far: the dense smollm-360m and minitron-8b, the
mixture-of-experts qwen3-moe-30b-a3b and arctic-480b, the attention-free
RWKV-6 rwkv6-1.6b, the Mamba + attention hybrid jamba-v0.1-52b, the
vision-language internvl2-76b (a stub frontend before a dense decoder),
the encoder-decoder seamless-m4t-large-v2, the code models granite-20b
(MQA: 48 query heads over one KV head) and starcoder2-3b (24 over 2), and
the paper's own CLIP ViT-H/14: every architecture of the JAX package."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CLIPConfig, EncDecConfig, MambaConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, ParallelConfig, RWKVConfig,
                                      ServeConfig, TrainConfig)

PAPER_ARCH = "clip-vit-huge"
ALL_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-1.6b", "internvl2-76b", "smollm-360m",
             "starcoder2-3b", "granite-20b", "minitron-8b", "seamless-m4t-large-v2",
             "jamba-v0.1-52b", PAPER_ARCH)

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "arctic-480b": "arctic_480b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "smollm-360m": "smollm_360m",
    "minitron-8b": "minitron_8b",
    "starcoder2-3b": "starcoder2_3b",
    "granite-20b": "granite_20b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "clip-vit-huge": "clip_vit_huge",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced_config(name: str):
    return _module(name).REDUCED
