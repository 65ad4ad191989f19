"""Architecture registry of the port. ``get_config(name)`` returns the
full-size config, ``get_reduced_config(name)`` the shrunken one the CPU
tests use. Ported so far: the dense smollm-360m and minitron-8b, the
mixture-of-experts qwen3-moe-30b-a3b and arctic-480b, the attention-free
RWKV-6 rwkv6-1.6b, the Mamba + attention hybrid jamba-v0.1-52b, the
vision-language internvl2-76b (a stub frontend before a dense decoder),
the encoder-decoder seamless-m4t-large-v2, and the paper's own CLIP
ViT-H/14. The JAX package's granite-20b and starcoder2-3b are not here
yet: their query groups need wider forms of the decode kernels
(ROADMAP.md Queue 1 #9)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CLIPConfig, EncDecConfig, MambaConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, ParallelConfig, RWKVConfig,
                                      ServeConfig, TrainConfig)

PAPER_ARCH = "clip-vit-huge"
ALL_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-1.6b", "smollm-360m", "minitron-8b",
             "jamba-v0.1-52b", "internvl2-76b", "seamless-m4t-large-v2", PAPER_ARCH)

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "arctic-480b": "arctic_480b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "smollm-360m": "smollm_360m",
    "minitron-8b": "minitron_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "clip-vit-huge": "clip_vit_huge",
}


# the JAX package's archs still to port, and why
_NOT_YET = dict.fromkeys(
    ("granite-20b", "starcoder2-3b"),
    "its query group (48, 12) needs wider forms of decode_fwd and the paged kernels than "
    "their 8 and 16, ROADMAP.md Queue 1 #9")


def _module(name: str):
    if name not in _MODULES:
        why = f" ({_NOT_YET[name]})" if name in _NOT_YET else ""
        raise KeyError(f"unknown or not yet ported arch {name!r}{why}; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced_config(name: str):
    return _module(name).REDUCED
