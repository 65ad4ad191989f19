"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]

A copy of ``repro/configs/granite_20b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,            # MQA
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e5,
    act="gelu",
    norm="layernorm",
)

REDUCED = ModelConfig(
    name="granite-20b-reduced",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    rope_theta=1e4,
    act="gelu",
    norm="layernorm",
)
