"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA + RoPE. [arXiv:2402.19173; hf]

A copy of ``repro/configs/starcoder2_3b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=1e5,
    act="gelu",              # starcoder2 uses gelu MLP
    norm="layernorm",
)

REDUCED = ModelConfig(
    name="starcoder2-3b-reduced",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    rope_theta=1e4,
    act="gelu",
    norm="layernorm",
)
