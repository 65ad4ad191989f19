"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (256k vocab stresses embedding sharding).
[arXiv:2407.14679; hf]

A copy of ``repro/configs/minitron_8b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=1e6,
    act="swiglu",
)

REDUCED = ModelConfig(
    name="minitron-8b-reduced",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    act="swiglu",
)
