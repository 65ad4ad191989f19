"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16 experts top-2 — Mamba+attention 1:7 interleave (1 attn layer per 8,
offset 4), MoE every 2 layers. [arXiv:2403.19887; hf]

A copy of ``repro/configs/jamba_v0_1_52b.py``."""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25,
                  every_n_layers=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_layer_period=8,
    attn_layer_offset=4,
    rope_theta=1e6,
    act="swiglu",
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced",
    family="hybrid",
    n_layers=8,              # one full period
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25,
                  every_n_layers=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    attn_layer_period=8,
    attn_layer_offset=4,
    rope_theta=1e4,
    act="swiglu",
)
