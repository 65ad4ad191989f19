"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768(/expert)
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

A copy of ``repro/configs/qwen3_moe_30b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,            # qwen3 uses head_dim 128 (> d_model/n_heads)
    moe=MoEConfig(n_experts=128, top_k=8, capacity_factor=1.25,
                  every_n_layers=1),
    rope_theta=1e6,
    act="swiglu",
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-reduced",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=32,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  every_n_layers=1),
    rope_theta=1e4,
    act="swiglu",
)
