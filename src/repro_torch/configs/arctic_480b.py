"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864(/expert)
vocab=32000, MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

A copy of ``repro/configs/arctic_480b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  every_n_layers=1, dense_residual=True,
                  dense_residual_ff=7168),   # arctic residual MLP ~ d_model
    rope_theta=1e6,
    act="swiglu",
)

REDUCED = ModelConfig(
    name="arctic-480b-reduced",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  every_n_layers=1, dense_residual=True,
                  dense_residual_ff=128),
    rope_theta=1e4,
    act="swiglu",
)
